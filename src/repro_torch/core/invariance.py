"""Invariant transformations (paper §3.2): permutation P, scaling S, rotation R.

Convention: FFN weights are stored for ``x @ W`` — ``w_up: (D, F)``,
``w_down: (F, D)``, optional ``w_gate: (D, F)`` (SwiGLU), optional biases
``b_up/b_gate: (F,)``. The paper's transform

    W̄_up = P S R W_up,   b̄_up = P S R b_up,   W̄_down = W_down Rᵀ S⁻¹ Pᵀ

acts on the hidden (F) axis: columns of up/gate, rows of down. Transforms are
stored compactly as ``(pi, s, phi)`` and always applied to the ORIGINAL
parameters, with ``(pi, s, phi)`` holding the cumulative transform.

``pi`` is int64 here (torch's index type; the reference uses int32).
Proposals draw from a ``torch.Generator``: the port does not reproduce
``jax.random``, so the search takes a pluggable proposal source
(:class:`NativeProposals` by default; tests replay the reference's draws).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

__all__ = [
    "FFNTransform",
    "identity_transform",
    "apply_rotation_rows",
    "apply_rotation_cols",
    "apply_transform_ffn",
    "invert_permutation",
    "ProposalConfig",
    "propose",
    "NativeProposals",
]


class FFNTransform(NamedTuple):
    """Cumulative per-layer transform. pi: (F,) int64; s: (F,) f32; phi: (F//2,) f32."""

    pi: torch.Tensor
    s: torch.Tensor
    phi: torch.Tensor


def identity_transform(f_dim: int, device="cpu") -> FFNTransform:
    return FFNTransform(
        pi=torch.arange(f_dim, dtype=torch.int64, device=device),
        s=torch.ones((f_dim,), dtype=torch.float32, device=device),
        phi=torch.zeros((f_dim // 2,), dtype=torch.float32, device=device),
    )


def _rotate_pairs(w: torch.Tensor, phi: torch.Tensor, axis: int,
                  inverse: bool) -> torch.Tensor:
    """Apply block-diagonal Givens rotation R (Eqn. 20) along ``axis`` of w.

    Pairs are (2i, 2i+1). ``inverse`` applies R^T.
    """
    w = torch.movedim(w, axis, 0)
    f = w.shape[0]
    wp = w.reshape((f // 2, 2) + tuple(w.shape[1:]))
    c, s = torch.cos(phi), torch.sin(phi)
    if inverse:
        s = -s
    shape = (f // 2,) + (1,) * (w.ndim - 1)
    c = c.reshape(shape)
    s = s.reshape(shape)
    a, b = wp[:, 0], wp[:, 1]
    ra = c * a - s * b
    rb = s * a + c * b
    out = torch.stack([ra, rb], dim=1).reshape(w.shape)
    return torch.movedim(out, 0, axis)


def apply_rotation_rows(w, phi, inverse: bool = False):
    """R @ w for w whose FIRST axis is the rotated (F) axis."""
    return _rotate_pairs(w, phi, axis=0, inverse=inverse)


def apply_rotation_cols(w, phi, inverse: bool = False):
    """w @ Rᵀ for w whose SECOND axis is the rotated (F) axis (up/gate
    column convention; the fused transform+fake-quant kernel's plain form)."""
    return _rotate_pairs(w, phi, axis=1, inverse=inverse)


def apply_transform_ffn(
    t: FFNTransform,
    w_up: torch.Tensor,
    w_down: torch.Tensor,
    b_up: Optional[torch.Tensor] = None,
    w_gate: Optional[torch.Tensor] = None,
    b_gate: Optional[torch.Tensor] = None,
):
    """Return (w_up', w_down', b_up', w_gate', b_gate') = PSR-transformed params.

    Shapes: w_up/w_gate (D, F); w_down (F, D); b_up/b_gate (F,).
    Order (paper Eqns. 21-22): rotate, then scale, then permute on the F axis;
    the inverse order on w_down rows.
    """
    # --- up projection columns: R, S, P
    up = apply_rotation_cols(w_up, t.phi)
    up = up * t.s[None, :]
    up = up[:, t.pi]
    # --- down projection rows: down' = P S⁻¹ R · down — FORWARD R on rows
    # ((W Rᵀ)ᵀ = R Wᵀ for the paper's (D, F) W_down)
    down = _rotate_pairs(w_down, t.phi, axis=0, inverse=False)
    down = down * (1.0 / t.s)[:, None]
    down = down[t.pi, :]
    out_b_up = None
    if b_up is not None:
        b = apply_rotation_rows(b_up, t.phi) * t.s
        out_b_up = b[t.pi]
    out_gate = None
    out_b_gate = None
    if w_gate is not None:
        # gated MLP: the SAME permutation must hit gate and up; the gate
        # branch is only permuted (S/R on 'up' alone is the invariant choice)
        out_gate = w_gate[:, t.pi]
        if b_gate is not None:
            out_b_gate = b_gate[t.pi]
    return up, down, out_b_up, out_gate, out_b_gate


def invert_permutation(pi: torch.Tensor) -> torch.Tensor:
    inv = torch.zeros_like(pi)
    inv[pi] = torch.arange(pi.shape[0], dtype=pi.dtype, device=pi.device)
    return inv


# ---------------------------------------------------------------------------
# Proposal sampling (Algorithm 1, lines 11-14)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ProposalConfig:
    """Random-walk hyper-parameters (paper §4.1)."""

    sigma_s: float = 1e-2
    sigma_r: float = 1e-5
    subset_frac: float = 0.10  # move ~10% of neurons per step (paper §3.2)
    use_permutation: bool = True
    use_scaling: bool = True
    use_rotation: bool = True


def _partial_shuffle(gen: torch.Generator, pi: torch.Tensor,
                     n_move: int) -> torch.Tensor:
    """Shuffle a random subset of ``n_move`` entries of pi among themselves:
    the first n_move slots of a random permutation of positions exchange
    their values through a second random permutation."""
    f = pi.shape[0]
    pos = torch.randperm(f, generator=gen, device=pi.device)[:n_move]
    order = torch.randperm(n_move, generator=gen, device=pi.device)
    out = pi.clone()
    out[pos] = pi[pos][order]
    return out


def _mask(gen, n: int, n_on: int, device) -> torch.Tensor:
    mask = torch.zeros((n,), dtype=torch.float32, device=device)
    mask[torch.randperm(n, generator=gen, device=device)[:n_on]] = 1.0
    return mask


def propose(gen: torch.Generator, t: FFNTransform,
            cfg: ProposalConfig) -> FFNTransform:
    """Sample a candidate transform centered on the current one (the
    reference's ``propose`` with ``gen`` in place of a ``jax.random`` key)."""
    f = t.pi.shape[0]
    dev = t.pi.device
    n_move = max(2, int(round(cfg.subset_frac * f)))
    n_rot = max(1, int(round(cfg.subset_frac * (f // 2))))

    pi = t.pi
    if cfg.use_permutation:
        pi = _partial_shuffle(gen, t.pi, n_move)

    s = t.s
    if cfg.use_scaling:
        noise = torch.randn((f,), generator=gen, device=dev) * cfg.sigma_s
        s = torch.clamp_min(t.s + noise * _mask(gen, f, n_move, dev), 1e-3)

    phi = t.phi
    if cfg.use_rotation:
        noise = torch.randn((f // 2,), generator=gen, device=dev) * cfg.sigma_r
        phi = t.phi + noise * _mask(gen, f // 2, n_rot, dev)

    return FFNTransform(pi=pi, s=s, phi=phi)


class NativeProposals:
    """The default proposal source: one ``torch.Generator`` seeded with the
    search seed, K draws of :func:`propose` per step.

    A proposal source is any callable ``(t_u, k, pcfg) -> [FFNTransform] * k``
    called once per search step with the current transform of the step's
    unit; it owns its random stream.
    """

    def __init__(self, seed: int, device):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed))

    def __call__(self, t_u: FFNTransform, k: int, pcfg: ProposalConfig):
        return [propose(self.gen, t_u, pcfg) for _ in range(k)]
