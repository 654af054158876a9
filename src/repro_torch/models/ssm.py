"""Mamba2 / SSD (state-space duality) block — the chunked scan.

The port of the reference's ``repro.models.ssm`` (Dao & Gu 2024,
arXiv:2405.21060):

    h_t = exp(A·dt_t) · h_{t-1} + dt_t · B_t ⊗ x_t
    y_t = C_t · h_t + D ⊙ x_t

computed chunk-wise: intra-chunk contributions through a quadratic
(attention-like) decay matrix, inter-chunk state through a short loop over
the chunks (a ``lax.scan`` in the reference). It is plain PyTorch, as it is
``jnp`` there: no kernel of the reference covers it. The scan (and the
decode step's state update) is an ``ssm.scan`` profiler range when
``obs.enable_profiler()`` is on.

The input projection is stored as separate weights (w_z, w_x, w_B, w_C,
w_dt), as in the reference, so the within-head permutation the search
proposes is a pure gather of w_z / w_x / conv_x columns and out_proj rows.

In a bf16 model the block rounds where the reference's does as XLA
compiles it on the CPU: every conv tap product, partial sum and the bias
add; each of ``silu``'s four steps (``layers.activation_fn("silu")``); not
the gate product before the gated RMSNorm; and in the decode step's conv
the tap products feed the f32 sum unrounded. The scan itself is f32. Its
backward rounds where the reference's compiled VJP does inside the gated
RMSNorm (``_gate_out``): the cotangent of the SSD output reaches the D skip,
the scan and ``dt_bias`` unrounded.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import activation_fn, rmsnorm

__all__ = ["init_ssm", "ssm_forward", "ssm_decode_step", "init_ssm_state"]

_silu = activation_fn("silu")   # jax.nn.silu's rounding in bf16


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    h = s.n_heads(d)
    g, n = s.n_groups, s.d_state
    return di, h, g, n


def init_ssm(lead, cfg: ModelConfig, generator: torch.Generator, dtype,
             device):
    """The reference's ``init_ssm`` shapes, scales and distributions with
    leading stack dims ``lead`` (a tuple): dt log-uniform in [1e-3, 0.1]
    and ``dt_bias`` its inverse softplus, ``A_log = log U(1, 16)``, D = 1
    (``A_log``, ``D`` and ``dt_bias`` always f32). The draws come from
    ``generator`` (on ``device``) and do not reproduce ``jax.random``."""
    d = cfg.d_model
    s = cfg.ssm
    di, h, g, n = _dims(cfg)
    w = s.conv_width

    def uniform(shape, lo, hi):
        u = torch.rand(lead + shape, generator=generator,
                       dtype=torch.float32, device=device)
        return u * (hi - lo) + lo

    def normal(shape, scale):
        return torch.randn(lead + shape, generator=generator, dtype=dtype,
                           device=device) * scale

    dt = torch.exp(uniform((h,), math.log(1e-3), math.log(0.1)))
    dt_bias = dt + torch.log(-torch.expm1(-dt))       # inverse softplus
    sd = d ** -0.5
    return {
        "w_z": normal((d, di), sd),
        "w_x": normal((d, di), sd),
        "w_B": normal((d, g * n), sd),
        "w_C": normal((d, g * n), sd),
        "w_dt": normal((d, h), sd),
        "conv_x": normal((w, di), w ** -0.5),
        "conv_B": normal((w, g * n), w ** -0.5),
        "conv_C": normal((w, g * n), w ** -0.5),
        "conv_b_x": torch.zeros(lead + (di,), dtype=dtype, device=device),
        "conv_b_B": torch.zeros(lead + (g * n,), dtype=dtype, device=device),
        "conv_b_C": torch.zeros(lead + (g * n,), dtype=dtype, device=device),
        "A_log": torch.log(uniform((h,), 1.0, 16.0)),
        "D": torch.ones(lead + (h,), dtype=torch.float32, device=device),
        "dt_bias": dt_bias.float(),
        "norm_w": torch.ones(lead + (di,), dtype=dtype, device=device),
        "out_proj": normal((di, d), di ** -0.5),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv. x: (B, L, C); w: (W, C); b: (C,). Sums the
    W taps in the reference's order, then adds the bias."""
    W = w.shape[0]
    xp = F.pad(x, (0, 0, W - 1, 0))
    L = x.shape[1]
    out = sum(xp[:, i:i + L] * w[i] for i in range(W))
    return out + b


def _ssd_chunked(xh, a, Bm, Cm, chunk: int):
    """xh: (B, L, H, P) = dt·x; a: (B, L, H) = A·dt; Bm / Cm: (B, L, G, N).

    Returns y (B, L, H, P) and the final state (B, H, P, N), f32. The
    sequence is padded to a multiple of Q = min(chunk, L); the chunk-final
    states are carried across chunks by a Python loop.
    """
    B_, L, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    Q = min(chunk, L)
    pad = (-L) % Q
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    nc = (L + pad) // Q

    def chunked(t, extra):   # (B, Lp, ...) -> (B, nc, Q, ...)
        return t.reshape((B_, nc, Q) + extra)

    xh_c = chunked(xh, (H, P)).float()
    a_c = chunked(a, (H,)).float()
    # broadcast groups to heads: (B, nc, Q, G, N) -> (B, nc, Q, H, N)
    Bh = torch.repeat_interleave(chunked(Bm, (G, N)), rep, dim=3).float()
    Ch = torch.repeat_interleave(chunked(Cm, (G, N)), rep, dim=3).float()

    cum = torch.cumsum(a_c, dim=2)                        # (B, nc, Q, H)
    # intra-chunk decay: dec[i, j] = exp(cum_i - cum_j) for i >= j, else 0
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B, nc, Q, Q, H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))
    dec = torch.where(tri[None, None, :, :, None], torch.exp(diff),
                      torch.zeros((), device=xh.device))
    # y_diag[i] = sum_{j <= i} (C_i · B_j) dec[i, j] u_j
    cb = torch.einsum("bcqhn,bckhn->bcqkh", Ch, Bh)
    y_diag = torch.einsum("bcqkh,bckhp->bcqhp", cb * dec, xh_c)

    # chunk-final states: S_c = sum_j exp(cum_last - cum_j) B_j ⊗ u_j
    dec_s = torch.exp(cum[:, :, -1:, :] - cum)            # (B, nc, Q, H)
    S_c = torch.einsum("bckhn,bckhp->bchpn", Bh, dec_s[..., None] * xh_c)
    chunk_decay = torch.exp(cum[:, :, -1, :])             # (B, nc, H)

    h = torch.zeros((B_, H, P, N), dtype=torch.float32, device=xh.device)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = h * chunk_decay[:, c, :, None, None] + S_c[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                 # (B, nc, H, P, N)

    # inter-chunk contribution: y_off[i] = exp(cum_i) · C_i · h_prev
    y_off = torch.einsum("bcqhn,bchpn->bcqhp", Ch, h_prevs) \
        * torch.exp(cum)[..., None]
    y = (y_diag + y_off).reshape(B_, L + pad, H, P)[:, :L]
    return y, h


def _project(p, x):
    """x (B, L, D) -> z (B, L, di), x / B / C (pre-conv), dt (B, L, H)."""
    return x @ p["w_z"], x @ p["w_x"], x @ p["w_B"], x @ p["w_C"], \
        x @ p["w_dt"]


class _Rounded(torch.autograd.Function):
    """f32 ``x`` rounded to ``dtype`` and widened back, with the cotangent
    passed on unrounded: a bf16 cast whose backward convert pair XLA's
    compiled VJP drops (the cotangent stays f32)."""

    @staticmethod
    def forward(ctx, x, dtype):
        return x.to(dtype).float()

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RoundGrad(torch.autograd.Function):
    """The identity on f32 ``x`` whose backward rounds the cotangent to
    ``dtype``: the backward of a bf16 value's f32 upcast."""

    @staticmethod
    def forward(ctx, x, dtype):
        ctx.dtype = dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype).float(), None


def _gate_out(p, y, z, eps=1e-6):
    """The gated RMSNorm and the output projection of the f32 SSD output
    ``y``, in ``z``'s dtype. In f32 plain autograd. In a narrower dtype
    the forward rounds y to it and keeps the gate product y * silu(z)
    unrounded into the norm's f32 upcast, and the backward rounds where the
    reference's compiled VJP does: each of the norm input's two f32 uses
    rounds its cotangent and their sum rounds again; the normalised value's
    cotangent (the out-projection's times norm_w) and y's (the gate's times
    silu(z)) stay f32, so the D skip, the scan and ``dt_bias`` see an
    unrounded cotangent."""
    dt = z.dtype
    if dt == torch.float32:
        return rmsnorm(y * _silu(z), p["norm_w"]) @ p["out_proj"]
    g = _RoundGrad.apply(_Rounded.apply(y, dt) * _silu(z).float(), dt)
    var = torch.mean(torch.square(_RoundGrad.apply(g, dt)), dim=-1,
                     keepdim=True)
    n = _Rounded.apply(_RoundGrad.apply(g, dt) * torch.rsqrt(var + eps), dt)
    out = _RoundGrad.apply(n * p["norm_w"].float(), dt).to(dt)
    return out @ p["out_proj"]


def ssm_forward(p, cfg: ModelConfig, x, return_state: bool = False):
    """Full-sequence Mamba2 block body (no residual). x: (B, L, D).

    With ``return_state`` also returns the block's decode state after the
    sequence: {"state": (B, H, P, N) f32, "conv": {"x", "B", "C"}: the
    last conv_width - 1 pre-conv rows}."""
    s = cfg.ssm
    di, h, g, n = _dims(cfg)
    B_, L, _ = x.shape
    z, xs, Bs, Cs, dt = _project(p, x)
    xi = _silu(_causal_conv(xs, p["conv_x"], p["conv_b_x"]))
    Bm = _silu(_causal_conv(Bs, p["conv_B"], p["conv_b_B"]))
    Cm = _silu(_causal_conv(Cs, p["conv_C"], p["conv_b_C"]))
    xi = xi.reshape(B_, L, h, s.head_dim)
    Bm = Bm.reshape(B_, L, g, n)
    Cm = Cm.reshape(B_, L, g, n)
    dt = F.softplus(dt.float() + p["dt_bias"])            # (B, L, H)
    A = -torch.exp(p["A_log"])                            # (H,)
    with obs.profile_range("ssm.scan"):
        y, final_state = _ssd_chunked(xi * dt[..., None],
                                      dt * A[None, None, :], Bm, Cm, s.chunk)
    y = y + xi.float() * p["D"][None, None, :, None]
    out = _gate_out(p, y.reshape(B_, L, di), z)
    if return_state:
        w = s.conv_width - 1
        conv_state = {"x": xs[:, -w:, :], "B": Bs[:, -w:, :],
                      "C": Cs[:, -w:, :]}
        return out, {"state": final_state, "conv": conv_state}
    return out


def init_ssm_state(cfg: ModelConfig, batch: int, dtype=torch.float32,
                   device="cuda", lead=()):
    """Zero decode state of one block (leading stack dims ``lead``): the
    f32 SSD state (B, H, P, N) and the conv windows (B, conv_width - 1, C)
    in ``dtype``, on ``device`` (the card unless the CPU is asked for)."""
    device = resolve_device(device)
    s = cfg.ssm
    di, h, g, n = _dims(cfg)
    w = s.conv_width - 1

    def zeros(shape, dt):
        return torch.zeros(lead + shape, dtype=dt, device=device)

    return {"state": zeros((batch, h, s.head_dim, n), torch.float32),
            "conv": {"x": zeros((batch, w, di), dtype),
                     "B": zeros((batch, w, g * n), dtype),
                     "C": zeros((batch, w, g * n), dtype)}}


def _conv_step(win_prev, new, w, b):
    """One position of the depthwise conv over the cached window: (out,
    the window shifted by one). The tap products feed the sum unrounded
    (the reference's compiled reduce takes them in f32), the sum and the
    bias add round to the window's dtype."""
    win = torch.cat([win_prev, new[:, None, :]], dim=1)   # (B, W, C)
    out = torch.sum(win.float() * w.float()[None], dim=1).to(win.dtype) + b
    return out, win[:, 1:]


def ssm_decode_step(p, cfg: ModelConfig, x, state):
    """Single-token decode. x: (B, 1, D); ``state`` as ``init_ssm_state``.
    Returns (out (B, 1, D), the new state)."""
    s = cfg.ssm
    di, h, g, n = _dims(cfg)
    B_ = x.shape[0]
    z, xs, Bs, Cs, dt = (t[:, 0] for t in _project(p, x[:, 0:1]))
    xo, new_cx = _conv_step(state["conv"]["x"], xs, p["conv_x"], p["conv_b_x"])
    Bo, new_cb = _conv_step(state["conv"]["B"], Bs, p["conv_B"], p["conv_b_B"])
    Co, new_cc = _conv_step(state["conv"]["C"], Cs, p["conv_C"], p["conv_b_C"])
    xi = _silu(xo).reshape(B_, h, s.head_dim)
    rep = h // g
    Bh = torch.repeat_interleave(_silu(Bo).reshape(B_, g, n), rep,
                                 dim=1).float()           # (B, H, N)
    Ch = torch.repeat_interleave(_silu(Co).reshape(B_, g, n), rep,
                                 dim=1).float()
    dt = F.softplus(dt.float() + p["dt_bias"])            # (B, H)
    A = -torch.exp(p["A_log"])
    with obs.profile_range("ssm.scan"):
        dA = torch.exp(dt * A[None, :])                   # (B, H)
        u = xi.float() * dt[..., None]                    # (B, H, P)
        new_state = state["state"] * dA[:, :, None, None] \
            + torch.einsum("bhn,bhp->bhpn", Bh, u)
        y = torch.einsum("bhn,bhpn->bhp", Ch, new_state) \
            + xi.float() * p["D"][None, :, None]
    out = _gate_out(p, y.reshape(B_, di), z)[:, None, :]
    return out, {"state": new_state,
                 "conv": {"x": new_cx, "B": new_cb, "C": new_cc}}
