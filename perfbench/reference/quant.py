"""Plain group quantisation and the (π, s, φ) transforms of InvarExplore,
written from the paper (§3.1-3.2), in float32.

Weights are ``(K, N)`` for ``x @ W``, quantised in groups of ``group``
contiguous rows (the K axis), asymmetric, ``bits`` wide:

    s_g = (max W_g - min W_g) / (2^bits - 1),   z_g = round(-min W_g / s_g)
    q   = clip(round(W / s_g) + z_g, 0, 2^bits - 1),   W' = s_g (q - z_g)

with rounding half to even. ``range_dtype`` is the type the group's range
and scale are rounded to before the codes are taken (the stored weights'
type: bfloat16 for a bf16 model's fake-quant, float32 otherwise); the codes
and W' are always float32.

A transform acts on an FFN's hidden (F) axis: R rotates the pairs (2i,
2i+1) by φ_i, S scales, P permutes. Up (and its bias) become P S R W_up,
down becomes W_down R^T S^-1 P^T (its rows rotated forward, times S^-1,
permuted); a gated FFN's gate is permuted only. A weight that lies within
an ulp of a rounding boundary of the quantiser takes one code or the next
with the last bit of its transform, so the order of these products (S^-1
as reciprocals, then a product) is the quantiser's, not one of many.
"""
from __future__ import annotations

import torch


def _div(a, b):
    # a correctly rounded division by a tensor (on the card, a division by
    # a Python number multiplies by its reciprocal instead)
    return a / torch.as_tensor(b, dtype=a.dtype, device=a.device)


def fake_quant(w: torch.Tensor, bits: int, group: int,
               range_dtype=torch.float32) -> torch.Tensor:
    """Quantise and dequantise ``w`` (..., K, N) per group of ``group``
    rows; returns float32."""
    K, N = w.shape[-2:]
    lead = w.shape[:-2]
    qmax = (1 << bits) - 1
    wr = w.to(range_dtype).reshape(lead + (K // group, group, N))
    wmax = wr.amax(dim=-2)
    wmin = wr.amin(dim=-2)
    scale = _div(wmax - wmin, float(qmax)).clamp_min(1e-8).float()
    zero = torch.round(0.0 - wmin.float() / scale).clamp(0, qmax)
    wf = w.float().reshape(lead + (K // group, group, N))
    q = torch.clamp(torch.round(wf / scale[..., None, :]) + zero[..., None, :],
                    0, qmax)
    return ((q - zero[..., None, :]) * scale[..., None, :]).reshape(w.shape)


def rotate_pairs(w: torch.Tensor, phi: torch.Tensor, axis: int):
    """R applied along ``axis`` of ``w``: pair (2i, 2i+1) -> (c a - s b,
    s a + c b) with c, s = cos φ_i, sin φ_i."""
    w = torch.movedim(w, axis, 0)
    f = w.shape[0]
    pairs = w.reshape((f // 2, 2) + tuple(w.shape[1:]))
    shape = (f // 2,) + (1,) * (w.ndim - 1)
    c, s = torch.cos(phi).reshape(shape), torch.sin(phi).reshape(shape)
    a, b = pairs[:, 0], pairs[:, 1]
    out = torch.stack([c * a - s * b, s * a + c * b], dim=1).reshape(w.shape)
    return torch.movedim(out, 0, axis)


def transform_up(w, pi, s, phi):
    """Columns of (D, F) ``w``: rotate, scale, permute."""
    return (rotate_pairs(w.float(), phi, 1) * s[None, :])[:, pi]


def transform_down(w, pi, s, phi):
    """Rows of (F, D) ``w``: rotate, scale by S^-1 (the reciprocals of s),
    permute."""
    return (rotate_pairs(w.float(), phi, 0) * (1.0 / s)[:, None])[pi, :]


def transform_bias(b, pi, s, phi):
    return (rotate_pairs(b.float(), phi, 0) * s)[pi]


def is_identity(pi, s, phi) -> bool:
    return bool(torch.equal(pi, torch.arange(pi.shape[0], device=pi.device))
                and torch.all(s == 1) and torch.all(phi == 0))
