"""Plain PyTorch versions of the hand-written kernels (the reference's
``repro.kernels.ref`` oracles). The wrappers in ``ops.py`` run these for CPU
tensors; ``chip_smoke.py`` holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.invariance import apply_rotation_cols, apply_rotation_rows
from repro_torch.core.quant import (QuantConfig, compute_qparams,
                                    dequantize_codes, quantize_codes,
                                    unpack_codes, vals_per_word)

__all__ = ["group_quant_ref", "transform_quant_ref", "paged_decode_ref",
           "merge_partials", "flash_decode_ref", "dequant_ref",
           "quant_matmul_ref", "causal_attention_ref"]

NEG = -1e30


def group_quant_ref(w, bits: int, group_size: int, *,
                    round_range: bool = False):
    """Fused quant->dequant roundtrip; returns (fq in w's dtype, scale,
    zero). The range and scale are computed in f32, or in w's dtype with
    ``round_range`` (``core.quant.compute_qparams`` on w itself, the
    reference's ``fake_quant``); the codes and fq in f32."""
    cfg = QuantConfig(bits=bits, group_size=group_size)
    wf = w.float()
    scale, zero = compute_qparams(w if round_range else wf, cfg)
    codes = quantize_codes(wf, scale, zero, cfg)
    fq = dequantize_codes(codes, scale, zero, cfg, out_dtype=w.dtype)
    return fq, scale, zero


def transform_quant_ref(w, pi, s, phi, *, bits: int, group: int, mode: str):
    """Materialize-then-quantize composition of ``apply_transform_ffn``'s
    up/down branches with the group fake-quant roundtrip — the plain version
    of the fused ``transform_quant`` kernel. Returns (fq, scale, zero): the
    arithmetic f32, fq in w's dtype (the TPU kernel's ``out_shape``; the
    reference's own oracle returns f32 for a bf16 w), scale and zero f32."""
    dtype, w = w.dtype, w.float()
    if mode == "up":        # w (D, F): rotate -> x s -> permute on columns
        t = apply_rotation_cols(w, phi) * s[None, :]
        t = t[:, pi]
    elif mode == "down":    # w (F, D): rotate -> / s -> permute on rows
        t = apply_rotation_rows(w, phi) * (1.0 / s)[:, None]
        t = t[pi, :]
    else:
        raise ValueError(f"mode must be 'up' or 'down', got {mode!r}")
    fq, scale, zero = group_quant_ref(t, bits, group)
    return fq.to(dtype), scale, zero


def paged_decode_ref(q, k_pages, v_pages, block_tables, seq_lens,
                     k_scale=None, v_scale=None, normalize=True):
    """Dense paged-attention oracle: gather pages, then a masked softmax —
    the plain version of all three paged-decode kernels.

    q (B, H, Dh); k/v_pages (N, page_size, Hkv, Dh) [+ scales
    (N, page_size, Hkv)]; block_tables (B, P) int; seq_lens (B,) int.
    Query head h reads KV head h // (H // Hkv). Returns (B, H, Dh) f32, or
    the (acc, m, l) log-sum-exp partials when ``normalize=False``.

    Masked positions are removed by selection — scores to -1e30, values and
    probabilities to 0 — so whatever a dead page holds (NaN included) never
    reaches the arithmetic. For every non-empty sequence this is the
    reference's ``paged_decode_ref``; an empty sequence gives the TPU
    kernels' output, exactly 0 with (m, l) = (-1e30, 0) (the reference
    oracle's plain softmax would average V over the masked positions).
    """
    B, H, Dh = q.shape
    _, page_size, Hkv, _ = k_pages.shape
    P = block_tables.shape[1]
    bt = block_tables.long()
    kf = k_pages[bt].float()                     # (B, P, psz, Hkv, Dh)
    vf = v_pages[bt].float()
    if k_scale is not None:
        kf = kf * k_scale[bt][..., None].float()
        vf = vf * v_scale[bt][..., None].float()
    # (B, Hkv, S, Dh); query head h reads KV head h // rep
    kf = kf.reshape(B, P * page_size, Hkv, Dh).transpose(1, 2)
    vf = vf.reshape(B, P * page_size, Hkv, Dh).transpose(1, 2)
    if Hkv < H:  # GQA: repeat KV heads to the query head count
        kf = kf.repeat_interleave(H // Hkv, dim=1)
        vf = vf.repeat_interleave(H // Hkv, dim=1)
    pos = torch.arange(P * page_size, device=q.device)
    mask = (pos[None, :] < seq_lens.to(q.device)[:, None])[:, None]  # (B,1,S)
    vf = torch.where(mask[..., None], vf, 0.0)
    s = (kf @ q.float()[..., None])[..., 0] * Dh ** -0.5          # (B, H, S)
    s = torch.where(mask, s, NEG)
    m = torch.amax(s, dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    l = torch.sum(p, dim=-1)  # noqa: E741 — softmax (m, l)
    acc = (p[:, :, None, :] @ vf)[:, :, 0]                        # (B, H, Dh)
    if not normalize:
        return acc, m, l
    return acc / torch.clamp_min(l, 1e-30)[..., None]


def merge_partials(acc, m, l, normalize=True):  # noqa: E741 — softmax (m, l)
    """Merge the (acc, m, l) log-sum-exp partials of runs of one softmax —
    the plain version of the paged-decode routes' merge kernel.

    acc (N, B, H, Dh); m, l (N, B, H), the leading axis over runs: m* =
    max m_i, l = Σ e^(m_i − m*) l_i, acc = Σ e^(m_i − m*) acc_i. Returns
    acc / max(l, 1e-30), or (acc, m*, l) when ``normalize=False``. For
    non-empty rows this is the reference's ``dist.attention.merge_partials``;
    an all-empty row (every m_i = −1e30, l_i = 0) gives exactly 0 with
    (m*, l) = (−1e30, 0), where the reference's acc / l is 0 / 0.
    """
    m_star = torch.amax(m, dim=0)
    alpha = torch.exp(m - m_star[None])
    num = torch.sum(alpha[..., None] * acc, dim=0)
    den = torch.sum(alpha * l, dim=0)
    if not normalize:
        return num, m_star, den
    return num / torch.clamp_min(den, 1e-30)[..., None]


def flash_decode_ref(q, k, v, k_scale=None, v_scale=None, kv_len=None):
    """Dense one-token attention oracle over a contiguous cache — the plain
    version of the ``flash_decode`` kernel. q (B, H, Dh); k/v (B, S, Hkv,
    Dh) [+ scales (B, S, Hkv)]; query head h reads KV head h // (H // Hkv);
    positions at or past ``kv_len`` (None: S) are masked. Returns (B, H, Dh)
    f32.

    The cache of sequence b is page b of a B-page pool with page size S, so
    this is ``paged_decode_ref`` with block table ``[[0], ..., [B-1]]`` and
    every length ``kv_len``: masked positions are removed by selection
    (NaN past ``kv_len`` never reaches the arithmetic) and ``kv_len = 0``
    gives exactly 0. For 0 < kv_len it is the reference's
    ``flash_decode_ref``.
    """
    B, S = k.shape[:2]
    n = S if kv_len is None else int(kv_len)
    bt = torch.arange(B, dtype=torch.int32, device=q.device)[:, None]
    lens = torch.full((B,), n, dtype=torch.int32, device=q.device)
    return paged_decode_ref(q, k, v, bt, lens, k_scale, v_scale)


def dequant_ref(packed, scale, zero, bits: int, group_size: int, k: int):
    """packed (K_pad // vpw, N) words -> dense weights (K, N) f32.

    Dequantizes at the PADDED length (scale/zero rows cover K_pad when
    lcm(group, vals_per_word) padding was applied, e.g. 3-bit), then slices.
    """
    cfg = QuantConfig(bits=bits, group_size=group_size)
    k_pad = packed.shape[0] * vals_per_word(bits)
    codes = unpack_codes(packed, bits, k_pad)
    return dequantize_codes(codes, scale, zero, cfg)[:k]


def quant_matmul_ref(x, packed, scale, zero, bits: int, group_size: int):
    """x (M, K) @ dequant(packed) -> (M, N) f32 — the plain version of the
    ``quant_matmul`` kernel."""
    w = dequant_ref(packed, scale, zero, bits, group_size, x.shape[1])
    return x.float() @ w


def causal_attention_ref(q, k, v):
    """The plain version of the ``causal_attention`` kernel: the forward's
    own ``blocked_attention(q, k, v, causal=True)`` (f32 scores, chunks of
    1024 keys), of which the kernel is a fused form."""
    from repro_torch.models.layers import blocked_attention
    return blocked_attention(q, k, v, causal=True)
