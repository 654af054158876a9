"""Plain PyTorch versions of the hand-written kernels (the reference's
``repro.kernels.ref`` oracles). The wrappers in ``ops.py`` run these for CPU
tensors; ``chip_smoke.py`` holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

from repro_torch.core.invariance import apply_rotation_cols, apply_rotation_rows
from repro_torch.core.quant import (QuantConfig, compute_qparams,
                                    dequantize_codes, quantize_codes)

__all__ = ["group_quant_ref", "transform_quant_ref"]


def group_quant_ref(w, bits: int, group_size: int):
    """Fused quant->dequant roundtrip; returns (fq, scale, zero)."""
    cfg = QuantConfig(bits=bits, group_size=group_size)
    wf = w.float()
    scale, zero = compute_qparams(wf, cfg)
    codes = quantize_codes(wf, scale, zero, cfg)
    fq = dequantize_codes(codes, scale, zero, cfg, out_dtype=w.dtype)
    return fq, scale, zero


def transform_quant_ref(w, pi, s, phi, *, bits: int, group: int, mode: str):
    """Materialize-then-quantize composition of ``apply_transform_ffn``'s
    up/down branches with the group fake-quant roundtrip — the plain version
    of the fused ``transform_quant`` kernel. Returns (fq, scale, zero)."""
    w = w.float()
    if mode == "up":        # w (D, F): rotate -> x s -> permute on columns
        t = apply_rotation_cols(w, phi) * s[None, :]
        t = t[:, pi]
    elif mode == "down":    # w (F, D): rotate -> / s -> permute on rows
        t = apply_rotation_rows(w, phi) * (1.0 / s)[:, None]
        t = t[pi, :]
    else:
        raise ValueError(f"mode must be 'up' or 'down', got {mode!r}")
    return group_quant_ref(t, bits, group)
