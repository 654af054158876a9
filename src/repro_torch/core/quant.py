"""Asymmetric integer group quantization (paper §3.1).

Weights are quantized in groups of ``group_size`` *contiguous* values along
the input (K) axis of a ``(K, N)`` weight used as ``x @ W``:

    quant(W_g)   = clip(round(W_g / s_g) + z_g, q_min, q_max)        (Eqn. 1)
    s_g          = (max(W_g) - min(W_g)) / (q_max - q_min)           (Eqn. 2)
    z_g          = round(q_min - min(W_g) / s_g)                     (Eqn. 3)
    dequant(q_g) = s_g * (q_g - z_g)                                 (Eqn. 4)

``torch.round`` rounds half to even like ``jnp.round``. ``fake_quant`` is
the quant→dequant roundtrip used by RTN and the discrete search: it goes
through ``kernels.group_quant``, which launches the hand-written CUDA kernel
for a CUDA tensor and runs the plain version below for a CPU tensor. Packed
storage (``pack_codes``, ``QTensor``) waits for the serving slice.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["QuantConfig", "compute_qparams", "quantize_codes",
           "dequantize_codes", "fake_quant"]


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static quantization configuration."""

    bits: int = 2
    group_size: int = 128  # groups along axis 0 (K); -1 => per-column (one group)
    scale_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.bits < 1 or self.bits > 8:
            raise ValueError(f"bits must be in [1, 8], got {self.bits}")

    @property
    def q_min(self) -> int:
        return 0

    @property
    def q_max(self) -> int:
        return (1 << self.bits) - 1

    def resolve_group(self, k: int) -> int:
        g = k if self.group_size in (-1, None) else self.group_size
        if k % g != 0:
            raise ValueError(f"K={k} not divisible by group_size={g}")
        return g


def _grouped(w: torch.Tensor, group: int) -> torch.Tensor:
    """(K, ...) -> (K//G, G, ...)."""
    k = w.shape[0]
    return w.reshape((k // group, group) + tuple(w.shape[1:]))


def compute_qparams(w: torch.Tensor, cfg: QuantConfig):
    """Closed-form scale / zero-point per group (Eqns. 2-3).

    w: (K, N) or (K,). Returns (scale, zero), each (K//G, N) / (K//G,).
    """
    g = cfg.resolve_group(w.shape[0])
    wg = _grouped(w, g)
    wmax = torch.amax(wg, dim=1)
    wmin = torch.amin(wg, dim=1)
    # a same-device tensor divisor: PyTorch's CUDA division by a Python
    # scalar multiplies by its reciprocal, which is not the reference's
    # correctly rounded division
    q_range = torch.tensor(float(cfg.q_max - cfg.q_min), dtype=wmax.dtype,
                           device=wmax.device)
    scale = (wmax - wmin) / q_range
    scale = torch.clamp_min(scale, 1e-8).to(cfg.scale_dtype)
    zero = torch.round(cfg.q_min - wmin / scale)
    zero = torch.clamp(zero, cfg.q_min, cfg.q_max)
    return scale, zero


def quantize_codes(w: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
                   cfg: QuantConfig) -> torch.Tensor:
    """Eqn. 1 with clipping to the representable range. Returns int32 codes."""
    g = cfg.resolve_group(w.shape[0])
    wg = _grouped(w, g)
    q = torch.round(wg / scale[:, None].float()) + zero[:, None]
    q = torch.clamp(q, cfg.q_min, cfg.q_max)
    return q.reshape(w.shape).to(torch.int32)


def dequantize_codes(codes: torch.Tensor, scale: torch.Tensor,
                     zero: torch.Tensor, cfg: QuantConfig,
                     out_dtype=torch.float32) -> torch.Tensor:
    """Eqn. 4."""
    g = cfg.resolve_group(codes.shape[0])
    qg = _grouped(codes.float(), g)
    w = (qg - zero[:, None]) * scale[:, None].float()
    return w.reshape(codes.shape).to(out_dtype)


def fake_quant(w: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """quant -> dequant roundtrip (the search's inner primitive).

    Accepts (K, N), (K,) or stacked (L, K, N) inputs — grouping is along
    axis -2 for matrices (the K axis of ``x @ W``) and axis -1 for vectors,
    independently per leading index. A stacked (L, K, N) input is one
    ``group_quant`` call over (L·K, N): groups never straddle two matrices
    because G divides K. The arithmetic is fp32 (bf16 inputs are widened,
    as ``kernels.ref.group_quant_ref`` does); for fp32 inputs it is the
    reference's ``fake_quant`` exactly.
    """
    from repro_torch.kernels import group_quant

    if w.ndim == 1:
        g = w.shape[0] if cfg.group_size == -1 else cfg.group_size
        return group_quant(w.reshape(-1, 1).contiguous(), bits=cfg.bits,
                           group=g)[0].reshape(w.shape)
    g = cfg.resolve_group(w.shape[-2])
    flat = w.reshape(-1, w.shape[-1]).contiguous()
    return group_quant(flat, bits=cfg.bits, group=g)[0].reshape(w.shape)
