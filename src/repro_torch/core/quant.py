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
for a CUDA tensor and runs the plain version below for a CPU tensor.

Packed storage for serving (``pack_codes``, ``QTensor``, ``quantize_tensor``)
keeps the reference's uint32 words bit for bit, stored as ``torch.int32``:
PyTorch has few shift kernels for ``uint32``, and the masked arithmetic
shift ``(w >> (i * bits)) & mask`` reads the same codes from the signed
view because ``i * bits + bits <= 32``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["QuantConfig", "compute_qparams", "quantize_codes",
           "dequantize_codes", "fake_quant", "vals_per_word", "pack_codes",
           "unpack_codes", "QTensor", "quantize_tensor", "bits_per_param"]


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
    because G divides K. The result is in w's dtype. As in the reference,
    a bf16 w's group range and scale are computed in bf16
    (``compute_qparams`` on w: two roundings), then the codes and the
    dequantised values in f32 (``group_quant(round_range=True)``); for
    fp32 inputs it is the reference's ``fake_quant`` exactly.
    """
    from repro_torch.kernels import group_quant

    if w.ndim == 1:
        g = w.shape[0] if cfg.group_size == -1 else cfg.group_size
        return group_quant(w.reshape(-1, 1).contiguous(), bits=cfg.bits,
                           group=g, round_range=True)[0].reshape(w.shape)
    g = cfg.resolve_group(w.shape[-2])
    flat = w.reshape(-1, w.shape[-1]).contiguous()
    return group_quant(flat, bits=cfg.bits, group=g,
                       round_range=True)[0].reshape(w.shape)


# ---------------------------------------------------------------------------
# Bit packing (32-bit words along K, stored as int32)
# ---------------------------------------------------------------------------

def vals_per_word(bits: int) -> int:
    return 32 // bits  # 3-bit -> 10 codes/word (2 bits/word wasted)


def pack_codes(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack int codes in [0, 2^bits) into 32-bit words along axis 0.

    codes: (K, ...) with K % vals_per_word == 0 -> (K // vpw, ...) int32
    holding the reference's uint32 words bit for bit.
    """
    vpw = vals_per_word(bits)
    k = codes.shape[0]
    if k % vpw != 0:
        raise ValueError(f"K={k} must be divisible by vals_per_word={vpw}")
    c = codes.reshape((k // vpw, vpw) + tuple(codes.shape[1:])).to(torch.int64)
    shifts = (torch.arange(vpw, device=codes.device) * bits).reshape(
        (1, vpw) + (1,) * (codes.ndim - 1))
    words = torch.sum(c << shifts, dim=1)           # < 2^32: no carries
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


def unpack_codes(packed: torch.Tensor, bits: int, k: int) -> torch.Tensor:
    """Inverse of pack_codes on the word axis -2 of (..., W, N) or axis 0 of
    (W,) -> codes (..., K, N) int32 (the first ``k`` rows)."""
    vpw = vals_per_word(bits)
    mask = (1 << bits) - 1
    shifts = torch.arange(vpw, device=packed.device, dtype=torch.int32) * bits
    if packed.ndim == 1:
        c = (packed[:, None] >> shifts) & mask             # (W, vpw)
        return c.reshape(-1)[:k]
    c = (packed.unsqueeze(-2) >> shifts[:, None]) & mask   # (..., W, vpw, N)
    c = c.reshape(packed.shape[:-2] + (-1, packed.shape[-1]))
    return c[..., :k, :]


# ---------------------------------------------------------------------------
# QTensor: packed storage for the serving path
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class QTensor:
    """Packed, group-quantized tensor (the reference's ``QTensor``).

    ``shape`` is the LOGICAL trailing shape, (K, N) or (K,), and never
    includes stacking dims: a stacked leaf ``packed (L, K_pad//vpw, N)``
    indexed with ``[i]`` gives layer ``i``'s QTensor with the same metadata.

    packed: (..., K_pad // vals_per_word, N) int32 (the uint32 words)
    scale / zero: (..., K_pad // G, N)
    """

    packed: torch.Tensor
    scale: torch.Tensor
    zero: torch.Tensor
    bits: int
    group_size: int
    shape: tuple  # logical (un-padded, un-stacked) shape

    @property
    def dtype(self):
        return torch.float32

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def device(self):
        return self.packed.device

    def __getitem__(self, i):
        """Slice of the stacking dims (e.g. one layer of a stacked leaf)."""
        return QTensor(self.packed[i], self.scale[i], self.zero[i], self.bits,
                       self.group_size, self.shape)

    def to(self, device):
        return QTensor(self.packed.to(device), self.scale.to(device),
                       self.zero.to(device), self.bits, self.group_size,
                       self.shape)

    def dequantize(self, out_dtype=torch.float32) -> torch.Tensor:
        """Dense weights (..., K, N) (or (..., K)); every stacked index is
        dequantized at once, with the reference's per-group arithmetic."""
        k = self.shape[0]
        k_pad = self.packed.shape[-2] * vals_per_word(self.bits)
        codes = unpack_codes(self.packed, self.bits, k_pad)  # (..., K_pad, N)
        lead, n = codes.shape[:-2], codes.shape[-1]
        g = self.group_size
        qg = codes.float().reshape(lead + (k_pad // g, g, n))
        d = qg - self.zero.unsqueeze(-2)
        # the product in f32, rounded to out_dtype as it is written (no f32
        # copy of the result); the codes and d are full-size f32 tensors all
        # the same, so a bf16 dequant moves no fewer bytes than an f32 one
        w = torch.empty(d.shape, dtype=out_dtype, device=d.device)
        torch.mul(d, self.scale.unsqueeze(-2).float(), out=w)
        w = w.reshape(lead + (k_pad, n))[..., :k, :]
        if len(self.shape) == 1:
            w = w[..., 0]
        return w

    def memory_bytes(self) -> int:
        return int(self.packed.numel() * 4
                   + self.scale.numel() * self.scale.element_size()
                   + self.zero.numel() * self.zero.element_size())


def _quantize_stack(w3: torch.Tensor, cfg: QuantConfig):
    """w3 (L, K, N) -> (packed (L, K_pad/vpw, N), scale, zero (L, K_pad/G,
    N), G): each of the L matrices zero-padded along K to a multiple of
    lcm(G, vpw) and quantized on its own (groups and words never straddle
    two matrices, so one flattened (L·K_pad, N) pass is the per-matrix
    result)."""
    lyr, k, n = w3.shape
    g = cfg.resolve_group(k)
    vpw = vals_per_word(cfg.bits)
    lcm = math.lcm(g, vpw)
    k_pad = lcm * -(-k // lcm)
    if k_pad != k:
        w3 = torch.cat([w3, torch.zeros((lyr, k_pad - k, n), dtype=w3.dtype,
                                        device=w3.device)], dim=1)
    cfg_p = dataclasses.replace(cfg, group_size=g)
    flat = w3.reshape(lyr * k_pad, n).float()
    scale, zero = compute_qparams(flat, cfg_p)
    codes = quantize_codes(flat, scale, zero, cfg_p)
    packed = pack_codes(codes, cfg.bits)
    return (packed.reshape(lyr, k_pad // vpw, n),
            scale.reshape(lyr, k_pad // g, n),
            zero.reshape(lyr, k_pad // g, n), g)


def quantize_tensor(w: torch.Tensor, cfg: QuantConfig) -> QTensor:
    """Quantize + pack a weight into a QTensor.

    (K, N) / (K,) quantize directly; higher-rank (..., K, N) inputs (stacked
    layer weights) are quantized independently per leading index.
    """
    if w.ndim <= 2:
        w2 = w if w.ndim == 2 else w[:, None]
        packed, scale, zero, g = _quantize_stack(w2[None], cfg)
        return QTensor(packed[0], scale[0], zero[0], cfg.bits, g,
                       tuple(w.shape))
    lead, logical = tuple(w.shape[:-2]), tuple(w.shape[-2:])
    packed, scale, zero, g = _quantize_stack(w.reshape((-1,) + logical), cfg)
    return QTensor(packed.reshape(lead + packed.shape[1:]),
                   scale.reshape(lead + scale.shape[1:]),
                   zero.reshape(lead + zero.shape[1:]), cfg.bits, g, logical)


def bits_per_param(cfg: QuantConfig, scale_bits: int = 16,
                   zero_bits: int = 4) -> float:
    """Effective storage cost (paper Table 3 'Bits/Param' column)."""
    vpw = vals_per_word(cfg.bits)
    code_bits = 32.0 / vpw  # 3-bit stores at 3.2 bits/code
    g = cfg.group_size if cfg.group_size not in (-1, None) else 1 << 30
    return code_bits + (scale_bits + zero_bits) / g
