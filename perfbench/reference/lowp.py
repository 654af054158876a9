"""Matrix products of the plain reference, in float32 or in a lower
precision for the correctness check's control.

``float32`` is a plain product with TF32 off. The lower precisions round
each operand as the hardware would before a float32 accumulation, so the
control reads the same on the CPU (its tests) as on the card:

- ``tf32``: both operands rounded to TF32's 10 mantissa bits (nearest,
  ties away from zero, as ``cvt.rna.tf32.f32``): the step below float32,
  which keeps float32 storage and rounds only what enters a product;
- ``fp8``: both operands scaled to e4m3's range (the left one per row, the
  right one per column, by their largest magnitude over 448) and rounded
  to e4m3: the step below bfloat16. A model computed in fp8 also keeps its
  activations in it: ``activation`` rounds the residual stream so, per
  token, wherever a sublayer hands it on.
"""
from __future__ import annotations

import torch

PRECISIONS = ("float32", "tf32", "fp8")
E4M3_MAX = 448.0


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 explicit mantissa bits)."""
    bits = x.contiguous().view(torch.int32)
    sign = bits & torch.tensor(-2**31, dtype=torch.int32, device=x.device)
    mag = bits & 0x7FFFFFFF
    finite = mag < 0x7F800000
    rounded = (mag + 0x1000) & ~0x1FFF
    out = torch.where(finite, rounded, mag) | sign
    return out.view(torch.float32)


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Scale ``x`` along ``dim`` so its largest magnitude is e4m3's largest,
    round to e4m3 and scale back."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def matmul(x: torch.Tensor, w: torch.Tensor, precision: str = "float32"):
    """``x @ w`` for x (..., M, K) and w (..., K, N), both float32, in
    ``precision``; the sum is float32."""
    if precision == "float32":
        return x @ w
    if precision == "tf32":
        return tf32_round(x) @ tf32_round(w)
    if precision == "fp8":
        return fp8_round(x, -1) @ fp8_round(w, -2)
    raise ValueError(f"precision must be one of {PRECISIONS}, got "
                     f"{precision!r}")


def activation(h: torch.Tensor, precision: str = "float32"):
    """The residual stream ``h`` (..., D) as ``precision`` stores it: fp8
    rounds each token's row to e4m3 (scaled by its largest magnitude); the
    others keep float32."""
    return fp8_round(h, -1) if precision == "fp8" else h


def no_tf32():
    """Turn TF32 off for float32 products and convolutions (the card's
    defaults would let cuDNN use it)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
