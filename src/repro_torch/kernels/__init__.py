"""Hand-written Hopper kernels of the port and their plain versions.

- ``group_quant``: group fake-quant round trip (the TPU kernel
  ``repro/kernels/group_quant.py``); backs ``core.quant.fake_quant``.
- ``transform_quant``: fused (π, s, φ) transform + group fake-quant (the
  TPU kernel ``repro/kernels/transform_quant.py``); the search's fused
  candidate build.
- ``paged_decode``: one-token decode attention over a block-table page pool,
  three routes (per query head, per KV head, multi-page per KV head) as the
  TPU kernels of ``repro/kernels/paged_decode.py``; the serving decode
  step's attention.
- ``flash_decode``: one-token decode attention over a contiguous KV cache
  (the TPU kernel ``repro/kernels/flash_decode.py``); the contiguous decode
  step's attention when ``cfg.use_flash_decode`` is set.
- ``quant_matmul``: x @ dequant(packed W) (the TPU kernel
  ``repro/kernels/quant_matmul.py``); a public op, on no serving path (as
  in the reference, which dequantises each layer instead).
- ``causal_attention``: fused causal self-attention over bf16 q, k, v
  (no TPU kernel: the reference's ``blocked_attention`` is jnp); the bf16
  forward's attention without a cache (``models.layers.self_attention``).

CUDA C++ sources live in ``repro_torch/csrc/`` and are built with nvcc for
``sm_90a`` on first use (``build.py``); ``ops.py`` holds the wrappers and
their launch counts, ``ref.py`` the plain PyTorch versions.
"""
from repro_torch.kernels.ops import (LAUNCHES, causal_attention, flash_decode,
                                     group_quant, paged_decode,
                                     paged_decode_route, quant_matmul,
                                     reset_launch_counts, transform_quant)

__all__ = ["group_quant", "transform_quant", "paged_decode",
           "paged_decode_route", "flash_decode", "quant_matmul",
           "causal_attention", "LAUNCHES", "reset_launch_counts"]
