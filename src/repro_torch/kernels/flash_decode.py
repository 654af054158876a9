"""Binding of the CUDA flash-decode kernel (``csrc/flash_decode.cu``), the
port of the TPU kernel ``repro/kernels/flash_decode.py``.

:func:`launch` is the raw launch on PyTorch's current stream: it counts
nothing and checks only what the source reports. Callers go through
``kernels.ops.flash_decode``, which validates the tensors, allocates the
output and counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["launch"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# q k v ks vs out, B H Hkv Dh S kv_len, kv_dtype quant scale stream
_SIG = {"rq_flash_decode": (_I, [_P] * 6 + [_I] * 6
                            + [_I, _I, ctypes.c_float, _P])}
_KV_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ERR_SMEM = -1    # kErrSmem: the tile needs more shared memory than a block has


def launch(q, k, v, k_scale, v_scale, out, *, kv_len: int) -> None:
    """out <- one-token attention of q (B, H, Dh) f32 over the first
    ``kv_len`` rows of the (B, S, Hkv, Dh) cache; raises ValueError when one
    block's shared memory (a fixed tile of rows, the rep query rows, Dh)
    exceeds the card's, RuntimeError on a CUDA error."""
    lib = build.load("flash_decode", _SIG)
    B, H, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    quant = k_scale is not None
    rc = lib.rq_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None, out.data_ptr(),
        B, H, Hkv, Dh, S, kv_len, _KV_DTYPE[k.dtype], int(quant),
        float(Dh ** -0.5), torch.cuda.current_stream(q.device).cuda_stream)
    if rc == _ERR_SMEM:
        raise ValueError(f"flash_decode at {H // Hkv} query heads per KV head "
                         f"and head dim {Dh} needs more shared memory per "
                         f"block than the card has")
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error {rc}")
