"""Binding of the CUDA dequant-matmul kernel (``csrc/quant_matmul.cu``), the
port of the TPU kernel ``repro/kernels/quant_matmul.py``.

:func:`launch` is the raw launch on PyTorch's current stream: it counts
nothing and checks nothing. Callers go through ``kernels.ops.quant_matmul``,
which validates the tensors, allocates the output and counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["launch"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# x packed scale zero out, M K N W group bits x_dtype, stream
_SIG = {"rq_quant_matmul": (_I, [_P] * 5 + [_I] * 7 + [_P])}
_X_DTYPE = {torch.float32: 0, torch.bfloat16: 1}


def launch(x, packed, scale, zero, out, *, bits: int, group: int) -> None:
    """out (M, N) <- x (M, K) @ dequant(packed (W, N), scale, zero); raises
    RuntimeError on a CUDA error."""
    lib = build.load("quant_matmul", _SIG)
    M, K = x.shape
    W, N = packed.shape
    rc = lib.rq_quant_matmul(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), zero.data_ptr(),
        out.data_ptr(), M, K, N, W, group, bits, _X_DTYPE[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: CUDA error {rc}")
