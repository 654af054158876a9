"""Binding of the CUDA group fake-quant kernel (``csrc/group_quant.cu``),
the port of the TPU kernel ``repro/kernels/group_quant.py``.

:func:`launch` is the raw launch on PyTorch's current stream: it checks
nothing and counts nothing. Callers go through ``kernels.ops.group_quant``,
which validates the tensors, allocates the outputs and counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["launch"]

_P = ctypes.c_void_p
_SIG = {"rq_group_quant": (ctypes.c_int, [
    _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, _P])}
_DTYPE = {torch.float32: 0, torch.bfloat16: 1}


def launch(w, fq, scale, zero, *, bits: int, group: int) -> None:
    """fq, scale, zero <- group fake-quant of w (K, N); raises if the launch
    is refused (the C entry returns ``cudaGetLastError()``)."""
    lib = build.load("group_quant", _SIG)
    K, N = w.shape
    rc = lib.rq_group_quant(
        w.data_ptr(), fq.data_ptr(), scale.data_ptr(), zero.data_ptr(),
        K, N, group, bits, _DTYPE[w.dtype],
        torch.cuda.current_stream(w.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"group_quant kernel launch failed: CUDA error {rc}")
