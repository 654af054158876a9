"""Binding of the CUDA fused transform + fake-quant kernel
(``csrc/transform_quant.cu``), the port of the TPU kernel
``repro/kernels/transform_quant.py``.

:func:`launch` is the raw launch on PyTorch's current stream: it checks
nothing and counts nothing. Callers go through
``kernels.ops.transform_quant``, which validates the tensors, prepares
cos/sin and the scale vector, allocates the outputs and counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["launch", "MODES"]

MODES = {"up": 0, "down": 1}
_P = ctypes.c_void_p
_SIG = {"rq_transform_quant": (ctypes.c_int, [
    _P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int64,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, _P])}


def launch(w, pi, svec, cos, sin, fq, scale, zero, *, bits: int, group: int,
           mode: str) -> None:
    """fq, scale, zero <- fake-quant of the (pi, svec, cos/sin)-transformed
    w (K, N); ``svec`` is s for "up" and 1/s for "down". Raises if the
    launch is refused."""
    lib = build.load("transform_quant", _SIG)
    K, N = w.shape
    rc = lib.rq_transform_quant(
        w.data_ptr(), pi.data_ptr(), svec.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), fq.data_ptr(), scale.data_ptr(), zero.data_ptr(),
        K, N, group, bits, MODES[mode],
        torch.cuda.current_stream(w.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"transform_quant kernel launch failed: CUDA error {rc}")
