"""Binding of the fused causal self-attention kernel
(``csrc/causal_attention.cu``): bf16 q, k, v without a cache, the bf16
forward's attention. It replaces no TPU kernel (the reference's
``blocked_attention`` is jnp); its plain version is ``blocked_attention``
itself (``ref.causal_attention_ref``).

:func:`launch` is the raw launch on PyTorch's current stream: it counts
nothing and checks only what the source reports. Callers go through
``kernels.ops.causal_attention``, which validates the tensors, allocates
the output and counts launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build

__all__ = ["HEAD_DIMS", "launch"]

HEAD_DIMS = (64, 128)   # the head dims compiled in

_P, _I = ctypes.c_void_p, ctypes.c_int
# q k v out, B S Hq Hkv Dh, scale, stream
_SIG = {"rq_causal_attention": (_I, [_P] * 4 + [_I] * 5
                                + [ctypes.c_float, _P])}
_ERR_HEAD_DIM = -2   # kErrHeadDim: Dh is not 64 or 128


def launch(q, k, v, out) -> None:
    """out <- causal attention of q (B, S, Hq, Dh) over k / v (B, S, Hkv,
    Dh), all bf16 and contiguous. Raises ValueError for a head dim the
    source does not take, RuntimeError on a CUDA error."""
    lib = build.load("causal_attention", _SIG)
    B, S, Hq, Dh = q.shape
    Hkv = k.shape[2]
    # Dh^-0.5 rounded to f32, as blocked_attention's f32 scale
    scale = float(np.float32(Dh ** -0.5))
    rc = lib.rq_causal_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, Hq,
        Hkv, Dh, scale, torch.cuda.current_stream(q.device).cuda_stream)
    if rc == _ERR_HEAD_DIM:
        raise ValueError(f"causal_attention takes head dims {HEAD_DIMS}, "
                         f"got {Dh}")
    if rc != 0:
        raise RuntimeError(f"causal_attention kernel launch failed: CUDA "
                           f"error {rc}")
