"""Binding of the CUDA flash-decode kernel (``csrc/flash_decode.cu``, the
contiguous flavour of the split-KV body ``csrc/split_decode.cuh``), the
port of the TPU kernel ``repro/kernels/flash_decode.py``.

:func:`launch` is the raw launch on PyTorch's current stream (the split
pass and, where the planner splits, the merge of its partials): it counts
nothing and checks only what the source reports. :func:`plan` cuts the
live rows with the paged routes' planner. Callers go through
``kernels.ops.flash_decode``, which validates the tensors, allocates the
output and counts launches.
"""
from __future__ import annotations

import ctypes
import importlib

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_decode import sm_count, workspace

__all__ = ["TILE_ROWS", "plan", "sm_count", "launch"]

_pd = importlib.import_module("repro_torch.kernels.paged_decode")

_P, _I = ctypes.c_void_p, ctypes.c_int
# q k v ks vs out + the partials' workspace, B H Hkv Dh S kv_len, n_split
# run_rows tile_rows, kv_dtype quant scale stream
_SIG = {"rq_flash_decode": (_I, [_P] * 9 + [_I] * 9
                            + [_I, _I, ctypes.c_float, _P])}
_KV_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ERR_SMEM = -1      # kErrSmem: the tiles need more shared memory than a block has
_ERR_HEAD_DIM = -2  # kErrHeadDim: the split-KV body takes Dh <= 1024

TILE_ROWS = _pd.TILE_ROWS   # rows the body stages per tile


def plan(B: int, H: int, Hkv: int, kv_len: int, sm_count: int):
    """The split of a contiguous decode: the paged routes' plan over a
    table of ``kv_len`` one-row pages, so the live rows, not the cache's
    S, size the runs. Its CTAs span the H query heads at rep 1 (the
    per-query-head instance) and the Hkv KV heads otherwise (the fused
    query rows); ``run_pages`` is the rows per run."""
    if H == Hkv:
        return _pd.plan("paged_decode", B, H, kv_len, 1, 1, sm_count)
    return _pd.plan("paged_decode_gqa", B, Hkv, kv_len, 1, 1, sm_count)


def launch(q, k, v, k_scale, v_scale, out, *, kv_len: int) -> None:
    """out <- one-token attention of q (B, H, Dh) f32 over the first
    ``kv_len`` rows of the (B, S, Hkv, Dh) cache: the whole decode, the
    split pass and merge included (the partials' workspace is allocated
    here). Raises ValueError when one block's shared memory (sized by the
    source from the tile's rows, the query rows and Dh) exceeds the
    card's or the head dim is past what the body takes, RuntimeError on a
    CUDA error."""
    lib = build.load("flash_decode", _SIG)
    B, H, Dh = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    quant = k_scale is not None
    sp = plan(B, H, Hkv, kv_len, sm_count(q.device))
    w, ws = workspace(sp.n_split, B, H, Dh, q.device)
    rc = lib.rq_flash_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None, out.data_ptr(), *ws,
        B, H, Hkv, Dh, S, kv_len, sp.n_split, sp.run_pages, TILE_ROWS,
        _KV_DTYPE[k.dtype], int(quant), float(Dh ** -0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc == _ERR_SMEM:
        raise ValueError(f"flash_decode at {H // Hkv} query heads per KV head "
                         f"and head dim {Dh} needs more shared memory per "
                         f"block than the card has")
    if rc == _ERR_HEAD_DIM:
        raise ValueError(f"flash_decode takes head dims up to 1024, got {Dh}")
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error {rc}")
