"""Binding of the CUDA paged-decode kernels (``csrc/paged_decode.cu``), the
port of the TPU kernels in ``repro/kernels/paged_decode.py``.

:func:`launch` is the raw launch of one route on PyTorch's current stream:
it counts nothing and checks only what the source reports (a tile over the
card's shared memory per block). Callers go through
``kernels.ops.paged_decode``, which routes, validates the tensors,
allocates the outputs and counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

__all__ = ["ROUTES", "launch"]

# route -> C entry point (one per TPU kernel)
ROUTES = {"paged_decode": "rq_paged_decode_head",
          "paged_decode_gqa": "rq_paged_decode_gqa",
          "paged_decode_gqa_mp": "rq_paged_decode_gqa_mp"}

_P, _I = ctypes.c_void_p, ctypes.c_int
_HEAD = [_P] * 10 + [_I] * 6            # pointers, then B H Hkv Dh psz P
_TAIL = [_I, _I, _I, ctypes.c_float, _P]  # normalize kv_dtype quant scale stream
_SIG = {"rq_paged_decode_head": (_I, _HEAD + _TAIL),
        "rq_paged_decode_gqa": (_I, _HEAD + _TAIL),
        "rq_paged_decode_gqa_mp": (_I, _HEAD + [_I] + _TAIL)}
_KV_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ERR_SMEM = -1    # kErrSmem: the tile needs more shared memory than a block has


def launch(route: str, q, k_pages, v_pages, block_tables, seq_lens, k_scale,
           v_scale, out, m, l, *,  # noqa: E741 — softmax (m, l)
           normalize: bool, pages_per_block: int = 1) -> None:
    """out, m, l <- paged decode of q over the pools by ``route``; raises if
    the launch is refused: ValueError when one block's shared memory (sized
    by the source, from pages_per_block · page_size, the query rows and Dh)
    exceeds the card's, RuntimeError on a CUDA error."""
    lib = build.load("paged_decode", _SIG)
    B, H, Dh = q.shape
    _, psz, Hkv, _ = k_pages.shape
    P = block_tables.shape[1]
    quant = k_scale is not None
    ks = k_scale.data_ptr() if quant else None
    vs = v_scale.data_ptr() if quant else None
    head = [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), ks, vs,
            block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            m.data_ptr(), l.data_ptr(), B, H, Hkv, Dh, psz, P]
    mp = [pages_per_block] if route == "paged_decode_gqa_mp" else []
    tail = [int(normalize), _KV_DTYPE[k_pages.dtype], int(quant),
            float(Dh ** -0.5), torch.cuda.current_stream(q.device).cuda_stream]
    rc = getattr(lib, ROUTES[route])(*head, *mp, *tail)
    if rc == _ERR_SMEM:
        raise ValueError(f"{route} at page size {psz}, {pages_per_block} "
                         f"pages per block and head dim {Dh} needs more "
                         f"shared memory per block than the card has: lower "
                         f"pages_per_block")
    if rc != 0:
        raise RuntimeError(f"{route} kernel launch failed: CUDA error {rc}")
