"""Binding of the CUDA paged-decode kernels (``csrc/paged_decode.cu``), the
port of the TPU kernels in ``repro/kernels/paged_decode.py``.

:func:`launch` is the raw launch of one route on PyTorch's current stream
(the split pass and, where the planner splits, the merge of its partials):
it counts nothing and checks only what the source reports (a tile over the
card's shared memory per block, a head dim past 1024). :func:`plan` is the
split planner of all three routes, pure Python over shapes the host has.
Callers go through
``kernels.ops.paged_decode``, which routes, validates the tensors,
allocates the outputs and counts launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

__all__ = ["ROUTES", "SplitPlan", "plan", "sm_count", "launch"]

# route -> C entry point (one per TPU kernel)
ROUTES = {"paged_decode": "rq_paged_decode_head",
          "paged_decode_gqa": "rq_paged_decode_gqa",
          "paged_decode_gqa_mp": "rq_paged_decode_gqa_mp"}

_P, _I = ctypes.c_void_p, ctypes.c_int
# q k v ks vs bt lens out m l + the partials' workspace, B H Hkv Dh psz P,
# n_split run_pages tile_rows, normalize kv_dtype quant scale stream
_ARGS = [_P] * 13 + [_I] * 9 + [_I, _I, _I, ctypes.c_float, _P]
_SIG = {fn: (_I, _ARGS) for fn in ROUTES.values()}
_KV_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ERR_SMEM = -1      # kErrSmem: the tiles need more shared memory than a block has
_ERR_HEAD_DIM = -2  # kErrHeadDim: the split-KV body takes Dh <= 1024

# positions the split-KV body stages per tile, passed to the kernel (which
# halves it only where two stages of it would not fit a block's shared
# memory, so a run holding one TILE_ROWS tile still holds one)
TILE_ROWS = 32
MIN_RUN_ROWS = 128  # a shorter run would cost more in its merge than it saves
CTAS_PER_SM = 2     # the split pass fills the card to about this many per SM


class SplitPlan(NamedTuple):
    """How a paged decode is cut: runs of ``run_pages`` pages, a whole
    number of ``unit_pages`` (MP on the multi-page route, else the fewest
    pages holding a tile), one CTA per (run, head, sequence): per query
    head on the per-query-head route, per KV head on the fused-GQA
    routes."""
    unit_pages: int
    n_split: int
    run_pages: int


@functools.lru_cache(maxsize=1024)
def plan(route: str, B: int, heads: int, P: int, page_size: int,
         pages_per_block: int, sm_count: int) -> SplitPlan:
    """The split of a paged-decode route, from shapes the host already has.

    ``heads`` is what one sequence's CTAs span: the query heads H on the
    per-query-head route, the KV heads Hkv on the fused-GQA routes. Runs
    are whole units: MP pages on the multi-page route (the reference's
    page blocks), the fewest pages holding ``TILE_ROWS`` positions on the
    other two. The planner fills one wave of ``CTAS_PER_SM`` CTAs per SM
    over the B · heads (sequence, head) pairs and no more (a second,
    partial wave would cost a whole run), never cuts a run below
    one unit or ``MIN_RUN_ROWS`` of the block table's P · page_size
    positions, and evens the runs out over the units. P stands for the
    live length, which only the device holds: the paged server cuts its
    table to the widest live row (``ContinuousBatcher._batch_arrays``), so
    its short contexts stay one launch, with no merge."""
    unit = pages_per_block if route == "paged_decode_gqa_mp" \
        else -(-TILE_ROWS // page_size)
    units = -(-P // unit)
    want = CTAS_PER_SM * sm_count // (B * heads)
    cap = max(1, P * page_size // MIN_RUN_ROWS)
    n = max(1, min(units, want, cap))
    run_units = -(-units // n)
    return SplitPlan(unit, -(-units // run_units), run_units * unit)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return _sm_count(device.index if device.index is not None
                     else torch.cuda.current_device())


def launch(route: str, q, k_pages, v_pages, block_tables, seq_lens, k_scale,
           v_scale, out, m, l, *,  # noqa: E741 — softmax (m, l)
           normalize: bool, pages_per_block: int = 1) -> None:
    """out, m, l <- paged decode of q over the pools by ``route``: the whole
    decode, the split pass and merge included (the partials' workspace is
    allocated here). Raises if the launch is
    refused: ValueError when one block's shared memory (sized by the
    source from the tile's rows, the query rows and Dh) exceeds the card's,
    or the head dim is past what the route takes, RuntimeError on a CUDA
    error."""
    lib = build.load("paged_decode", _SIG)
    B, H, Dh = q.shape
    _, psz, Hkv, _ = k_pages.shape
    P = block_tables.shape[1]
    quant = k_scale is not None
    ks = k_scale.data_ptr() if quant else None
    vs = v_scale.data_ptr() if quant else None
    ptrs = [q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), ks, vs,
            block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            m.data_ptr(), l.data_ptr()]
    tail = [int(normalize), _KV_DTYPE[k_pages.dtype], int(quant),
            float(Dh ** -0.5), torch.cuda.current_stream(q.device).cuda_stream]
    heads = H if route == "paged_decode" else Hkv
    sp = plan(route, B, heads, P, psz, pages_per_block, sm_count(q.device))
    ws = [None] * 3
    if sp.n_split > 1:   # (acc, m, l) partials of every run
        n = sp.n_split * B * H
        w = torch.empty(n * (Dh + 2), dtype=torch.float32, device=q.device)
        ws = [w.data_ptr() + 4 * n * k for k in (0, Dh, Dh + 1)]
    rc = getattr(lib, ROUTES[route])(*ptrs, *ws, B, H, Hkv, Dh, psz, P,
                                     sp.n_split, sp.run_pages, TILE_ROWS,
                                     *tail)
    if rc == _ERR_SMEM:
        raise ValueError(f"{route} at page size {psz}, {pages_per_block} "
                         f"pages per block and head dim {Dh} needs more "
                         f"shared memory per block than the card has")
    if rc == _ERR_HEAD_DIM:
        raise ValueError(f"{route} takes head dims up to 1024, got {Dh}")
    if rc != 0:
        raise RuntimeError(f"{route} kernel launch failed: CUDA error {rc}")
