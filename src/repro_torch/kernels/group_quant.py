"""Binding of the CUDA group fake-quant kernel (``csrc/group_quant.cu``),
the port of the TPU kernel ``repro/kernels/group_quant.py``.

:func:`plan` is the launch planner, pure Python over the shapes: the body
(a tile body with the group compiled in for G 32, 64 and 128, the same body
with G at run time for every other group, or the vector body for N = 1),
the vector width of w's accesses, how many row slices share a column
vector, the columns of a CTA's tile and the grid. The kernel's entry point
plans for itself with the same rules (``make_plan`` in the source, read
back through :func:`kernel_plan` on the card); this module's copy is the
one the CPU tests hold. It refuses exactly the shapes
``kernels.ops._check_quant_args`` refuses.
:func:`launch` is the raw launch on PyTorch's current stream: it checks
nothing and counts nothing. Callers go through ``kernels.ops.group_quant``,
which validates the tensors, allocates the outputs and counts launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

__all__ = ["BODIES", "Plan", "check", "plan", "cells", "kernel_plan", "launch"]

BODIES = ("fixed", "general", "vector")
THREADS = 256           # csrc/group_quant.cu kThreads
WARPS = THREADS // 32
HOLD = 16               # kHold: values a vector-body lane holds
MAX_SLICES = 128        # kMaxSlices
FIXED_GROUPS = (32, 64, 128)
MAX_GRID = 2 ** 31 - 1
MAX_N = 65535 * 256     # ops._check_quant_args's column limit
SMEM_MAX = 232_448      # dynamic shared memory one block may use (H100)
RED_SMEM = 4 * 2 * WARPS * 16   # group_quant_tile's static ``red`` array
WAVE = 2 * 132          # kWave: full-hold CTAs the card runs at once

_P = ctypes.c_void_p
_SIG = {"rq_group_quant": (ctypes.c_int, [
    _P, _P, _P, _P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, _P]),
    "rq_group_quant_plan": (None, [ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_int, ctypes.c_int, _P])}
_DTYPE = {torch.float32: 0, torch.bfloat16: 1}


class Plan(NamedTuple):
    """One launch (the fields of the source's ``Plan``, in order).

    Tile body: a thread owns ``vec`` columns and the rows s, s + slices,
    ... of its group; ``slices`` row slices share a column vector, ``ws``
    warps stacked along the rows (1: the slices sit inside a warp), ``cw``
    column vectors side by side in a warp; a CTA's tile is ``tile``
    columns of one group; a thread keeps up to ``hold`` rows (vector
    body: values) in registers, and ``passes`` is 1 (w read once) or 2
    (statistics, then a second read). Vector body: ``slices`` lanes read
    one group, ``cw`` groups a warp, ``tile`` groups a CTA. ``blocks``
    (group, tile) blocks, walked by ``grid`` CTAs."""
    body: str
    vec: int
    slices: int
    cw: int
    ws: int
    hold: int
    passes: int
    tile: int
    blocks: int
    grid: int
    smem: int


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _pow2_floor(x: int) -> int:
    return 1 << (x.bit_length() - 1)


def hold_rows(esize: int) -> int:
    """Rows a tile-body thread holds in registers (``hold_rows`` in the
    source): 16 f32 vectors, 8 bf16 ones (whose 8 values a vector would
    spill at 16); half as many in a call of between one and two WAVEs of
    blocks, whose second wave would run nearly empty; twice as many, one
    CTA an SM, for a group too long to hold otherwise."""
    return 16 if esize == 4 else 8


def check(K: int, N: int, group: int) -> None:
    """Raise ``ValueError`` for a shape the kernel does not take: the shape
    conditions of ``ops._check_quant_args``."""
    if not (group > 0 and K % group == 0):
        raise ValueError(f"K={K} must be a positive multiple of group={group}")
    if not 0 < N <= MAX_N:
        raise ValueError(f"N={N} out of the kernel's range")


def _tile_plan(K: int, N: int, group: int, esize: int, vec: int,
               hold: int) -> Plan:
    slices = min(_pow2_ceil(-(-group // hold)), MAX_SLICES)
    sw = min(slices, 16)
    ws, cw = slices // sw, 32 // sw
    body = "fixed" if vec == 16 // esize and group in FIXED_GROUPS \
        else "general"
    cvecs = WARPS // ws * cw
    blocks = K // group * -(-(N // vec) // cvecs)
    return Plan(body, vec, slices, cw, ws, hold,
                1 if group <= slices * hold else 2, cvecs * vec, blocks,
                min(blocks, MAX_GRID), RED_SMEM)


@functools.lru_cache(maxsize=1024)
def plan(K: int, N: int, group: int, dtype=torch.float32) -> Plan:
    """The launch of ``group_quant`` on w (K, N) of ``dtype`` (float32 or
    bfloat16) at ``group``, for tensors that start on 16-byte boundaries
    (every allocation does; the kernel narrows ``vec`` for a view that
    does not). Raises ``ValueError`` for a shape it cannot take."""
    check(K, N, group)
    esize = torch.empty((), dtype=dtype).element_size()
    if N == 1:
        team = 32 if group >= 32 else _pow2_floor(group)
        tile = WARPS * (32 // team)
        blocks = -(-(K // group) // tile)
        return Plan("vector", 1, team, 32 // team, 1, HOLD,
                    1 if group <= team * HOLD else 2, tile, blocks,
                    min(blocks, MAX_GRID), 0)
    vec = 16 // esize
    while vec > 1 and N % vec:
        vec //= 2
    hold = hold_rows(esize)
    p = _tile_plan(K, N, group, esize, vec, hold)
    if p.passes == 2 and group <= MAX_SLICES * 2 * hold:
        p = _tile_plan(K, N, group, esize, vec, 2 * hold)  # one CTA an SM
    elif WAVE < p.blocks < 2 * WAVE and p.slices <= 8:
        # halved, the slices stay in one warp
        p = _tile_plan(K, N, group, esize, vec, hold // 2)
    return p


def cells(p: Plan, group: int, thread: int):
    """The kernel's index map for one thread of a CTA: (column vector in
    the tile, rows of the group) for a tile body, (group in the CTA,
    values of the group) for the vector body; the thread writes the
    scale and zero of its column vector (group) when its rows start at 0."""
    lane, warp = thread % 32, thread // 32
    if p.body == "vector":
        return ((warp * p.cw + lane // p.slices),
                list(range(lane % p.slices, group, p.slices)))
    sw = p.slices // p.ws
    wc = WARPS // p.ws
    c = warp % wc * p.cw + lane % p.cw
    s = warp // wc * sw + lane // p.cw
    return c, list(range(s, group, p.slices))


def kernel_plan(K: int, N: int, group: int, dtype=torch.float32) -> Plan:
    """The plan the built kernel makes for the same call (builds the
    library; the machine with the card)."""
    lib = build.load("group_quant", _SIG)
    out = (ctypes.c_int64 * len(Plan._fields))()
    lib.rq_group_quant_plan(K, N, group, _DTYPE[dtype], out)
    vals = list(out)
    return Plan(BODIES[vals[0]], *vals[1:])


def launch(w, fq, scale, zero, *, bits: int, group: int,
           round_range: bool = False) -> None:
    """fq, scale, zero <- group fake-quant of w (K, N); ``round_range``
    rounds each group's range and scale to w's dtype as they are computed
    (``ops.group_quant``). Raises if the launch is refused (the C entry
    returns ``cudaGetLastError()``)."""
    lib = build.load("group_quant", _SIG)
    K, N = w.shape
    rc = lib.rq_group_quant(
        w.data_ptr(), fq.data_ptr(), scale.data_ptr(), zero.data_ptr(),
        K, N, group, bits, _DTYPE[w.dtype], int(round_range),
        torch.cuda.current_stream(w.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"group_quant kernel launch failed: CUDA error {rc}")
