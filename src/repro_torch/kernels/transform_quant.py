"""Binding of the CUDA fused transform + fake-quant kernels
(``csrc/transform_quant.cu``), the port of the TPU kernel
``repro/kernels/transform_quant.py``.

:func:`plan` is the launch planner, pure Python over the shapes: for "up"
the thread block cluster of a quant band (cluster size, the source-column
slice of each CTA, the sub-band height and so one pass or two), for "down"
the column tile of a CTA (its 16-byte copies hold 4 f32 or 8 bf16
values, so the tile follows the element size). A shape it cannot take
raises ``ValueError``.
:func:`launch` is the raw launch of a plan on PyTorch's current stream: it
checks nothing and counts nothing. Callers go through
``kernels.ops.transform_quant``, which validates the tensors, plans,
prepares cos/sin and the scale vector, allocates the outputs and counts
launches.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import build

__all__ = ["MODES", "UpPlan", "DownPlan", "plan", "up_smem", "down_smem",
           "launch"]

MODES = ("up", "down")
SMEM_MAX = 232_448     # dynamic shared memory one block may use (H100)
PORTABLE_CLUSTER = 8   # larger clusters are non-portable (at most 16)
MIN_SLICE = 128        # source columns per CTA below which the cluster shrinks
UP_THREADS = 256       # csrc/transform_quant.cu kUpThreads
UP_HOLD_ROWS = 32      # csrc/transform_quant.cu kHoldRows: one pass to G 32
UP_SMEM = SMEM_MAX // 2  # an "up" CTA's shared memory target: two per SM
DOWN_THREADS = 256     # csrc/transform_quant.cu kDownThreads
DOWN_UNITS = 32        # column units of a "down" tile at most
DOWN_SMEM = 48 * 1024  # a "down" tile's shared memory target: several per SM
MAX_GRID_X = 2 ** 31 - 1

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
_SIG = {
    # pointers, d f group bits, dtype cluster slice rows threads smem, stream
    "rq_transform_quant_up": (_I, [_P] * 8 + [_L, _L, _I, _I] + [_I] * 6
                              + [_P]),
    # pointers, f n group bits, dtype units vec smem, stream
    "rq_transform_quant_down": (_I, [_P] * 8 + [_L, _L, _I, _I] + [_I] * 4
                                + [_P]),
}
_DTYPE = {torch.float32: 0, torch.bfloat16: 1}


class UpPlan(NamedTuple):
    """"up": one cluster of ``cluster`` CTAs per band of ``group`` rows; CTA
    c owns source and output columns [c·slice, (c+1)·slice); sub-bands of
    ``rows`` rows; a thread per source column. ``passes`` 1: each thread
    holds its column's group in registers and w is read once; 2: the
    statistics first, then the codes sub-band by sub-band."""
    cluster: int
    slice: int
    rows: int
    passes: int
    threads: int
    smem: int
    grid: int


class DownPlan(NamedTuple):
    """"down": one CTA per (group, tile of ``units`` · ``vec`` columns),
    DOWN_THREADS threads = ``units`` column units × ``slices`` row
    slices; ``vec`` is the values of one 16-byte copy (4 f32, 8 bf16) or
    1."""
    units: int
    vec: int
    slices: int
    tiles: int
    smem: int
    grid: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def up_smem(slice_: int, rows: int) -> int:
    """Bytes of the "up" CTA's shared memory: its slice's codes of a
    sub-band (a byte per value, rows rounded up to 16 per column), a scale
    and zero per column and pi of its output columns."""
    return slice_ * (16 * -(-rows // 16) + 12)


def down_smem(group: int, units: int, vec: int, esize: int = 4) -> int:
    """Bytes of the "down" CTA's shared memory: source and partner rows of
    the tile (``esize`` bytes a value), per-slice f32 min/max, and cos,
    sin, scale and source row per group row."""
    tw = units * vec
    return (esize * 2 * group * tw
            + 4 * (2 * (DOWN_THREADS // units) * tw + 4 * group))


def _plan_up(d: int, f: int, group: int) -> UpPlan:
    bands = d // group
    want = min(PORTABLE_CLUSTER, _pow2_ceil(-(-f // MIN_SLICE)))
    clusters = [c for c in (1, 2, 4, 8) if c >= want] + [16]
    divisors = [r for r in range(group, 0, -1) if group % r == 0]
    for cluster in clusters:
        slice_ = _round_up(-(-f // cluster), 2)
        rows = next((r for limit in (UP_SMEM, SMEM_MAX) for r in divisors
                     if up_smem(slice_, r) <= limit), None)
        if rows is None:
            continue
        per = -(-slice_ // UP_THREADS)      # columns per thread
        threads = _round_up(-(-slice_ // per), 32)
        grid = bands * cluster
        if grid > MAX_GRID_X:
            break
        passes = 1 if rows == group and group <= UP_HOLD_ROWS else 2
        return UpPlan(cluster, slice_, rows, passes, threads,
                      up_smem(slice_, rows), grid)
    raise ValueError(f"transform_quant up: no cluster of at most 16 CTAs "
                     f"holds a band of w ({d}, {f}) at group {group} within "
                     f"{SMEM_MAX} bytes of shared memory per CTA and a grid "
                     f"of at most {MAX_GRID_X} blocks")


def _plan_down(f: int, n: int, group: int, esize: int) -> DownPlan:
    vec = 16 // esize if n % (16 // esize) == 0 else 1
    units = DOWN_UNITS
    while units > 1 and down_smem(group, units, vec, esize) > DOWN_SMEM:
        units //= 2
    smem = down_smem(group, units, vec, esize)
    tiles = -(-n // (units * vec))
    grid = f // group * tiles
    if smem > SMEM_MAX or grid > MAX_GRID_X:
        raise ValueError(f"transform_quant down: a group of {group} rows of "
                         f"w ({f}, {n}) needs {smem} bytes of shared memory "
                         f"per CTA (at most {SMEM_MAX}) and {grid} blocks "
                         f"(at most {MAX_GRID_X})")
    return DownPlan(units, vec, DOWN_THREADS // units, tiles, smem, grid)


@functools.lru_cache(maxsize=1024)
def plan(K: int, N: int, group: int, mode: str, esize: int = 4):
    """The launch of ``transform_quant`` on w (K, N) of ``esize``-byte
    values (4 f32, 2 bf16) at ``group``: an
    :class:`UpPlan` ("up", w (D, F) = (K, N)) or a :class:`DownPlan`
    ("down", w (F, D) = (K, N)). Raises ``ValueError`` for a shape no plan
    takes.

    "up" takes the smallest power-of-two cluster (at most the portable 8)
    whose slices are at least MIN_SLICE columns, then the largest sub-band
    height dividing ``group`` whose codes fit UP_SMEM bytes (else a whole
    CTA's shared memory); only when no height fits at 8 does it take a
    non-portable cluster of 16.
    "down" takes the widest tile (at most DOWN_UNITS units of one 16-byte
    copy's columns, or of 1 column when N is not a multiple of them) within
    DOWN_SMEM bytes."""
    if esize not in (2, 4):
        raise ValueError(f"esize must be 4 (f32) or 2 (bf16), got {esize}")
    if mode not in MODES:
        raise ValueError(f"mode must be 'up' or 'down', got {mode!r}")
    if group <= 0 or K % group:
        raise ValueError(f"K={K} must be a positive multiple of group={group}")
    if mode == "up":
        if N % 2:
            raise ValueError(f"transformed axis f={N} must be even")
        return _plan_up(K, N, group)
    if K % 2:
        raise ValueError(f"transformed axis f={K} must be even")
    return _plan_down(K, N, group, esize)


def launch(w, pi, svec, cos, sin, fq, scale, zero, *, bits: int, group: int,
           mode: str, plan) -> None:
    """fq, scale, zero <- fake-quant of the (pi, svec, cos/sin)-transformed
    w (K, N) (f32 or bf16; fq the same) by ``plan`` (from :func:`plan` at
    w's element size); ``svec`` is s for "up" and 1/s for "down". Raises if
    the launch is refused."""
    lib = build.load("transform_quant", _SIG)
    K, N = w.shape
    ptrs = (w.data_ptr(), pi.data_ptr(), svec.data_ptr(), cos.data_ptr(),
            sin.data_ptr(), fq.data_ptr(), scale.data_ptr(), zero.data_ptr())
    stream = torch.cuda.current_stream(w.device).cuda_stream
    dt = _DTYPE[w.dtype]
    if mode == "up":
        rc = lib.rq_transform_quant_up(
            *ptrs, K, N, group, bits, dt, plan.cluster, plan.slice,
            plan.rows, plan.threads, plan.smem, stream)
    else:
        rc = lib.rq_transform_quant_down(
            *ptrs, K, N, group, bits, dt, plan.units, plan.vec, plan.smem,
            stream)
    if rc != 0:
        raise RuntimeError(
            f"transform_quant {mode} kernel launch failed: CUDA error {rc}")
