"""Binding of the CUDA dequant-matmul kernel (``csrc/quant_matmul.cu``), the
port of the TPU kernel ``repro/kernels/quant_matmul.py``.

:func:`launch` is the raw launch on PyTorch's current stream: the split
pass and, where :func:`plan` splits K, the sum of its partials (their
workspace is allocated here). It counts nothing and checks nothing beyond
what the planner raises for. Callers go through ``kernels.ops.quant_matmul``,
which validates the tensors, allocates the output and counts launches.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.paged_decode import sm_count

__all__ = ["MatmulPlan", "plan", "launch", "CTA_COLS", "CTA_ROWS",
           "CTAS_PER_SM"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# x packed scale zero out ws, M K N W group bits x_dtype n_split
# unit_words, stream
_SIG = {"rq_quant_matmul": (_I, [_P] * 6 + [_I] * 9 + [_P])}
_X_DTYPE = {torch.float32: 0, torch.bfloat16: 1}

CTA_COLS = 128       # columns of N per CTA (csrc/quant_matmul.cu kBN)
CTA_ROWS = 8         # rows of M per CTA (kBM)
CTAS_PER_SM = 2      # split-pass CTAs an SM holds (110-128 registers a
#                      thread, 256 threads): one wave
_MAX_GRID_YZ = 65535


class MatmulPlan(NamedTuple):
    """How K is cut: ``n_split`` runs that share the W / ``unit_words``
    units of the packed words as evenly as whole units allow (run s: units
    [s·U // n_split, (s+1)·U // n_split)). A unit is lcm(G, vpw) rows
    (whole groups and words) where there are enough of those to fill the
    wave, else one word. One CTA per (128 columns, run, 8 rows of M)."""
    unit_words: int
    n_split: int

    def runs(self, W: int):
        """Each run's packed words [lo, hi), in order."""
        U = W // self.unit_words
        return [(s * U // self.n_split * self.unit_words,
                 (s + 1) * U // self.n_split * self.unit_words)
                for s in range(self.n_split)]


@functools.lru_cache(maxsize=1024)
def plan(M: int, N: int, W: int, bits: int, group: int,
         sm_count: int) -> MatmulPlan:
    """The split-K of x (M, K) @ dequant(packed (W, N)), from shapes the
    host has. It cuts K into as many runs as one wave of ``CTAS_PER_SM``
    CTAs per SM holds over the (column tile, row tile) grid, and no more:
    a CTA past the wave would run in a second one, alone, and longer runs
    keep the partials' workspace (n_split · M · N f32, read once by the
    sum) small next to the weights. Raises ValueError for what the kernel
    cannot take."""
    if not 1 <= bits <= 8:
        raise ValueError(f"bits must be in [1, 8], got {bits}")
    vpw = 32 // bits
    k_pad = W * vpw
    if M <= 0 or N <= 0 or W <= 0:
        raise ValueError(f"empty product: M={M}, N={N}, W={W}")
    if group <= 0 or k_pad % group:
        raise ValueError(f"K_pad={k_pad} must be a positive multiple of "
                         f"group={group}")
    m_tiles = -(-M // CTA_ROWS)
    if m_tiles > _MAX_GRID_YZ:
        raise ValueError(f"M={M} needs {m_tiles} row tiles, more than the "
                         f"grid's {_MAX_GRID_YZ}")
    tiles = -(-N // CTA_COLS) * m_tiles
    most = max(1, CTAS_PER_SM * sm_count // tiles)   # runs one wave holds
    # lcm(G, vpw) rows are whole groups and words; it divides K_pad, which
    # is a multiple of both
    group_words = math.lcm(group, vpw) // vpw
    unit = group_words if W // group_words >= most else 1
    return MatmulPlan(unit, min(most, W // unit))


def launch(x, packed, scale, zero, out, *, bits: int, group: int) -> None:
    """out (M, N) <- x (M, K) @ dequant(packed (W, N), scale, zero): the
    split pass and (more than one run) the sum of the runs' partials.
    Raises ValueError for a shape the planner refuses, RuntimeError on a
    CUDA error."""
    lib = build.load("quant_matmul", _SIG)
    M, K = x.shape
    W, N = packed.shape
    sp = plan(M, N, W, bits, group, sm_count(x.device))
    ws = None   # the runs' (M, N) partials, held until the launch is queued
    if sp.n_split > 1:
        ws = torch.empty((sp.n_split, M, N), dtype=torch.float32,
                         device=x.device)
    rc = lib.rq_quant_matmul(
        x.data_ptr(), packed.data_ptr(), scale.data_ptr(), zero.data_ptr(),
        out.data_ptr(), None if ws is None else ws.data_ptr(), M, K, N, W,
        group, bits, _X_DTYPE[x.dtype],
        sp.n_split, sp.unit_words,
        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: CUDA error {rc}")

