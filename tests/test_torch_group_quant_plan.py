"""The ``group_quant`` launch planner (``kernels/group_quant.py::plan``).

The CUDA kernel runs only on the card; its index arithmetic and launch
shape are planned in pure Python (the kernel's own ``make_plan`` follows
the same rules, and the card checks hold the two equal). Here, at every
zoo leaf shape the launch-budget checker lists, at AWQ's per-layer
matrices, per-column groups, the 1-D path (N = 1), ragged N and odd
groups, in f32 and bf16:

- the threads of a CTA (``plan.cells``) cover every (row of the group,
  column vector of the tile) exactly once, one thread a column vector
  writes its scale and zero, and the blocks cover every (group, tile);
- the tile stays within the card's 227 KB of shared memory, the vector
  width divides N and fits a 16-byte access, the rows a thread keeps fit
  its registers when the plan reads w once;
- the planner refuses exactly what ``ops._check_quant_args`` refuses.
"""
import importlib
from collections import Counter

import pytest
import torch

from repro_torch.kernels import ops

gq = importlib.import_module("repro_torch.kernels.group_quant")

# every (K, N) the launch-budget checker lists for group_quant across the
# config zoo (repro_torch.analysis.launch_budget.zoo_kernels, group 32);
# test_zoo_shapes_are_the_checkers holds this list to the checker's rows
ZOO = [(3584, 3584), (3584, 14336), (12288, 1024), (12288, 4096),
       (14336, 3584), (21504, 128), (21504, 896), (21504, 4864),
       (49152, 1024), (49152, 2048), (49152, 8192), (92160, 1024),
       (92160, 4096), (92160, 9728), (98304, 2048), (116736, 896),
       (131072, 512), (131072, 1024), (131072, 4096), (131072, 11008),
       (147456, 2560), (163840, 5120), (196608, 2048), (243712, 7168),
       (327680, 1024), (327680, 2560), (327680, 8192), (327680, 22528),
       (350208, 2560), (352256, 4096), (487424, 3584), (901120, 8192),
       (2097152, 6400), (3276800, 4096), (4325376, 2048), (6291456, 1408)]
# (K, N, group) beyond the zoo's stacks
EDGES = [
    # AWQ's per-layer matrices, one fake_quant a candidate
    (2048, 2048, 32), (2048, 8192, 32), (8192, 2048, 32), (2560, 9728, 32),
    (9728, 2560, 32), (896, 4864, 32), (4864, 896, 32),
    # groups of 64 and 128 (compiled in), other groups (run time)
    (2048, 2048, 64), (2048, 2048, 128), (192, 256, 96), (64, 40, 8),
    (48, 16, 24), (12, 5, 3), (8, 16, 1), (2560, 4096, 20),
    # per-column quantisers (group = K): held, and read twice
    (2048, 2048, 2048), (896, 4864, 896), (2560, 9728, 2560),
    (4096, 4096, 4096), (8192, 16, 8192),
    # the 1-D path, N = 1
    (2048, 1, 32), (2048, 1, 128), (2048, 1, 2048), (24, 1, 3), (40, 1, 8),
    (9728, 1, 9728),
    # N not a multiple of the vector width
    (2048, 4868, 32), (2048, 4870, 32), (384, 37, 64), (64, 6, 32),
]
CASES = [(K, N, 32) for K, N in ZOO] + EDGES
DTYPES = [torch.float32, torch.bfloat16]


def _esize(dtype):
    return torch.empty((), dtype=dtype).element_size()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("K,N,group", CASES)
def test_plan_covers_every_group_and_column_once(K, N, group, dtype):
    p = gq.plan(K, N, group, dtype)
    esize = _esize(dtype)
    assert p.body in gq.BODIES and p.smem <= gq.SMEM_MAX
    assert p.grid == min(p.blocks, gq.MAX_GRID) and p.grid >= 1
    seen, writers, per, teams = Counter(), Counter(), 0, {}
    for t in range(gq.THREADS):
        unit, rows = gq.cells(p, group, t)
        assert rows, f"thread {t} idles"
        per = max(per, len(rows))
        for r in rows:
            seen[(unit, r)] += 1
        if rows[0] == 0:
            writers[unit] += 1
        teams.setdefault(unit, set()).add(t // 32)
    units = p.tile // p.vec
    assert seen == Counter({(u, r): 1 for u in range(units)
                            for r in range(group)})
    assert writers == Counter({u: 1 for u in range(units)})
    assert (per <= p.hold) == (p.passes == 1)
    if p.body == "vector":
        assert N == 1 and p.vec == 1
        groups = K // group
        assert p.blocks * p.tile >= groups > (p.blocks - 1) * p.tile
        assert all(len(w) == 1 for w in teams.values())   # a team, one warp
        return
    assert N > 1 and N % p.vec == 0 and p.vec * esize <= 16
    assert (p.vec == 16 // esize) or N % (2 * p.vec)
    assert (p.body == "fixed") == (group in gq.FIXED_GROUPS
                                   and p.vec == 16 // esize)
    tiles, rest = divmod(p.blocks, K // group)
    assert rest == 0 and tiles * units >= N // p.vec > (tiles - 1) * units
    # the slices of a column vector share a warp unless they span warps
    assert all(len(w) == p.ws for w in teams.values())
    if p.body == "fixed":
        assert p.ws == 1 and p.passes == 1 and per == p.hold
    # a thread holds half, all or (a long group, read once) twice its rows
    assert p.hold in [gq.hold_rows(esize) * k for k in (0.5, 1, 2)]


REFUSALS = [(100, 64, 32), (64, 64, 0), (64, 64, -32), (64, 0, 32),
            (64, -8, 32), (64, gq.MAX_N + 1, 32), (32, 64, 64)]
ACCEPTED = [(64, gq.MAX_N, 32), (32, 1, 32), (96, 8, 96), (1, 1, 1)]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("K,N,group", REFUSALS + ACCEPTED + EDGES)
def test_plan_refuses_exactly_what_the_wrapper_refuses(K, N, group, dtype):
    try:
        ops._check_quant_args(K, N, 2, group)
    except ValueError:
        wrapper = False
    else:
        wrapper = True
    try:
        gq.plan(K, N, group, dtype)
    except ValueError:
        planner = False
    else:
        planner = True
    assert planner == wrapper


def test_zoo_shapes_are_the_checkers():
    from repro_torch.analysis.launch_budget import zoo_kernels
    rows = [r for r in zoo_kernels() if r["kernel"] == "group_quant"]
    assert all(r["ok"] for r in rows)
    assert sorted({(r["K"], r["N"]) for r in rows}) == ZOO
