"""The ``transform_quant`` kernels' launch planner and the decomposition
their "up" design relies on, on the CPU.

``plan`` is pure Python: at every dense FFN shape of the config zoo its
launches must fit the card (shared memory per CTA, cluster size, grid) and
cover every column and row exactly once. The "up" kernel quantises columns
in source order and moves whole quantised columns by π afterwards; that is
exact because a column's group statistics depend only on its source
column, which ``test_up_is_source_order_quant_then_gather`` holds bit for
bit against the plain version. The CUDA kernels themselves are held to the
plain version in ``tests/test_torch_cuda.py``.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import assert_within_one_step, to_np
from repro import kernels as jk
from repro_torch import kernels as tk
from repro_torch.core.invariance import apply_rotation_cols
from repro_torch.kernels import ref as tref

tq = importlib.import_module("repro_torch.kernels.transform_quant")

# every distinct dense FFN shape (d_model, d_ff) of the config zoo
ZOO_FFN = [(2048, 8192), (896, 4864), (2560, 9728), (4096, 6400),
           (2048, 1408), (4096, 11008), (3584, 14336), (1024, 4096),
           (8192, 22528)]
PLAN_CASES = [(mode, d, f, group) for d, f in ZOO_FFN
              for group in (32, 128) for mode in ("up", "down")]
MAX_THREADS = 1024


def _pi(kind, f, rng):
    pi = np.arange(f)
    if kind == "partial":
        idx = rng.choice(f, f // 8, replace=False)
        pi[idx] = rng.permutation(idx)
    elif kind == "random":
        pi = rng.permutation(f)
    elif kind == "dup":
        pi = rng.integers(0, f, f)
    return torch.from_numpy(pi.astype(np.int64))


def _covered(starts_and_stops, n):
    """True when the ranges cover [0, n) exactly once."""
    hits = np.zeros(n, np.int64)
    for lo, hi in starts_and_stops:
        hits[lo:hi] += 1
    return bool(np.all(hits == 1))


@pytest.mark.parametrize("mode,d,f,group", PLAN_CASES)
def test_plan_fits_the_card_and_covers_every_element(mode, d, f, group):
    shape = (d, f) if mode == "up" else (f, d)
    p = tq.plan(*shape, group, mode)
    assert 0 < p.smem <= tq.SMEM_MAX
    assert 0 < p.grid <= tq.MAX_GRID_X
    if mode == "up":
        assert p.cluster in (1, 2, 4, 8, 16)
        assert p.cluster <= tq.PORTABLE_CLUSTER   # no zoo shape needs more
        assert p.smem == tq.up_smem(p.slice, p.rows)
        assert p.grid == d // group * p.cluster
        assert p.threads % 32 == 0 and p.threads <= min(tq.UP_THREADS,
                                                        MAX_THREADS)
        assert p.slice % 2 == 0, "a CTA's slice holds whole rotation pairs"
        # the cluster's slices cover the F columns once, each CTA's threads
        # its slice, the sub-bands the group's rows
        assert _covered([(c * p.slice, min(f, (c + 1) * p.slice))
                         for c in range(p.cluster)], f)
        per = -(-p.slice // p.threads)
        assert _covered([(t + k * p.threads, t + k * p.threads + 1)
                         for t in range(p.threads) for k in range(per)
                         if t + k * p.threads < p.slice], p.slice)
        assert group % p.rows == 0
        assert _covered([(b, b + p.rows) for b in range(0, group, p.rows)],
                        group)
        assert p.passes == (1 if p.rows == group <= tq.UP_HOLD_ROWS else 2)
    else:
        tw = p.units * p.vec
        assert p.units * p.slices == tq.DOWN_THREADS <= MAX_THREADS
        assert p.smem == tq.down_smem(group, p.units, p.vec)
        assert p.grid == f // group * p.tiles
        assert d % p.vec == 0
        assert _covered([(t * tw, min(d, (t + 1) * tw))
                         for t in range(p.tiles)], d)
        per = -(-group // p.slices)
        assert _covered([(min(group, s * per), min(group, s * per + per))
                         for s in range(p.slices)], group)


@pytest.mark.parametrize("K,N,group,mode,match", [
    (64, 1 << 24, 32, "up", "no cluster"),       # a band too wide for 16 CTAs
    (8192, 4096, 8192, "down", "shared memory"),  # a group too tall for a CTA
    (64, 255, 32, "up", "even"),
    (64, 256, 24, "down", "multiple"),
])
def test_plan_raises_for_a_shape_it_cannot_take(K, N, group, mode, match):
    with pytest.raises(ValueError, match=match):
        tq.plan(K, N, group, mode)


UP_CASES = [(d, f, bits, group, kind)
            for d, f, bits, group in [(64, 256, 2, 32), (96, 1408, 3, 32),
                                      (128, 512, 4, 64), (256, 128, 8, 128)]
            for kind in ("identity", "partial", "random", "dup")]


@pytest.mark.parametrize("d,f,bits,group,kind", UP_CASES)
def test_up_is_source_order_quant_then_gather(d, f, bits, group, kind):
    """fake-quant of the rotated, scaled w in SOURCE order, then ``[:, pi]``
    on fq and on scale/zero, equals the plain version bit for bit — for any
    gather index, duplicates included."""
    rng = np.random.default_rng(d + f + bits)
    w = torch.from_numpy(rng.standard_normal((d, f)).astype(np.float32))
    pi = _pi(kind, f, rng)
    s = torch.from_numpy((1.0 + 0.05 * rng.standard_normal(f))
                         .astype(np.float32))
    phi = torch.from_numpy((1e-2 * rng.standard_normal(f // 2))
                           .astype(np.float32))
    u = apply_rotation_cols(w, phi) * s[None, :]
    fq, sc, z = tref.group_quant_ref(u, bits, group)
    want = tref.transform_quant_ref(w, pi, s, phi, bits=bits, group=group,
                                    mode="up")
    for got, ref_out in zip((fq[:, pi], sc[:, pi], z[:, pi]), want):
        torch.testing.assert_close(got, ref_out, rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["up", "down"])
def test_duplicate_index_pi_matches_jax(mode):
    """π keeps ``jnp.take``'s gather semantics: an index vector with
    repeats goes through the port's wrapper as through the JAX kernel
    (``tests/test_torch_kernels.py``'s bar: scale/zero rtol 1e-5, fq within
    one step)."""
    d, f, bits, group = 64, 128, 2, 32
    rng = np.random.default_rng(5)
    w = rng.standard_normal((d, f) if mode == "up" else (f, d)) \
        .astype(np.float32)
    pi = rng.integers(0, f, f)
    s = (1.0 + 0.05 * rng.standard_normal(f)).astype(np.float32)
    phi = (1e-2 * rng.standard_normal(f // 2)).astype(np.float32)
    fq, sc, z = tk.transform_quant(
        torch.from_numpy(w), torch.from_numpy(pi.astype(np.int64)),
        torch.from_numpy(s), torch.from_numpy(phi), bits=bits, group=group,
        mode=mode)
    jfq, jsc, jz = jk.transform_quant(
        jnp.asarray(w), jnp.asarray(pi.astype(np.int32)), jnp.asarray(s),
        jnp.asarray(phi), bits=bits, group=group, mode=mode)
    np.testing.assert_allclose(to_np(sc), to_np(jsc), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(to_np(z), to_np(jz), rtol=1e-5, atol=1e-8)
    assert_within_one_step(fq, jfq, jsc, group)
