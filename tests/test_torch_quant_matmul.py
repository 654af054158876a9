"""Port parity: ``quant_matmul`` (x @ dequant(packed W)) and its plain
version vs the JAX reference.

The same numpy weights are packed by the reference's ``quantize_tensor``
and carried across (uint32 words viewed as int32). On a CPU tensor
``kernels.quant_matmul`` runs its plain version; it is held to the
reference's ``quant_matmul`` (its Pallas kernel in interpret mode where the
shape tiles, its oracle elsewhere) and to ``quant_matmul_ref`` at
rtol = atol = 5e-4, the bar of ``tests/test_kernels.py``. The CUDA
kernel's split-K planner is held here too, with the decomposition it sums.
"""
import importlib
import importlib.util
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.kernels as tkernels
from helpers.torch_parity import one_torch_thread, to_np  # noqa: F401
from repro.core.quant import QuantConfig as JQuantConfig
from repro.core.quant import quantize_tensor as jquantize_tensor
from repro.kernels import quant_matmul as jquant_matmul
from repro.kernels.ref import dequant_ref as jdequant_ref
from repro.kernels.ref import quant_matmul_ref as jquant_matmul_ref
from repro_torch.core.quant import QuantConfig, quantize_tensor
from repro_torch.kernels import ref as tref

pytestmark = pytest.mark.usefixtures("one_torch_thread")
TOL = dict(rtol=5e-4, atol=5e-4)
SHAPES_MM = [(8, 128, 128), (16, 256, 256), (32, 512, 128), (8, 128, 384)]


def _case(M, K, N, bits, group, seed):
    """numpy x, w; the reference's packed QTensor; the port's tensors."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((K, N)).astype(np.float32)
    x = rng.standard_normal((M, K)).astype(np.float32)
    qt = jquantize_tensor(jnp.asarray(w), JQuantConfig(bits=bits,
                                                       group_size=group))
    port = (torch.from_numpy(np.asarray(qt.packed).view(np.int32).copy()),
            torch.from_numpy(np.asarray(qt.scale).copy()),
            torch.from_numpy(np.asarray(qt.zero).copy()))
    return x, w, qt, port


@pytest.mark.parametrize("bits,group", [(2, 64), (2, 128), (4, 64), (8, 32),
                                        (3, 32)])
@pytest.mark.parametrize("M,K,N", SHAPES_MM)
def test_quant_matmul_sweep_matches_reference(bits, group, M, K, N):
    if K % group:
        pytest.skip("group must divide K (as the reference sweep)")
    x, _, qt, port = _case(M, K, N, bits, group, seed=M * K + N + bits)
    got = to_np(tkernels.quant_matmul(torch.from_numpy(x), *port, bits=bits,
                                      group=group))
    jx = jnp.asarray(x)
    np.testing.assert_allclose(got, np.asarray(jquant_matmul(
        jx, qt.packed, qt.scale, qt.zero, bits=bits, group=group)), **TOL)
    np.testing.assert_allclose(got, np.asarray(jquant_matmul_ref(
        jx, qt.packed, qt.scale, qt.zero, bits, group)), **TOL)


@pytest.mark.parametrize("bits", range(1, 9))
def test_quant_matmul_every_width_with_padding(bits):
    """Bits 1-8 at K = 96, M = 7, N = 100: 3- and 6-bit words pad K to a
    multiple of lcm(group, 32 // bits); M and N off the reference kernel's
    tiling (its wrapper falls back to the oracle there)."""
    M, K, N, group = 7, 96, 100, 32
    x, _, qt, port = _case(M, K, N, bits, group, seed=bits)
    k_pad = port[0].shape[0] * (32 // bits)
    assert k_pad % math.lcm(group, 32 // bits) == 0
    assert (k_pad > K) == (bits in (3, 6))
    got = to_np(tkernels.quant_matmul(torch.from_numpy(x), *port, bits=bits,
                                      group=group))
    jx = jnp.asarray(x)
    for want in (jquant_matmul(jx, qt.packed, qt.scale, qt.zero, bits=bits,
                               group=group),
                 jquant_matmul_ref(jx, qt.packed, qt.scale, qt.zero, bits,
                                   group)):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
    # the plain dequant is the reference's, value for value
    np.testing.assert_array_equal(
        to_np(tref.dequant_ref(*port, bits, group, K)),
        np.asarray(jdequant_ref(qt.packed, qt.scale, qt.zero, bits, group,
                                K)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quant_matmul_dtypes(dtype):
    """x in f32 and bf16 (widened to f32 in both packages), output f32."""
    bits, group, M, K, N = 2, 64, 8, 128, 128
    x, _, qt, port = _case(M, K, N, bits, group, seed=0)
    tx = torch.from_numpy(x).to(dtype)
    got = tkernels.quant_matmul(tx, *port, bits=bits, group=group)
    assert got.dtype == torch.float32 and got.shape == (M, N)
    jx = jnp.asarray(to_np(tx)).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
    np.testing.assert_allclose(to_np(got), np.asarray(jquant_matmul(
        jx, qt.packed, qt.scale, qt.zero, bits=bits, group=group)), **TOL)


def test_port_packing_feeds_the_same_product():
    """The port's own ``quantize_tensor`` words give the reference's
    product (packing is bit-exact, so the plain versions agree)."""
    bits, group, M, K, N = 3, 32, 8, 96, 128
    x, w, qt, _ = _case(M, K, N, bits, group, seed=9)
    tq = quantize_tensor(torch.from_numpy(w), QuantConfig(bits=bits,
                                                          group_size=group))
    np.testing.assert_array_equal(to_np(tq.packed),
                                  np.asarray(qt.packed).view(np.int32))
    got = tkernels.quant_matmul(torch.from_numpy(x), tq.packed, tq.scale,
                                tq.zero, bits=bits, group=group)
    np.testing.assert_allclose(to_np(got), np.asarray(jquant_matmul_ref(
        jnp.asarray(x), qt.packed, qt.scale, qt.zero, bits, group)), **TOL)


# ---- the split-K planner and the decomposition the kernel sums ----------

H100_SMS = 132
tqm = importlib.import_module("repro_torch.kernels.quant_matmul")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


QM_SHAPES = _chip_smoke().QM_SHAPES   # the cases chip_smoke.py times


def _words(K, bits, group):
    """Packed word rows of a K-row weight (K padded to lcm(G, vpw))."""
    vpw = 32 // bits
    unit = math.lcm(group, vpw)
    return -(-K // unit) * unit // vpw


@pytest.mark.parametrize("case", QM_SHAPES, ids=[c[0] for c in QM_SHAPES])
def test_planner_fills_a_wave_at_every_timed_case(case):
    """At every shape chip_smoke.py times, the (column tile, run, row tile)
    grid fills one wave of CTAS_PER_SM CTAs per SM as far as whole tiles
    allow, and does not spill into a second; the runs cover every word
    once."""
    _, M, K, N, bits, group = case
    W = _words(K, bits, group)
    sp = tqm.plan(M, N, W, bits, group, H100_SMS)
    tiles = -(-N // tqm.CTA_COLS) * -(-M // tqm.CTA_ROWS)
    wave = tqm.CTAS_PER_SM * H100_SMS
    assert wave - tiles < tiles * sp.n_split <= wave
    assert [w for lo, hi in sp.runs(W) for w in range(lo, hi)] == \
        list(range(W))


@pytest.mark.parametrize("bits", range(1, 9))
@pytest.mark.parametrize("group", [8, 32, 128])
def test_planner_cuts_whole_words_and_groups(bits, group):
    """Over many (M, N, K): runs are whole units covering every word once,
    as many as the wave holds (or as there are units); a unit is whole
    groups and words (lcm(G, vpw) rows) unless whole groups are too few to
    fill the wave, and then one word."""
    vpw = 32 // bits
    group_words = math.lcm(group, vpw) // vpw
    for M in (1, 8, 9, 128):
        for N in (64, 100, 2048, 8192):
            for K in (96, 1024, 2048, 8192):
                W = _words(K, bits, group)
                sp = tqm.plan(M, N, W, bits, group, H100_SMS)
                runs = sp.runs(W)
                assert [w for lo, hi in runs for w in range(lo, hi)] == \
                    list(range(W))
                assert all(lo % sp.unit_words == 0 for lo, _ in runs)
                tiles = -(-N // tqm.CTA_COLS) * -(-M // tqm.CTA_ROWS)
                most = max(1, tqm.CTAS_PER_SM * H100_SMS // tiles)
                assert sp.n_split == min(most, W // sp.unit_words)
                if sp.unit_words == group_words:
                    assert all(lo * vpw % group == 0 for lo, _ in runs)
                else:
                    assert sp.unit_words == 1 and W // group_words < most


@pytest.mark.parametrize("args,match", [
    ((8, 64, 8, 0, 32), "bits"), ((8, 64, 8, 9, 32), "bits"),
    ((8, 64, 8, 2, 48), "multiple of group"), ((8, 64, 8, 2, 0), "group"),
    ((0, 64, 8, 2, 32), "empty"), ((8, 0, 8, 2, 32), "empty"),
    ((65535 * 8 + 1, 64, 8, 2, 32), "row tiles")])
def test_planner_raises_for_what_it_cannot_take(args, match):
    with pytest.raises(ValueError, match=match):
        tqm.plan(*args, H100_SMS)


def _split_k_sum(x, packed, scale, zero, bits, group, sp):
    """The kernel's decomposition on the plain version: each run's partial
    x[:, run rows] @ dequant(W)[run rows] (x zero past K), added in run
    order, as the sum kernel does."""
    vpw = 32 // bits
    W = packed.shape[0]
    w = tref.dequant_ref(packed, scale, zero, bits, group, W * vpw)
    xp = torch.nn.functional.pad(x.float(), (0, W * vpw - x.shape[1]))
    out = None
    for lo, hi in sp.runs(W):
        part = xp[:, lo * vpw:hi * vpw] @ w[lo * vpw:hi * vpw]
        out = part if out is None else out + part
    return out


@pytest.mark.parametrize("sms", [1, H100_SMS], ids=["few-runs", "many-runs"])
@pytest.mark.parametrize("bits", range(1, 9))
def test_split_k_sum_matches_reference(bits, sms):
    """The split-K runs of the planner, summed in the kernel's fixed order,
    give the plain version's and the reference's product at 5e-4, bits
    1-8 (3 and 6 bits pad K); with many runs, runs start inside groups."""
    M, K, N, group = 7, 96, 100, 32
    x, _, qt, port = _case(M, K, N, bits, group, seed=40 + bits)
    sp = tqm.plan(M, N, port[0].shape[0], bits, group, sms)
    if sms == H100_SMS:
        assert sp.n_split > 1
    got = _split_k_sum(torch.from_numpy(x), *port, bits, group, sp)
    np.testing.assert_allclose(to_np(got), to_np(tref.quant_matmul_ref(
        torch.from_numpy(x), *port, bits, group)), **TOL)
    np.testing.assert_allclose(to_np(got), np.asarray(jquant_matmul_ref(
        jnp.asarray(x), qt.packed, qt.scale, qt.zero, bits, group)), **TOL)
