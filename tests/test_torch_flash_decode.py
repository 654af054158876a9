"""Port parity: ``flash_decode`` (one-token decode attention over a
contiguous KV cache) and the cached self-attention that routes through it,
vs the JAX reference.

- ``kernels.flash_decode`` on a CPU tensor runs its plain version; it is
  held to the reference's Pallas kernel (interpret mode) and to its oracle
  ``flash_decode_ref`` at rtol = atol = 2e-4, the bar of
  ``tests/test_kernels.py``: the sums run in another order.
- ``models.layers.self_attention`` with a cache and ``use_flash_decode``
  against the reference's at a concrete ``cache_index`` (where the
  reference takes its Pallas kernel) at 2e-3, the bar of
  ``tests/test_serve.py``'s flash-decode integration test; compute and int8
  KV, MHA and GQA.
- The CUDA kernel's host side, which the CPU reaches: the split planner
  (the paged routes' plan over ``kv_len`` one-row pages) at every layout
  and context ``chip_smoke.py`` runs, and the arguments the binding hands
  the kernel (with the library stubbed out).
"""
import dataclasses
import importlib
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro_torch.kernels as tkernels
from helpers.torch_parity import one_torch_thread, to_np  # noqa: F401
from repro.configs import get_config as jget_config
from repro.kernels import flash_decode as jflash_decode
from repro.kernels.ref import flash_decode_ref as jflash_decode_ref
from repro.models import layers as jL
from repro.models.model import _single_kv as j_single_kv
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as tL
from repro_torch.models.model import _single_kv as t_single_kv

pytestmark = pytest.mark.usefixtures("one_torch_thread")
TOL = dict(rtol=2e-4, atol=2e-4)


def _qkv(B, S, H, Dh, Hkv=None, seed=0):
    rng = np.random.default_rng(seed)
    Hkv = Hkv or H
    return (rng.standard_normal((B, H, Dh)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32),
            rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("B,S,H,Dh,chunk", [(2, 256, 4, 32, 64),
                                            (1, 512, 2, 64, 128),
                                            (2, 128, 8, 16, 128)])
def test_flash_decode_matches_reference_kernel_and_oracle(B, S, H, Dh, chunk):
    q, k, v = _qkv(B, S, H, Dh, seed=B + S + H)
    got = to_np(tkernels.flash_decode(*_t(q, k, v)))
    want_kernel = jflash_decode(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), chunk=chunk)
    np.testing.assert_allclose(got, np.asarray(want_kernel), **TOL)
    np.testing.assert_allclose(got, np.asarray(jflash_decode_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))), **TOL)


def test_flash_decode_kv_len_mask_and_poisoned_slots():
    """Positions at or past kv_len never count: with the reference's
    poison (50.0) both packages agree with the unpoisoned oracle, and the
    port also with NaN in every masked slot (masked by selection)."""
    q, k, v = _qkv(1, 128, 2, 16, seed=0)
    k2, v2 = k.copy(), v.copy()
    k2[:, 100:] = 50.0
    v2[:, 100:] = 50.0
    want = np.asarray(jflash_decode_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), kv_len=100))
    jgot = np.asarray(jflash_decode(jnp.asarray(q), jnp.asarray(k2),
                                    jnp.asarray(v2), kv_len=100, chunk=32))
    np.testing.assert_allclose(jgot, want, **TOL)
    got = to_np(tkernels.flash_decode(*_t(q, k2, v2), kv_len=100))
    np.testing.assert_allclose(got, want, **TOL)
    k2[:, 100:] = np.nan
    v2[:, 100:] = np.nan
    got = to_np(tkernels.flash_decode(*_t(q, k2, v2), kv_len=100))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)


def test_flash_decode_int8_cache():
    """int8 KV + per-(pos, head) scales vs the reference kernel and its
    explicit-dequant oracle (the reference test's case)."""
    B, S, H, Dh = 2, 256, 4, 32
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, H, Dh)).astype(np.float32)
    kf = rng.standard_normal((B, S, H, Dh)).astype(np.float32)
    vf = rng.standard_normal((B, S, H, Dh)).astype(np.float32)
    ks = (np.abs(kf).max(-1) / 127.0 + 1e-8).astype(np.float32)
    vs = (np.abs(vf).max(-1) / 127.0 + 1e-8).astype(np.float32)
    k8 = np.round(kf / ks[..., None]).astype(np.int8)
    v8 = np.round(vf / vs[..., None]).astype(np.int8)
    got = to_np(tkernels.flash_decode(*_t(q, k8, v8, ks, vs)))
    jargs = [jnp.asarray(a) for a in (q, k8, v8, ks, vs)]
    np.testing.assert_allclose(got, np.asarray(jflash_decode(*jargs,
                                                             chunk=64)), **TOL)
    np.testing.assert_allclose(got, np.asarray(jflash_decode_ref(*jargs)),
                               **TOL)


@pytest.mark.parametrize("kv_dtype", ["compute", "int8"])
def test_flash_decode_gqa_reads_kv_head_directly(kv_dtype):
    """Query head h reads KV head h // (H // Hkv) with no repeated cache:
    equal to the reference kernel on the cache repeated to H heads (what
    the reference's ``_flash_decode_attention`` feeds it)."""
    q, k, v = _qkv(2, 64, 8, 16, Hkv=2, seed=5)
    args, jkv = _t(q, k, v), [k, v]
    if kv_dtype == "int8":
        ks = (np.abs(k).max(-1) / 127.0 + 1e-8).astype(np.float32)
        vs = (np.abs(v).max(-1) / 127.0 + 1e-8).astype(np.float32)
        k8 = np.round(k / ks[..., None]).astype(np.int8)
        v8 = np.round(v / vs[..., None]).astype(np.int8)
        args, jkv = _t(q, k8, v8, ks, vs), [k8, v8, ks, vs]
    got = to_np(tkernels.flash_decode(*args, kv_len=37))
    jrep = [jnp.repeat(jnp.asarray(a), 4, axis=2) for a in jkv]
    want = jflash_decode(jnp.asarray(q), *jrep, kv_len=37, chunk=32)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_flash_decode_empty_cache_is_exactly_zero():
    """kv_len = 0 gives exactly 0 (the reference's oracle would average V
    over the masked positions), as the paged kernels do."""
    q, k, v = _qkv(2, 16, 4, 8, seed=1)
    out = tkernels.flash_decode(*_t(q, k, v), kv_len=0)
    assert out.dtype == torch.float32 and not out.any()


def test_flash_decode_ref_is_paged_decode_ref_over_one_page_per_sequence():
    q, k, v = _qkv(3, 24, 4, 8, Hkv=2, seed=2)
    tq, tk, tv = _t(q, k, v)
    bt = torch.arange(3, dtype=torch.int32)[:, None]
    lens = torch.full((3,), 11, dtype=torch.int32)
    assert torch.equal(tref.flash_decode_ref(tq, tk, tv, kv_len=11),
                       tref.paged_decode_ref(tq, tk, tv, bt, lens))


# ---------------------------------------------------------------------------
# self_attention over a contiguous cache, use_flash_decode on
# ---------------------------------------------------------------------------

def _attn_pair(n_kv, kv_dtype):
    kw = dict(n_layers=2, d_model=64, d_ff=128, vocab_size=256, n_heads=4,
              n_kv_heads=n_kv)
    jcfg = dataclasses.replace(jget_config("opt-tiny").reduced(**kw),
                               kv_cache_dtype=kv_dtype, attn_chunk=32)
    tcfg = dataclasses.replace(tget_config("opt-tiny").reduced(**kw),
                               kv_cache_dtype=kv_dtype, attn_chunk=32)
    jp = jL.init_attn(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture
def flash_spy(monkeypatch):
    """Count the port's calls of ``kernels.flash_decode`` (the wrapper runs
    its plain version on the CPU, which the launch count does not see)."""
    calls = []
    real = tkernels.flash_decode

    def spy(*a, **kw):
        calls.append(kw.get("kv_len"))
        return real(*a, **kw)

    monkeypatch.setattr(tkernels, "flash_decode", spy)
    return calls


@pytest.mark.parametrize("n_kv", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("kv_dtype", ["compute", "int8"])
def test_self_attention_flash_route_matches_reference(n_kv, kv_dtype,
                                                      flash_spy):
    jcfg, tcfg, jp, tp = _attn_pair(n_kv, kv_dtype)
    jcfg_f = dataclasses.replace(jcfg, use_flash_decode=True)
    tcfg_f = dataclasses.replace(tcfg, use_flash_decode=True)
    B, S = 2, 64
    rng = np.random.default_rng(11)
    xs = [(0.3 * rng.standard_normal((B, 1, 64))).astype(np.float32)
          for _ in range(4)]
    jcache = j_single_kv(jcfg, B, S, jnp.float32)
    tcache = t_single_kv(tcfg, B, S, torch.float32, torch.device("cpu"))
    for i, x in enumerate(xs[:3]):     # warm three positions, flag on
        jout, jcache = jL.self_attention(jp, jcfg_f, jnp.asarray(x),
                                         jnp.array([i]), cache=jcache,
                                         cache_index=i)
        tout, tcache = tL.self_attention(tp, tcfg_f, torch.from_numpy(x),
                                         torch.tensor([i]), cache=tcache,
                                         cache_index=i)
        np.testing.assert_allclose(to_np(tout), np.asarray(jout), rtol=2e-3,
                                   atol=2e-3)
    assert flash_spy == [1, 2, 3]
    for key, j in jcache.items():
        np.testing.assert_allclose(to_np(tcache[key]).astype(np.float32),
                                   np.asarray(j, np.float32), rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    # position 3: flag on (the reference's Pallas kernel at a concrete
    # index) and flag off (blocked attention) agree with each other and
    # with the reference
    x = xs[3]
    jout, _ = jL.self_attention(jp, jcfg_f, jnp.asarray(x), jnp.array([3]),
                                cache=jcache, cache_index=3)
    t_on, _ = tL.self_attention(tp, tcfg_f, torch.from_numpy(x),
                                torch.tensor([3]),
                                cache={k: v.clone() for k, v in
                                       tcache.items()}, cache_index=3)
    t_off, _ = tL.self_attention(tp, tcfg, torch.from_numpy(x),
                                 torch.tensor([3]), cache=tcache,
                                 cache_index=3)
    assert flash_spy == [1, 2, 3, 4]
    for got in (t_on, t_off):
        np.testing.assert_allclose(to_np(got), np.asarray(jout), rtol=2e-3,
                                   atol=2e-3)


def test_prefill_sized_calls_never_take_the_flash_route(flash_spy):
    """Only one-token calls route through flash_decode; a multi-token call
    writes its rows and attends causally through blocked attention."""
    jcfg, tcfg, jp, tp = _attn_pair(2, "compute")
    tcfg = dataclasses.replace(tcfg, use_flash_decode=True)
    jcfg = dataclasses.replace(jcfg, use_flash_decode=True)
    x = (0.3 * np.random.default_rng(2).standard_normal((2, 5, 64))
         ).astype(np.float32)
    jout, _ = jL.self_attention(jp, jcfg, jnp.asarray(x), jnp.arange(5),
                                cache=j_single_kv(jcfg, 2, 64, jnp.float32),
                                cache_index=0)
    tout, cache = tL.self_attention(
        tp, tcfg, torch.from_numpy(x), torch.arange(5),
        cache=t_single_kv(tcfg, 2, 64, torch.float32, torch.device("cpu")),
        cache_index=0)
    assert flash_spy == []
    assert not cache["k"][:, 5:].any() and cache["k"][:, :5].any()
    np.testing.assert_allclose(to_np(tout), np.asarray(jout), rtol=2e-3,
                               atol=2e-3)


# ---------------------------------------------------------------------------
# the split planner and the binding's host side
# ---------------------------------------------------------------------------

H100_SMS = 132
tfd = importlib.import_module("repro_torch.kernels.flash_decode")
tpd = importlib.import_module("repro_torch.kernels.paged_decode")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_CS = _chip_smoke()
FD_LAYOUTS = _CS.FD_LAYOUTS       # the layouts chip_smoke.py checks (6a)
FD_CONTEXTS = _CS.FD_CONTEXTS     # the contexts it times (6b)
# n_split at kv_len = S on an H100: only one long sequence splits (its
# CTAs span 32 query heads, or 8 KV heads, against 132 SMs)
SPLIT_AT_S = {"mha": 1, "gqa": 1, "small-gqa": 1, "small-mha": 1,
              "long-mha": 8, "long-gqa": 16, "zamba2": 1}
SPLIT_BY_CONTEXT = {"decode": 1, "long": 1, "long-b1": 8}


def _runs(sp, kv_len):
    """The row ranges [lo, hi) of a plan's runs over kv_len live rows."""
    run = sp.run_pages
    return [(s * run, min((s + 1) * run, kv_len)) for s in range(sp.n_split)]


def test_flash_plan_of_an_empty_cache_is_one_launch_of_empty_ctas():
    """kv_len = 0 plans one run (no division by zero): every CTA finds no
    live row and writes the empty result, which is exactly 0."""
    for B, H, Hkv in ((8, 32, 32), (8, 32, 8), (1, 32, 32), (1, 4, 2)):
        sp = tfd.plan(B, H, Hkv, 0, H100_SMS)
        assert sp.n_split == 1 and sp.run_pages >= 1
        assert _runs(sp, 0) == [(0, 0)]
    assert tpd.plan("paged_decode", 8, 32, 0, 1, 1, H100_SMS).n_split == 1


@pytest.mark.parametrize("layout", FD_LAYOUTS, ids=[c[0] for c in FD_LAYOUTS])
def test_flash_plan_runs_cover_the_live_rows(layout):
    """At kv_len 1, the tile, the first run's end at S (a run boundary),
    ragged and S: runs of whole tiles, none empty, covering each live row
    once, at most one wave of CTAS_PER_SM CTAs per SM, none shorter than
    MIN_RUN_ROWS rows when split."""
    name, B, H, Hkv, _, S = layout
    heads = H if H == Hkv else Hkv
    lens = _CS.flash_lens(tfd, B, H, Hkv, S, H100_SMS)
    assert {1, tfd.TILE_ROWS, S} <= set(lens)
    for kv_len in lens:
        sp = tfd.plan(B, H, Hkv, kv_len, H100_SMS)
        assert sp.run_pages % tfd.TILE_ROWS == 0
        if kv_len:
            runs = _runs(sp, kv_len)
            assert all(lo < hi for lo, hi in runs), (kv_len, runs)
            assert [r for lo, hi in runs for r in range(lo, hi)] == \
                list(range(kv_len))
        if sp.n_split > 1:
            assert B * heads * sp.n_split <= tpd.CTAS_PER_SM * H100_SMS
            assert sp.run_pages >= tpd.MIN_RUN_ROWS


def test_flash_plan_is_sized_by_kv_len_not_by_the_cache(monkeypatch):
    """The live rows size the split: 66 rows of a 128-row or a 2048-row
    cache plan alike (one run), and one sequence splits only once its live
    rows are many."""
    for S in (128, 2048):
        args = _launch_args(monkeypatch, B=8, S=S, H=32, Hkv=32, Dh=64,
                            kv_len=66)
        assert (args["S"], args["n_split"], args["run_rows"]) == (S, 1, 96)
    for kv_len, n_split in ((100, 1), (2048, 8)):
        assert _launch_args(monkeypatch, B=1, S=2048, H=32, Hkv=32, Dh=64,
                            kv_len=kv_len)["n_split"] == n_split


@pytest.mark.parametrize("layout", FD_LAYOUTS, ids=[c[0] for c in FD_LAYOUTS])
def test_flash_plan_at_every_chip_smoke_layout(layout):
    name, B, H, Hkv, _, S = layout
    assert tfd.plan(B, H, Hkv, S, H100_SMS).n_split == SPLIT_AT_S[name]


@pytest.mark.parametrize("ctx", FD_CONTEXTS, ids=[c[0] for c in FD_CONTEXTS])
def test_flash_plan_at_every_timed_context(ctx):
    """6b's contexts: the fixed-slot server's decode shape (66 live rows
    of 128) and B 8 x 2048 stay one launch, B 1 x 2048 splits 8 ways."""
    name, B, S, n = ctx
    n = n or _CS.flash_decode_len(tget_config("opt-1.3b").vocab_size)
    if name == "decode":
        assert (n, S) == (66, 128)
    assert tfd.plan(B, 32, 32, n, H100_SMS).n_split == SPLIT_BY_CONTEXT[name]


_C_ARGS = ("q", "k", "v", "ks", "vs", "out", "ws_acc", "ws_m", "ws_l", "B",
           "H", "Hkv", "Dh", "S", "kv_len", "n_split", "run_rows",
           "tile_rows", "kv_dtype", "quant", "scale", "stream")


def _launch_args(monkeypatch, *, B, S, H, Hkv, Dh, kv_len,
                 dtype=torch.float32, rc=0):
    """The arguments ``flash_decode.launch`` hands ``rq_flash_decode`` for
    CPU tensors of these shapes, with the library, the SM count (an
    H100's) and the stream stubbed out; ``rc`` is what the stub returns."""
    calls = []

    def entry(*a):
        calls.append(dict(zip(_C_ARGS, a, strict=True)))
        return rc

    monkeypatch.setattr(tfd.build, "load", lambda name, sig: SimpleNamespace(
        rq_flash_decode=entry))
    monkeypatch.setattr(tfd, "sm_count", lambda dev: H100_SMS)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: SimpleNamespace(cuda_stream=7))
    q = torch.zeros((B, H, Dh))
    k = torch.zeros((B, S, Hkv, Dh), dtype=dtype)
    scales = [torch.ones((B, S, Hkv))] * 2 if dtype == torch.int8 \
        else [None, None]
    tfd.launch(q, k, k.clone(), *scales, torch.empty((B, H, Dh)),
               kv_len=kv_len)
    (args,) = calls
    return args


def test_flash_launch_hands_the_kernel_the_plan_and_its_workspace(
        monkeypatch):
    one = _launch_args(monkeypatch, B=8, S=128, H=32, Hkv=8, Dh=128,
                       kv_len=66)
    assert one["ws_acc"] is one["ws_m"] is one["ws_l"] is None
    assert (one["tile_rows"], one["kv_dtype"], one["quant"],
            one["stream"]) == (tfd.TILE_ROWS, 0, 0, 7)
    assert one["ks"] is None and abs(one["scale"] - 128 ** -0.5) < 1e-12
    B, H, Dh = 1, 32, 64
    split = _launch_args(monkeypatch, B=B, S=2048, H=H, Hkv=H, Dh=Dh,
                         kv_len=1500, dtype=torch.int8)
    n = split["n_split"] * B * H
    assert split["n_split"] > 1 and split["quant"] == 1
    assert split["kv_dtype"] == 2 and split["ks"] is not None
    assert (split["ws_m"] - split["ws_acc"],
            split["ws_l"] - split["ws_m"]) == (4 * n * Dh, 4 * n)


@pytest.mark.parametrize("rc,err", [(-1, ValueError), (-2, ValueError),
                                    (700, RuntimeError)],
                         ids=["smem", "head-dim", "cuda"])
def test_flash_launch_raises_on_what_the_source_reports(rc, err,
                                                        monkeypatch):
    with pytest.raises(err):
        _launch_args(monkeypatch, B=2, S=64, H=4, Hkv=2, Dh=16, kv_len=10,
                     rc=rc)
