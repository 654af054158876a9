"""Port parity on the MoE family, continued: both servers, the search over
expert units (``core/search.py::MoEAdapter``), the calibrated methods'
refusal, and the three CLIs with ``--arch phi3.5-moe-42b-a6.6b``.

Configs and weights as in ``tests/test_torch_moe.py`` (phi3.5-moe reduced,
E 4 / top-2; moonshot reduced at E 64 / top-6), carried across from the
reference's ``init_params``. Bars:

- the paged decode step and the prefill chunk step: logits within 1e-4,
  pools within 1e-5 (``tests/test_paged.py``); greedy tokens equal;
- ``PagedServer``'s batcher (sharing off and on) and ``BatchedServer``
  (``use_flash_decode`` off and on): greedy tokens and batcher stats equal
  to the reference's under the same options. MoE capacity is per row and
  depends on the chunk's S, so sharing off and sharing on are NOT held to
  each other: each is held to the reference run with its own options;
- the search under the reference's replayed proposals (8 steps, both
  lanes): the same units drawn, the same accept decisions, losses at the
  engine tests' rtol 1e-5, transforms at atol 1e-7; the two install modes
  ``torch.equal`` to each other.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import one_torch_thread, to_np  # noqa: F401
from repro import search as jsearch
from repro.core import quant as jq
from repro.core import rtn as jrtn
from repro.core import search as jcs
from repro.core.pipeline import quantize_model as jquantize_model
from repro.launch.serve import BatchedServer as JBatchedServer
from repro.launch.serve import PagedServer as JPagedServer
from repro.launch.serve import Request as JRequest
from repro.quantized.qmodel import pack_model as jpack_model
from repro.search.islands import make_island_streams as jstreams
from repro.serving import decode as jdec
from repro.serving import paged_cache as jpc
from repro.serving import prefill as jpre
from repro_torch import search as tsearch
from repro_torch.convert import params_from_numpy
from repro_torch.core import quant as tq
from repro_torch.core import rtn as trtn
from repro_torch.core import search as tcs
from repro_torch.core.pipeline import quantize_model as tquantize_model
from repro_torch.data.calib import calibration_tokens
from repro_torch.launch import search as tsearch_cli
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.search.islands import make_island_streams as tstreams
from repro_torch.serving import PagedKVCache, build_trace
from repro_torch.serving import decode as tdec
from repro_torch.serving import prefill as tpre
from test_torch_dense_archs import _run_both_batchers
from test_torch_moe import MOE_ARCHS, PHI, pair
from test_torch_search import JaxReplay
from test_torch_serving import (_assert_pools_close, _jax_decode_logits,
                                _random_pools)

pytestmark = pytest.mark.usefixtures("one_torch_thread")
IDS = ["phi", "moon"]
STEPS, SEED = 8, 0


@pytest.fixture(scope="module", params=MOE_ARCHS, ids=IDS)
def moe_packed(request):
    jcfg, tcfg, jparams, _ = pair(request.param)
    jpq = jpack_model(jparams, jq.QuantConfig(bits=2, group_size=32))
    return jcfg, tcfg, jpq, params_from_numpy(jax.tree.map(np.asarray, jpq),
                                              "cpu")


# ---------------------------------------------------------------------------
# the paged steps and both servers
# ---------------------------------------------------------------------------

def test_paged_decode_step_matches_reference(moe_packed):
    jcfg, tcfg, jpq, tpq = moe_packed
    pools = _random_pools(tcfg, n_pages=13, psz=8, seed=3)
    bt = np.arange(1, 13, dtype=np.int32).reshape(3, 4)
    lens = np.asarray([5, 9, 23], np.int32)
    toks = np.asarray([[7], [11], [200]], np.int64)
    jpools = {k: jnp.asarray(v) for k, v in pools.items()}
    tpools = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    jl, jnew = _jax_decode_logits(jpq, jcfg, jnp.asarray(toks, jnp.int32),
                                  jpools, jnp.asarray(bt), jnp.asarray(lens))
    tl, tnew = tdec.paged_decode_logits(tpq, tcfg, torch.from_numpy(toks),
                                        tpools, torch.from_numpy(bt),
                                        torch.from_numpy(lens))
    np.testing.assert_allclose(to_np(tl)[..., :tcfg.vocab_size],
                               np.asarray(jl)[..., :jcfg.vocab_size],
                               rtol=1e-4, atol=1e-4)
    _assert_pools_close(tnew, jnew)
    jtok, _ = jdec.make_paged_decode_step(jcfg)(
        jpq, jnp.asarray(toks, jnp.int32), jpools, jnp.asarray(bt),
        jnp.asarray(lens))
    tpools = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    ttok, _ = tdec.make_paged_decode_step(tcfg)(
        tpq, torch.from_numpy(toks), tpools, torch.from_numpy(bt),
        torch.from_numpy(lens))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


@pytest.mark.parametrize("psz,plen,chunk_pages", [(4, 13, 2), (8, 21, 1)])
def test_prefill_chunks_match_reference(moe_packed, psz, plen, chunk_pages):
    """Chunked paged prefill (each chunk routes with its own S, padded tail
    included, as the reference's does): the last row's logits within 1e-4,
    the pools within 1e-5."""
    jcfg, tcfg, jpq, tpq = moe_packed
    prompt = np.random.default_rng(plen).integers(
        0, tcfg.vocab_size, size=plen).astype(np.int32)
    jcache = jpc.PagedKVCache(jcfg, n_pages=16, page_size=psz,
                              max_pages_per_seq=8)
    tcache = PagedKVCache(tcfg, n_pages=16, page_size=psz,
                          max_pages_per_seq=8, device="cpu")
    ids = jcache.allocator.alloc(jcache.pages_for(plen))
    assert tcache.allocator.alloc(len(ids)) == ids
    row = jcache.block_table_row(ids)[None]
    jrow, jcache.pools, jn = jpre.run_prefill_chunks(
        jax.jit(jpre.make_paged_prefill_step(jcfg)), jpq, jcache.pools,
        prompt, jnp.asarray(row), page_size=psz, chunk_pages=chunk_pages)
    trow, _, tn = tpre.run_prefill_chunks(
        tpre.make_paged_prefill_step(tcfg), tpq, tcache.pools, prompt,
        torch.from_numpy(row), page_size=psz, chunk_pages=chunk_pages)
    assert tn == jn
    np.testing.assert_allclose(to_np(trow)[: tcfg.vocab_size],
                               np.asarray(jrow)[: jcfg.vocab_size],
                               rtol=1e-4, atol=1e-4)
    _assert_pools_close(tcache.gather_tokens(ids, plen),
                        jcache.gather_tokens(ids, plen))


@pytest.mark.parametrize("prefix_cache", [False, True], ids=["off", "on"])
def test_paged_server_tokens_match_reference(moe_packed, prefix_cache):
    """A shared 2-page system prefix with ragged tails and one duplicate,
    prefilled one page a chunk: greedy tokens and stats equal to the
    reference batcher's under the same options."""
    rng = np.random.default_rng(7)
    psz = 4
    sys_p = rng.integers(0, 512, size=2 * psz).astype(np.int32)
    prompts = [np.concatenate([sys_p, rng.integers(0, 512, size=n).astype(
        np.int32)]) for n in (3, 7, 1, psz)]
    prompts.append(prompts[0].copy())
    _, stats = _run_both_batchers(
        moe_packed, prompts, 4, n_pages=40, page_size=psz, max_pages=8,
        max_batch=3, prefill_chunk_pages=1, prefix_cache=prefix_cache)
    assert stats["prefill_chunks"] > stats["prefills"]
    if prefix_cache:
        assert stats["prefill_tokens_saved"] > 0


@pytest.mark.parametrize("prefix_cache", [False, True], ids=["off", "on"])
def test_paged_server_on_a_tenant_trace_matches_reference(moe_packed,
                                                          prefix_cache):
    """``PagedServer`` itself over a 4-tenant shared-prefix trace: greedy
    tokens, batcher stats and the sharing report equal to the reference
    server's with the same options."""
    jcfg, tcfg, jpq, tpq = moe_packed
    trace = build_trace(tcfg.vocab_size, n_tenants=4, per_tenant=2,
                        page_size=8, max_new=4)
    kw = dict(max_batch=4, page_size=8, n_pages=64, max_len=64,
              prefix_cache=prefix_cache)
    jserver = JPagedServer(jpq, jcfg, **kw)
    want = jserver.generate([JRequest(**t) for t in trace])
    server = tserve.PagedServer(tpq, tcfg, device="cpu", **kw)
    assert server.generate([tserve.Request(**t) for t in trace]) == want
    assert server.batcher.stats == jserver.batcher.stats
    rep, jrep = server.sharing_report(), jserver.sharing_report()
    for key in ("prefill_tokens", "prefill_tokens_saved", "saved_frac",
                "aliased_pages", "dedup_admits", "cow_forks"):
        assert rep[key] == jrep[key], key


def test_paged_server_preemption_matches_reference(moe_packed):
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 512, size=n).astype(np.int32)
               for n in (6, 8, 11)]
    _, stats = _run_both_batchers(moe_packed, prompts, 8, n_pages=7,
                                  page_size=4, max_pages=6, max_batch=3)
    assert stats["evictions"] >= 1


def test_batched_server_tokens_match_reference(moe_packed):
    jcfg, tcfg, jpq, tpq = moe_packed
    rng = np.random.default_rng(6)
    reqs = [dict(prompt=rng.integers(0, 512, int(n)).astype(np.int32),
                 max_new=int(m)) for n, m in [(5, 4), (11, 6), (3, 5)]]
    want = JBatchedServer(jpq, jcfg, batch_size=2, max_len=64).generate(
        [JRequest(**r) for r in reqs])
    for flash in (False, True):
        server = tserve.BatchedServer(
            tpq, dataclasses.replace(tcfg, use_flash_decode=flash),
            batch_size=2, max_len=64, device="cpu")
        assert server.generate([tserve.Request(**r) for r in reqs]) == want


# ---------------------------------------------------------------------------
# the search over expert units
# ---------------------------------------------------------------------------

def test_moe_adapter_units_and_shapes():
    """``tests/test_search.py:82-102`` and ``tests/test_search_v2.py:77`` on
    the port: L·E units, (L·E, ...) base leaves, unit u = l·E + e, and the
    install reshaping the stack back to (L, E, ...)."""
    jcfg, tcfg, jparams, tparams = pair(PHI)
    ad, jad = tcs.make_adapter(tcfg), jcs.make_adapter(jcfg)
    assert type(ad).__name__ == type(jad).__name__ == "MoEAdapter"
    E, L = tcfg.moe.num_experts, tcfg.n_layers
    assert ad.n_units == jad.n_units == L * E and ad.f_dim == tcfg.d_ff
    base, jbase = ad.base_stack(tparams), jad.base_stack(jparams)
    assert sorted(base) == sorted(jbase) == ["down", "gate", "up"]
    for k in base:
        assert tuple(base[k].shape) == jbase[k].shape
        np.testing.assert_array_equal(to_np(base[k]), np.asarray(jbase[k]))
    u = 1 * E + 2
    moe = tparams["blocks"]["moe"]
    assert torch.equal(base["up"][u], moe["up"][1, 2])
    layer, over = ad.unit_override(u, {"up": base["up"][u]})
    assert layer == 1 and over["moe"]["expert_override"][0] == 2
    fq = ad.quant_stack(base, tq.QuantConfig(2, 32))
    installed = ad.install(tparams, fq)["blocks"]["moe"]
    assert tuple(installed["up"].shape) == tuple(moe["up"].shape)
    assert torch.equal(installed["down"][1, 2], fq["down"][u])
    assert installed["router"] is moe["router"]


def _bases(arch):
    jcfg, tcfg, jparams, tparams = pair(arch)
    jqc, tqc = jq.QuantConfig(2, 32), tq.QuantConfig(2, 32)
    not_ffn = lambda p: p[-1] not in ("up", "gate", "down")  # noqa: E731
    jbase = jrtn.map_quantizable(jparams, lambda w, p: jq.fake_quant(w, jqc),
                                 only=not_ffn)
    tbase = trtn.map_quantizable(tparams, lambda w, p: tq.fake_quant(w, tqc),
                                 only=not_ffn)
    calib = calibration_tokens(jcfg.vocab_size, n_seqs=2, seq_len=32)
    return jcfg, tcfg, jparams, tparams, jbase, tbase, jqc, tqc, calib


@pytest.fixture(scope="module", params=MOE_ARCHS, ids=IDS)
def moe_bases(request):
    return _bases(request.param)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_search_replay_matches_reference(moe_bases, fused):
    """8 steps under the reference's replayed proposals: every step's unit
    is the reference's draw over L·E units, accept decisions equal, losses
    within rtol 1e-5 (no step within 1e-5 of a tie, but a step whose expert
    no calibration slot reaches, which leaves the loss unchanged to the bit
    on both sides), transforms of all L·E units at atol 1e-7."""
    jcfg, tcfg, jparams, tparams, jbase, tbase, jqc, tqc, calib = moe_bases
    jres = jsearch.run(jparams, jbase, jcfg, jqc, jnp.asarray(calib),
                       jcs.SearchConfig(steps=STEPS, seed=SEED,
                                        fused_kernel=fused, log_every=0))
    tres = tsearch.run(tparams, tbase, tcfg, tqc,
                       torch.from_numpy(calib.astype(np.int64)),
                       tcs.SearchConfig(steps=STEPS, seed=SEED,
                                        fused_kernel=fused, log_every=0),
                       proposals=JaxReplay(SEED))
    n_units = tcfg.n_layers * tcfg.moe.num_experts
    jrng, trng = jstreams(SEED, 0)[0], tstreams(SEED, 0, "cpu")[0]
    units = [int(trng.integers(n_units)) for _ in range(STEPS)]
    assert units == [int(jrng.integers(n_units)) for _ in range(STEPS)]
    th, jh = tres.history, jres.history
    assert len(th) == len(jh) == STEPS + 1
    np.testing.assert_allclose(th[0][1:4], jh[0][1:4], rtol=1e-5)
    cur, tcur = jh[0][1], th[0][1]
    for (ts_, tl, tp, ta_, tacc), (js_, jl, jp, ja_, jacc) in zip(th[1:],
                                                                   jh[1:]):
        assert ts_ == js_
        np.testing.assert_allclose([tl, tp, ta_], [jl, jp, ja_], rtol=1e-5)
        if jl == cur:
            # an expert that no calibration slot reaches: the loss is
            # unchanged to the bit on both sides, and the move rejected
            assert tl == tcur and not tacc and not jacc, f"step {js_}"
            continue
        assert abs(jl - cur) >= 1e-5 * abs(jl), f"step {js_}: near tie"
        assert tacc == jacc, f"step {js_}: accept flags differ"
        if jacc:
            cur, tcur = jl, tl
    accepted = {u for u, h in zip(units, th[1:]) if h[4]}
    assert accepted, "no move was accepted"
    assert tres.accept_rate == jres.accept_rate
    for a, b in zip(tres.transforms, jres.transforms):
        assert tuple(a.shape) == b.shape and a.shape[0] == n_units
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=0, atol=1e-7)
    moved = {u for u in range(n_units)
             if not torch.equal(tres.transforms.pi[u],
                                torch.arange(tcfg.d_ff))}
    assert moved <= accepted
    # the searched experts are the only FFN leaves that changed
    got = tres.params_q["blocks"]["moe"]["up"].reshape((n_units,) + tuple(
        tres.params_q["blocks"]["moe"]["up"].shape[2:]))
    fq0 = tq.fake_quant(tbase["blocks"]["moe"]["up"], tqc).reshape(got.shape)
    for u in range(n_units):
        assert torch.equal(got[u], fq0[u]) == (u not in moved), u


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_install_modes_give_identical_histories(moe_bases, fused):
    """The expert override (``install="unit"``: no stack copied) and K full
    stacks (``install="stack"``) give ``torch.equal`` losses and the same
    decisions, K 2."""
    _, tcfg, _, tparams, _, tbase, _, tqc, calib = moe_bases
    res = {}
    for mode in ("unit", "stack"):
        res[mode] = tsearch.run(
            tparams, tbase, tcfg, tqc, torch.from_numpy(calib.astype(np.int64)),
            tcs.SearchConfig(steps=5, seed=3, population=2, fused_kernel=fused,
                             install=mode, log_every=0))
    assert res["unit"].history == res["stack"].history
    for k, v in res["unit"].params_q["blocks"]["moe"].items():
        assert torch.equal(v, res["stack"].params_q["blocks"]["moe"][k]), k


@pytest.mark.parametrize("method", ["gptq", "awq", "omniquant"])
def test_calibrated_methods_refuse_moe_on_both_sides(method):
    jcfg, tcfg, jparams, tparams = pair(PHI)
    calib = calibration_tokens(jcfg.vocab_size, n_seqs=2, seq_len=16)
    with pytest.raises(AssertionError):
        jquantize_model(jparams, jcfg, jq.QuantConfig(2, 32), method=method,
                        calib_tokens=jnp.asarray(calib))
    with pytest.raises(ValueError, match="block_pattern='dense'"):
        tquantize_model(tparams, tcfg, tq.QuantConfig(2, 32), method, calib,
                        device="cpu")


def test_rtn_with_search_runs_through_quantize_model():
    """RTN + the fused search on phi3.5-moe reduced through the pipeline:
    the expert leaves come back (L, E, ...), the search never worsens."""
    jcfg, tcfg, _, tparams = pair(PHI)
    calib = calibration_tokens(jcfg.vocab_size, n_seqs=2, seq_len=32)
    res = tquantize_model(tparams, tcfg, tq.QuantConfig(2, 32), "rtn", calib,
                          tcs.SearchConfig(steps=3, fused_kernel=True,
                                           log_every=0), device="cpu")
    assert res.method == "rtn+invarexplore"
    moe = res.params_q["blocks"]["moe"]
    assert tuple(moe["up"].shape) == tuple(tparams["blocks"]["moe"]["up"].shape)
    assert res.search.final_loss <= res.search.initial_loss
    assert res.search.transforms.pi.shape[0] == \
        tcfg.n_layers * tcfg.moe.num_experts


# ---------------------------------------------------------------------------
# the CLIs with --arch phi3.5-moe-42b-a6.6b (reduced, as the reference's)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("legacy", [False, True], ids=["paged", "legacy"])
def test_serve_cli_runs_the_moe_arch(legacy):
    outs = tserve.main(["--arch", PHI, "--requests", "3", "--max-new", "3",
                        "--metrics-out", ""] + (["--legacy"] if legacy else []),
                       device="cpu")
    assert len(outs) == 3 and all(len(o) == 3 for o in outs)


def test_search_cli_runs_the_moe_arch(tmp_path):
    out = tmp_path / "bench.json"
    assert tsearch_cli.main(["--arch", PHI, "--steps", "2", "--population",
                             "2", "--fused", "--seqs", "2", "--seq-len", "32",
                             "--out", str(out), "--metrics-out", ""],
                            device="cpu") == 0
    assert PHI in out.read_text()


def test_train_cli_takes_a_moe_step():
    params, losses, cfg = ttrain.train(PHI, steps=2, batch=2, seq=32,
                                       log_every=1, device="cpu")
    assert cfg.block_pattern == "moe" and len(losses) == 2
    assert all(np.isfinite(losses))
    assert tuple(params["blocks"]["moe"]["up"].shape) == (
        cfg.n_layers, cfg.moe.num_experts, cfg.d_model, cfg.d_ff)
