"""Port parity: the serving steps (``repro_torch.serving``) vs the JAX
reference, from the same converted packed params and page pools.

- the paged decode step and the prefill chunk step: logits within 1e-4 and
  pools within 1e-5 (the bars of ``tests/test_paged.py:320-326``), greedy
  tokens equal;
- ``chain_keys`` bytes equal;
- sampling, whose noise is not ``jax.random``'s, by its properties: a cold
  temperature is greedy, the top-k kept set is the reference's, a
  preempted request resumes its stream, duplicate-admit twins draw their
  own streams.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import one_torch_thread, to_np  # noqa: F401
from repro.configs import get_config as jget_config
from repro.core.quant import QuantConfig as JQuantConfig
from repro.models import init_params as jinit_params
from repro.models.model import embed_tokens as jembed
from repro.models.model import lm_head_logits as jlm_head
from repro.models.model import prefill as jprefill
from repro.quantized.qmodel import pack_model as jpack_model
from repro.serving import decode as jdec
from repro.serving import paged_cache as jpc
from repro.serving import prefill as jpre
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.serving import (ContinuousBatcher, PagedKVCache,
                                 PagedRequest, chain_keys)
from repro_torch.serving import decode as tdec
from repro_torch.models.model import prefill as tprefill
from repro_torch.serving import prefill as tpre

pytestmark = pytest.mark.usefixtures("one_torch_thread")
TINY = dict(n_layers=2, d_model=64, d_ff=128, vocab_size=256, n_heads=4)


def _pair(n_kv, kv_dtype="compute", **over):
    kw = {**TINY, "n_kv_heads": n_kv, **over}
    jcfg = dataclasses.replace(jget_config("opt-tiny").reduced(**kw),
                               kv_cache_dtype=kv_dtype)
    tcfg = dataclasses.replace(tget_config("opt-tiny").reduced(**kw),
                               kv_cache_dtype=kv_dtype)
    jpq = jpack_model(jinit_params(jax.random.PRNGKey(0), jcfg),
                      JQuantConfig(bits=2, group_size=32))
    tpq = params_from_numpy(jax.tree.map(np.asarray, jpq), "cpu")
    return jcfg, tcfg, jpq, tpq


@pytest.fixture(scope="module", params=[4, 2], ids=["mha", "gqa"])
def packed(request):
    return _pair(request.param)


def _random_pools(cfg, n_pages, psz, seed):
    """numpy page pools of the cache layout, filled with data."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_layers, n_pages, psz, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    if cfg.kv_cache_dtype == "int8":
        return {"k": rng.integers(-127, 128, shape).astype(np.int8),
                "v": rng.integers(-127, 128, shape).astype(np.int8),
                "k_scale": rng.uniform(1e-3, 2e-2, shape[:-1]
                                       ).astype(np.float32),
                "v_scale": rng.uniform(1e-3, 2e-2, shape[:-1]
                                       ).astype(np.float32)}
    return {"k": rng.standard_normal(shape).astype(np.float32),
            "v": rng.standard_normal(shape).astype(np.float32)}


def _jax_decode_logits(params_q, cfg, tokens, pools, bt, lens):
    """The reference decode step before token selection, assembled from its
    public pieces exactly as ``make_paged_decode_step`` does."""
    h = jembed(params_q, cfg, tokens, lens[:, None])

    def attn(p, x, ps):
        return jdec.paged_attention_block(p, cfg, x, ps, bt, lens)

    def body(carry, xs):
        return jdec.paged_block_body(xs[0], cfg, carry, xs[1], attn)

    h, new = jax.lax.scan(body, h, (params_q["blocks"], pools))
    return jlm_head(params_q, cfg, h, mask_vocab=True), new


def _assert_pools_close(tpools, jpools):
    for key, j in jpools.items():
        np.testing.assert_allclose(to_np(tpools[key]).astype(np.float32),
                                   np.asarray(j, np.float32), rtol=1e-5,
                                   atol=1e-5, err_msg=key)


@pytest.mark.parametrize("kv_dtype", ["compute", "int8"])
def test_decode_step_matches_reference(packed, kv_dtype):
    jcfg, tcfg, jpq, tpq = packed
    jcfg = dataclasses.replace(jcfg, kv_cache_dtype=kv_dtype)
    tcfg = dataclasses.replace(tcfg, kv_cache_dtype=kv_dtype)
    pools = _random_pools(tcfg, n_pages=13, psz=8, seed=3)
    bt = np.arange(1, 13, dtype=np.int32).reshape(3, 4)
    lens = np.asarray([5, 9, 23], np.int32)      # writes at slot 5, 1, 7
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
                               rtol=1e-5, atol=1e-4)
    _assert_pools_close(tnew, jnew)
    # the greedy step selects the same tokens
    jtok, _ = jdec.make_paged_decode_step(jcfg)(
        jpq, jnp.asarray(toks, jnp.int32), jpools, jnp.asarray(bt),
        jnp.asarray(lens))
    tpools = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    ttok, _ = tdec.make_paged_decode_step(tcfg)(
        tpq, torch.from_numpy(toks), tpools, torch.from_numpy(bt),
        torch.from_numpy(lens))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


@pytest.mark.parametrize("psz,plen,chunk_pages,kv_dtype", [
    (4, 3, 2, "compute"),      # sub-page prompt
    (8, 13, 2, "compute"),     # ragged tail
    (4, 21, 4, "compute"),     # many chunks
    (4, 11, 2, "int8"),
])
def test_prefill_chunks_match_reference(packed, psz, plen, chunk_pages,
                                        kv_dtype):
    """Chunked paged prefill over the same pages: the last prompt row's
    logits and every pool leaf (live rows) agree with the reference's."""
    jcfg, tcfg, jpq, tpq = packed
    jcfg = dataclasses.replace(jcfg, kv_cache_dtype=kv_dtype)
    tcfg = dataclasses.replace(tcfg, kv_cache_dtype=kv_dtype)
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
                               rtol=1e-5, atol=1e-4)
    _assert_pools_close(tcache.gather_tokens(ids, plen),
                        jcache.gather_tokens(ids, plen))


@pytest.mark.parametrize("psz,plen,kv_dtype", [
    (4, 3, "compute"),         # sub-page prompt
    (8, 13, "compute"),        # ragged tail
    (4, 11, "int8"),
])
def test_write_prefill_matches_reference(packed, psz, plen, kv_dtype):
    """``PagedKVCache.write_prefill``: a contiguous prefill's cache
    scattered into the same pages leaves every pool leaf (the whole pool)
    at the reference's; the chunked paged prefill writes the same live
    rows (the reference's ``tests/test_paged.py`` acceptance, on the
    port); a cache too shallow or a page list too short raises as there."""
    jcfg, tcfg, jpq, tpq = packed
    jcfg = dataclasses.replace(jcfg, kv_cache_dtype=kv_dtype)
    tcfg = dataclasses.replace(tcfg, kv_cache_dtype=kv_dtype)
    jcache = jpc.PagedKVCache(jcfg, n_pages=16, page_size=psz,
                              max_pages_per_seq=8)
    tcache = PagedKVCache(tcfg, n_pages=16, page_size=psz,
                          max_pages_per_seq=8, device="cpu")
    ids = jcache.allocator.alloc(jcache.pages_for(plen))
    assert tcache.allocator.alloc(len(ids)) == ids
    s_pad = len(ids) * psz
    toks = np.zeros((1, s_pad), np.int32)
    toks[0, :plen] = np.random.default_rng(plen).integers(
        0, tcfg.vocab_size, size=plen)
    _, jkv = jprefill(jpq, jcfg, jnp.asarray(toks), s_pad)
    _, tkv = tprefill(tpq, tcfg, torch.from_numpy(toks.astype(np.int64)),
                      s_pad)
    jcache.write_prefill(ids, jkv, plen)
    tcache.write_prefill(ids, tkv, plen)
    _assert_pools_close(tcache.pools, jcache.pools)
    chunked = PagedKVCache(tcfg, n_pages=16, page_size=psz,
                           max_pages_per_seq=8, device="cpu")
    assert chunked.allocator.alloc(len(ids)) == ids
    tpre.run_prefill_chunks(
        tpre.make_paged_prefill_step(tcfg), tpq, chunked.pools,
        toks[0, :plen], torch.from_numpy(chunked.block_table_row(ids)[None]),
        page_size=psz, chunk_pages=1)
    _assert_pools_close(chunked.gather_tokens(ids, plen),
                        tcache.gather_tokens(ids, plen))
    with pytest.raises(ValueError, match="pages cannot hold"):
        tcache.write_prefill(ids[:-1] or [], tkv, s_pad + psz)
    with pytest.raises(ValueError, match="prefill cache depth"):
        tcache.write_prefill(ids + [15], tkv, plen)


def test_prefill_attention_matches_reference():
    """``paged_prefill_attention`` alone, GQA 2x, chunk at a page-aligned
    offset over pages written by earlier chunks."""
    rng = np.random.default_rng(9)
    B, C, H, Hkv, Dh, psz = 2, 8, 4, 2, 16, 4
    q = rng.standard_normal((B, C, H, Dh)).astype(np.float32)
    pools = {"k": rng.standard_normal((12, psz, Hkv, Dh)).astype(np.float32),
             "v": rng.standard_normal((12, psz, Hkv, Dh)).astype(np.float32)}
    bt = np.asarray([[3, 5, 7, 9, 0], [2, 4, 6, 8, 10]], np.int32)
    got = tpre.paged_prefill_attention(
        torch.from_numpy(q), {k: torch.from_numpy(v) for k, v in pools.items()},
        torch.from_numpy(bt), 8)
    want = jpre.paged_prefill_attention(
        jnp.asarray(q), {k: jnp.asarray(v) for k, v in pools.items()},
        jnp.asarray(bt), jnp.int32(8))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_chain_keys_bytes_equal():
    rng = np.random.default_rng(0)
    for n, psz in ((21, 8), (64, 16), (7, 8), (40, 4)):
        toks = rng.integers(0, 50272, size=n).astype(np.int32)
        assert chain_keys(toks, psz) == jpc.chain_keys(toks, psz)


# ---------------------------------------------------------------------------
# Sampling (held by its properties)
# ---------------------------------------------------------------------------

def test_cold_temperature_and_top1_are_greedy(packed):
    """T -> 0 and top_k = 1 reproduce the greedy step's tokens, which are
    the reference's greedy tokens."""
    jcfg, tcfg, jpq, tpq = packed
    pools = _random_pools(tcfg, n_pages=9, psz=8, seed=4)
    bt = np.arange(1, 9, dtype=np.int32).reshape(2, 4)
    lens = np.asarray([4, 7], np.int32)
    toks = np.asarray([[3], [5]], np.int64)

    def run(step, *extra):
        tp = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
        return step(tpq, torch.from_numpy(toks), tp, torch.from_numpy(bt),
                    torch.from_numpy(lens), *extra)[0]

    greedy = run(tdec.make_paged_decode_step(tcfg))
    per_request = tdec.make_paged_decode_step(tcfg, per_request=True)
    cold = run(per_request, [1, 2], [0, 1], [1e-6, 1e-6], [0, 0])
    top1 = run(per_request, [1, 2], [0, 1], [5.0, 5.0], [1, 1])
    per_seq = run(per_request, [1, 2], [0, 0], [0.0, 0.0], [0, 0])
    for got in (cold, top1, per_seq):
        np.testing.assert_array_equal(got.numpy(), greedy.numpy())
    jtok, _ = jdec.make_paged_decode_step(jcfg)(
        jpq, jnp.asarray(toks, jnp.int32),
        {k: jnp.asarray(v) for k, v in pools.items()}, jnp.asarray(bt),
        jnp.asarray(lens))
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(jtok))


def test_top_k_kept_set_equals_reference():
    logits = np.random.default_rng(1).normal(size=(4, 64)).astype(np.float32)
    logits[2, :5] = logits[2].max()             # ties at the k-th value
    jl, tl = jnp.asarray(logits), torch.from_numpy(logits)
    top_ks = np.asarray([0, 8, 5, 1])
    # the reference's per-row threshold (sample_logits_per_seq)
    srt = jnp.sort(jl, axis=-1)[:, ::-1]
    kth = jnp.take_along_axis(srt, jnp.clip(jnp.asarray(top_ks) - 1, 0, 63)
                              [:, None], axis=-1)
    want = np.where(top_ks[:, None] > 0, np.asarray(jl >= kth), True)
    got = torch.isfinite(tdec.top_k_restrict(tl, torch.from_numpy(top_ks)))
    np.testing.assert_array_equal(got.numpy(), want)
    for k in (1, 5, 8):             # the static sampler's lax.top_k threshold
        kth_k = jax.lax.top_k(jl, k)[0][..., -1:]
        kept = np.asarray(jl >= kth_k)
        for seed in range(4):
            def keys():     # a generator is consumed by its draw
                return [tdec.request_key(seed, b, "cpu") for b in range(4)]
            toks = tdec.sample_logits(tl, keys(), temperature=3.0, top_k=k)
            assert all(kept[b, int(toks[b])] for b in range(4))
            per = tdec.sample_logits_per_seq(tl, keys(), [3.0] * 4, [k] * 4)
            np.testing.assert_array_equal(per.numpy(), toks.numpy())


def test_request_key_depends_on_seed_and_index_only():
    def draw(seed, index):
        return torch.rand(8, generator=tdec.request_key(seed, index, "cpu"))

    a = draw(3, 5)
    assert torch.equal(a, draw(3, 5))
    assert not torch.equal(a, draw(3, 6))
    assert not torch.equal(a, draw(4, 5))


def _serve(tcfg, tpq, reqs, n_pages, page_size=4, max_pages=6, max_batch=3,
           prefix_cache=False):
    cache = PagedKVCache(tcfg, n_pages=n_pages, page_size=page_size,
                         max_pages_per_seq=max_pages, device="cpu")
    b = ContinuousBatcher(tpq, tcfg, cache, max_batch=max_batch,
                          prefix_cache=prefix_cache)
    outs = b.run(reqs)
    assert cache.allocator.num_free == cache.n_pages - cache.allocator.reserved
    return outs, b.stats


@pytest.mark.parametrize("vocab", [256, 250])
def test_preempted_request_resumes_its_stream(vocab):
    """A page-starved pool (preempts) and a roomy one (never) give the same
    sampled streams, also with a padded vocabulary (the admit-time draw
    must use the step's full-width row)."""
    _, tcfg, _, tpq = _pair(4, vocab_size=vocab)

    def reqs():
        rng = np.random.default_rng(1)
        return [PagedRequest(
            prompt=rng.integers(0, vocab, size=n).astype(np.int32),
            max_new=8, temperature=0.7, top_k=12, seed=100 + i)
            for i, n in enumerate((6, 8, 11))]

    starved, st_s = _serve(tcfg, tpq, reqs(), n_pages=7)
    roomy, st_r = _serve(tcfg, tpq, reqs(), n_pages=32)
    assert st_s["evictions"] >= 1 and st_r["evictions"] == 0
    assert starved == roomy
    assert all(0 <= t < vocab for out in starved for t in out)


def test_sampled_twins_draw_their_own_streams(packed):
    """Duplicate-admitted sampling requests share pages and first-token
    logits but sample with their own (seed, index) keys: each equals a solo
    run with its seed."""
    _, tcfg, _, tpq = packed
    p = np.random.default_rng(19).integers(0, 256, size=9).astype(np.int32)
    outs, stats = _serve(tcfg, tpq, [
        PagedRequest(prompt=p.copy(), max_new=4, temperature=0.9, seed=s)
        for s in range(2)], n_pages=20, page_size=8, max_pages=4,
        max_batch=2, prefix_cache=True)
    assert stats["dedup_admits"] == 1 and stats["cow_forks"] >= 1
    assert outs[0] != outs[1]
    for seed, out in enumerate(outs):
        solo, _ = _serve(tcfg, tpq, [PagedRequest(
            prompt=p.copy(), max_new=4, temperature=0.9, seed=seed)],
            n_pages=20, page_size=8, max_pages=4, max_batch=1)
        assert solo[0] == out


def test_obs_counters_equal_stats_and_spans_annotate_the_profiler(packed):
    """The batcher's obs instruments agree with its stats dict (the
    reference bench's reconciliation); ``trace_span(profile=True)`` shows up
    as a ``torch.profiler`` range; the memory report sees the pool."""
    from repro_torch import obs
    from repro_torch.quantized.qmodel import (cache_bytes,
                                              serving_memory_report)
    _, tcfg, _, tpq = packed
    reg = obs.Registry()
    cache = PagedKVCache(tcfg, n_pages=16, page_size=4, max_pages_per_seq=6,
                         device="cpu")
    b = ContinuousBatcher(tpq, tcfg, cache, max_batch=2, prefix_cache=True,
                          registry=reg)
    rng = np.random.default_rng(3)
    p = rng.integers(0, 256, size=9).astype(np.int32)
    reqs = [PagedRequest(prompt=x, max_new=3) for x in (
        p, p.copy(), np.concatenate([p[:8], rng.integers(0, 256, size=3)
                                     ]).astype(np.int32))]
    b.run(reqs)
    st = b.stats
    assert st["dedup_admits"] == 1 and st["prefill_tokens_saved"] > 0
    for name, key in (("serving_prefill_tokens_total", "prefill_tokens"),
                      ("serving_prefill_tokens_saved_total",
                       "prefill_tokens_saved"),
                      ("serving_aliased_pages_total", "aliased_pages"),
                      ("serving_dedup_admits_total", "dedup_admits"),
                      ("serving_cow_forks_total", "cow_forks"),
                      ("serving_decode_steps_total", "steps")):
        assert reg.counter(name).total() == st[key], name
    assert reg.histogram("serving_ttft_seconds").count() == len(reqs)
    assert reg.histogram("serving_tpot_seconds").count() == st["steps"]
    rep = serving_memory_report(tpq, cache.pools)
    assert rep["kv_bytes"] == cache_bytes(cache.pools) == cache.pool_bytes()
    with torch.profiler.profile() as prof:
        with obs.trace_span("serve.test_span", profile=True):
            torch.ones(4).sum()
    assert any(e.name == "serve.test_span" for e in prof.events())
