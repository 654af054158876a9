"""Port parity: the continuous batcher and the serving entry point
(``repro_torch.serving.ContinuousBatcher``, ``repro_torch.launch.serve``)
vs the JAX reference's, from the same converted packed weights and the
same requests: identical greedy tokens and identical ``stats`` dicts, with
prefix sharing off and on, under page pressure and under the SLO
scheduler's decisions. The JAX batcher compiles per shape, so each module
fixture packs one tiny model per head layout and reuses it.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from helpers.torch_parity import one_torch_thread  # noqa: F401
from repro import serving as js
from repro.configs import get_config as jget_config
from repro.core.quant import QuantConfig as JQuantConfig
from repro.launch.serve import PagedServer as JPagedServer
from repro.launch.serve import Request as JRequest
from repro.models import init_params as jinit_params
from repro.quantized.qmodel import pack_model as jpack_model
from repro_torch import serving as ts
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch.serve import PagedServer as TPagedServer
from repro_torch.launch.serve import Request as TRequest
from repro_torch.launch.serve import main as tserve_main
from repro_torch.models.model import forward as tforward

pytestmark = pytest.mark.usefixtures("one_torch_thread")
TINY = dict(n_layers=2, d_model=64, d_ff=128, vocab_size=256, n_heads=4)


@pytest.fixture(scope="module")
def models():
    """n_kv_heads -> (jcfg, tcfg, jax packed params, port packed params)."""
    out = {}
    for n_kv in (4, 2):
        kw = {**TINY, "n_kv_heads": n_kv}
        jcfg = jget_config("opt-tiny").reduced(**kw)
        tcfg = tget_config("opt-tiny").reduced(**kw)
        jpq = jpack_model(jinit_params(jax.random.PRNGKey(0), jcfg),
                          JQuantConfig(bits=2, group_size=32))
        out[n_kv] = (jcfg, tcfg, jpq,
                     params_from_numpy(jax.tree.map(np.asarray, jpq), "cpu"))
    return out


def _drained(cache):
    return cache.allocator.num_free == cache.n_pages - cache.allocator.reserved


def _both_batchers(model, *, n_pages, page_size, max_pages, kv_dtype=None,
                   scheduler=None, **kw):
    """The reference's and the port's batcher on the same packed weights;
    ``scheduler`` is ``make_scheduler``'s arguments."""
    jcfg, tcfg, jpq, tpq = model
    if kv_dtype:
        jcfg = dataclasses.replace(jcfg, kv_cache_dtype=kv_dtype)
        tcfg = dataclasses.replace(tcfg, kv_cache_dtype=kv_dtype)
    jc = js.PagedKVCache(jcfg, n_pages=n_pages, page_size=page_size,
                         max_pages_per_seq=max_pages)
    tc = ts.PagedKVCache(tcfg, n_pages=n_pages, page_size=page_size,
                         max_pages_per_seq=max_pages, device="cpu")
    return tuple(
        mod.ContinuousBatcher(pq, cfg, c, scheduler=(
            mod.make_scheduler(*scheduler) if scheduler else None), **kw)
        for mod, pq, cfg, c in ((js, jpq, jcfg, jc), (ts, tpq, tcfg, tc)))


def _idx(reqs, req):
    """Position of ``req`` in ``reqs`` by identity (requests hold arrays)."""
    return next(i for i, r in enumerate(reqs) if r is req)


def _requests(mod, prompts, **kw):
    return [mod.PagedRequest(prompt=p.copy(), **kw) for p in prompts]


def _run_both(model, prompts, max_new, **kw):
    jb, tb = _both_batchers(model, **kw)
    jout = jb.run(_requests(js, prompts, max_new=max_new))
    tout = tb.run(_requests(ts, prompts, max_new=max_new))
    assert _drained(tb.cache), "leaked page references after run()"
    assert tout == jout
    assert tb.stats == jb.stats
    return tout, tb


def _port_greedy_oracle(tpq, tcfg, prompt, n):
    """The port's full forward over the packed weights, greedy."""
    seq = list(prompt)
    for _ in range(n):
        logits = tforward(tpq, tcfg, torch.tensor([seq]))
        seq.append(int(torch.argmax(logits[0, -1, : tcfg.vocab_size])))
    return seq[len(prompt):]


def test_gqa_server_matches_reference_and_greedy_oracle(models):
    """``tests/test_paged.py::test_gqa_server_end_to_end_matches_greedy_
    oracle``'s config: chunked GQA prefill + fused GQA paged decode."""
    model = models[2]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, size=n).astype(np.int32)
               for n in (4, 9, 14)]
    outs, tb = _run_both(model, prompts, 4, n_pages=24, page_size=8,
                         max_pages=4, max_batch=2, prefill_chunk_pages=2)
    for p, out in zip(prompts, outs):
        assert out == _port_greedy_oracle(model[3], model[1], p, 4)


@pytest.mark.parametrize("page_size,n_kv", [(8, 4), (4, 4), (8, 2)])
@pytest.mark.parametrize("prefix_cache", [False, True], ids=["off", "on"])
def test_sharing_matches_reference(models, page_size, n_kv, prefix_cache):
    """``tests/test_prefix_cache.py::test_sharing_on_off_token_identical``'s
    prompts (a shared system prefix, ragged tails, one exact duplicate):
    tokens and stats equal the reference's with sharing off and on."""
    rng = np.random.default_rng(7)
    sys_p = rng.integers(0, 256, size=2 * page_size).astype(np.int32)
    tails = [rng.integers(0, 256, size=n).astype(np.int32)
             for n in (3, 7, 1, page_size)]
    prompts = [np.concatenate([sys_p, t]) for t in tails]
    prompts.append(prompts[0].copy())
    _, tb = _run_both(models[n_kv], prompts, 4, n_pages=40,
                      page_size=page_size, max_pages=8, max_batch=3,
                      prefill_chunk_pages=2, prefix_cache=prefix_cache)
    if prefix_cache:
        assert tb.stats["prefill_tokens_saved"] > 0
        assert tb.stats["dedup_admits"] >= 1


def test_eviction_under_page_pressure_matches_reference(models):
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, size=n).astype(np.int32)
               for n in (6, 8, 11)]
    _, tb = _run_both(models[4], prompts, 8, n_pages=7, page_size=4,
                      max_pages=6, max_batch=3)
    assert tb.stats["evictions"] >= 1


def test_int8_pages_match_reference(models):
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, size=6).astype(np.int32)
               for _ in range(3)]
    _run_both(models[4], prompts, 4, n_pages=16, page_size=8, max_pages=4,
              max_batch=2, kv_dtype="int8")


def test_gqa_multipage_route_matches_reference(models):
    """``gqa_pages_per_block=2`` through the whole stack."""
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, 256, size=n).astype(np.int32)
               for n in (5, 17)]
    _run_both(models[2], prompts, 3, n_pages=24, page_size=4, max_pages=8,
              max_batch=2, gqa_pages_per_block=2)


def test_decode_table_is_cut_to_the_live_pages(models):
    """Each decode step gets a block table as wide as the most pages a live
    slot holds, not ``max_pages_per_seq`` (the fused-GQA split planner
    sizes its runs from the width), whose rows start with the slots'
    pages; the tokens stay the greedy oracle's."""
    _, tcfg, _, tpq = models[2]
    cache = ts.PagedKVCache(tcfg, n_pages=24, page_size=4,
                            max_pages_per_seq=16, device="cpu")
    tb = ts.ContinuousBatcher(tpq, tcfg, cache, max_batch=2)
    seen = []
    step = tb.step_fn

    def spy(params, toks, pools, bt, lens):
        held = [s.page_ids for s in tb.slots if s is not None]
        seen.append((tuple(bt.shape), max(len(p) for p in held)))
        for i, s in enumerate(tb.slots):
            if s is not None:
                assert bt[i, :len(s.page_ids)].tolist() == s.page_ids
        assert bool((lens < bt.shape[1] * 4).all())
        return step(params, toks, pools, bt, lens)

    tb.step_fn = spy
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 256, size=n).astype(np.int32) for n in (3, 9)]
    outs = tb.run(_requests(ts, prompts, max_new=6))
    assert seen and all(w == (2, p) for w, p in seen)
    assert max(p for _, p in seen) < 16
    for p, out in zip(prompts, outs):
        assert out == _port_greedy_oracle(tpq, tcfg, p, 6)


# ---------------------------------------------------------------------------
# SLO scheduler: the same decisions as the reference's
# ---------------------------------------------------------------------------

def test_slo_priority_admission_order_matches_reference(models):
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, 256, size=6).astype(np.int32)
               for _ in range(3)]
    order = []
    for mod, b in zip((js, ts), _both_batchers(
            models[4], n_pages=16, page_size=8, max_pages=4, max_batch=1,
            scheduler=("slo",))):
        b.run([mod.PagedRequest(prompt=p.copy(), max_new=2, priority=pr)
               for p, pr in zip(prompts, (0, 2, 1))])
        order.append([r.priority for r in b.done])
    assert order[0] == order[1] == [2, 1, 0]


def test_slo_tenant_quota_gates_admission_like_reference(models):
    rng = np.random.default_rng(29)
    prompts = [rng.integers(0, 256, size=10).astype(np.int32)
               for _ in range(3)]
    live, done = [], []
    for mod, b in zip((js, ts), _both_batchers(
            models[4], n_pages=20, page_size=8, max_pages=4, max_batch=3,
            scheduler=("slo", 3))):
        reqs = [mod.PagedRequest(prompt=p.copy(), max_new=2, tenant=t)
                for p, t in zip(prompts, "aab")]
        for r in reqs:
            b.submit(r)
        b._admit()
        live.append(sorted(_idx(reqs, s.req) for s in b.slots
                           if s is not None))
        while b.queue or any(s is not None for s in b.slots):
            b.step()
        done.append([(_idx(reqs, r), r.out) for r in b.done])
    assert live[0] == live[1] == [0, 2]
    assert done[0] == done[1]


def test_slo_victims_match_reference(models):
    """Lowest priority first, then least progress; among equals the slot
    whose pages are shared (a dedup twin) before one with exclusive pages."""
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, 256, size=6).astype(np.int32)
               for _ in range(3)]
    victims = []
    for mod, b in zip((js, ts), _both_batchers(
            models[4], n_pages=24, page_size=8, max_pages=4, max_batch=3,
            scheduler=("slo",))):
        reqs = [mod.PagedRequest(prompt=p.copy(), max_new=4, priority=pr)
                for p, pr in zip(prompts, (2, 0, 1))]
        for r in reqs:
            b.submit(r)
        b._admit()
        got = [_idx(reqs, b.slots[b.scheduler.pick_victim(b)].req)]
        reqs[1].priority = reqs[2].priority = reqs[0].priority
        reqs[1].out.append(0)
        got.append(_idx(reqs, b.slots[b.scheduler.pick_victim(b)].req))
        victims.append(got)
    assert victims[0] == victims[1] and victims[0][0] == 1

    shared = rng.integers(0, 256, size=17).astype(np.int32)
    lone = rng.integers(0, 256, size=17).astype(np.int32)
    picks = []
    for mod, b in zip((js, ts), _both_batchers(
            models[4], n_pages=24, page_size=8, max_pages=4, max_batch=3,
            scheduler=("slo",), prefix_cache=True)):
        for p in (shared, shared, lone):
            b.submit(mod.PagedRequest(prompt=p.copy(), max_new=4))
        b._admit()
        picks.append(b.scheduler.pick_victim(b))
        assert np.array_equal(b.slots[picks[-1]].req.prompt, shared)
    assert picks[0] == picks[1]


# ---------------------------------------------------------------------------
# PagedServer on the many-tenant trace
# ---------------------------------------------------------------------------

def test_many_tenant_trace_matches_reference(models):
    """``tests/test_prefix_cache.py::test_many_tenant_trace_sharing_
    acceptance`` through the port's ``PagedServer``: sharing off and on
    token-identical, no leaked page, >= 50 % of prefill tokens aliased, and
    the same tokens and sharing report as the reference's server."""
    jcfg, tcfg, jpq, tpq = models[2]
    trace = ts.build_trace(256, n_tenants=8, per_tenant=2, page_size=8,
                           max_new=4)
    jtrace = js.build_trace(256, n_tenants=8, per_tenant=2, page_size=8,
                            max_new=4)
    assert all(np.array_equal(a["prompt"], b["prompt"]) and
               {k: v for k, v in a.items() if k != "prompt"} ==
               {k: v for k, v in b.items() if k != "prompt"}
               for a, b in zip(trace, jtrace))

    def serve(prefix_cache):
        server = TPagedServer(tpq, tcfg, max_batch=4, page_size=8,
                              n_pages=64, max_len=64,
                              prefix_cache=prefix_cache, device="cpu")
        outs = server.generate([TRequest(**t) for t in trace])
        assert _drained(server.cache)
        return outs, server

    outs_off, _ = serve(False)
    outs_on, on = serve(True)
    assert outs_on == outs_off
    rep = on.sharing_report()
    assert rep["saved_frac"] >= 0.5
    assert rep["ttft_p50_s"] > 0 and rep["ttft_p99_s"] >= rep["ttft_p50_s"]
    jserver = JPagedServer(jpq, jcfg, max_batch=4, page_size=8, n_pages=64,
                           max_len=64, prefix_cache=True)
    assert jserver.generate([JRequest(**t) for t in jtrace]) == outs_on
    jrep = jserver.sharing_report()
    for key in ("prefill_tokens", "prefill_tokens_saved", "saved_frac",
                "aliased_pages", "dedup_admits", "cow_forks"):
        assert rep[key] == jrep[key], key
    assert on.batcher.stats == jserver.batcher.stats


def test_serve_main_runs_on_the_cpu(capsys):
    outs = tserve_main(["--requests", "3", "--batch", "2", "--max-new", "3",
                        "--metrics-out", ""], device="cpu")
    assert [len(o) for o in outs] == [3, 3, 3]
    assert "batcher stats" in capsys.readouterr().out
