"""Port parity: the rest of the search engine (``repro_torch.search``) vs
the JAX reference — sharded calibration, the tabu memory, islands and
migration, stack install, memory sampling, the search metrics and spans,
and the ``launch/search.py`` command line.

Replayed runs feed each port island a proposal source that rebuilds the
reference island's key chain: ``make_island_streams(seed, i)[1]`` as the
island key, ``key, sub = split(key)`` a step, ``candidate_keys(sub, K)``
(``search/engine.py``, ``search/population.py``), and the JAX ``propose``
on the port's current transform. Unit picks and accept uniforms come from
the same host streams on both sides. Every island history must agree at
``rtol=1e-5`` with exact accept flags, away from near ties (|Δ| under
``1e-5·loss``, where fp32 summation order may decide; the seeds here keep
every step clear of one), as ``tests/test_torch_search.py`` holds the
single chain.
"""
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro import search as jsearch
from repro.configs import get_config as jget_config
from repro.core import invariance as jinv
from repro.core import quant as jq
from repro.core import rtn as jrtn
from repro.core import search as jcs
from repro.data.calib import shard_calibration as jshard
from repro.models import model as jmodel
from repro.search import install as jinstall
from repro.search import islands as jislands
from repro.search import tabu as jtabu
from repro.search.population import candidate_keys
from repro_torch import obs as tobs
from repro_torch import search as tsearch
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import invariance as tinv
from repro_torch.core import quant as tq
from repro_torch.core import rtn as trtn
from repro_torch.core import search as tcs
from repro_torch.data.calib import calibration_tokens
from repro_torch.data.calib import shard_calibration as tshard
from repro_torch.launch import search as tlaunch
from repro_torch.search import install as tinstall
from repro_torch.search import islands as tislands
from repro_torch.search import tabu as ttabu

REPO = pathlib.Path(__file__).resolve().parents[1]
TINY = dict(n_layers=2, d_model=64, d_ff=128, vocab_size=256, n_heads=4,
            n_kv_heads=4, max_seq_len=256)
QBITS, GROUP = 2, 32


# ---------------------------------------------------------------------------
# shard_calibration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("n", [1, 2, 3, 6])
def test_shard_calibration_matches_reference(kind, n):
    calib = np.arange(24).reshape(6, 4)
    x = calib if kind == "numpy" else torch.from_numpy(calib)
    got, want = tshard(x, n), jshard(calib, n)
    assert len(got) == len(want) == n
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w)
    if n == 1:
        assert got[0] is x
    if kind == "tensor":               # slices are views, not copies
        assert all(g.data_ptr() == x[i * (6 // n)].data_ptr()
                   for i, g in enumerate(got))


@pytest.mark.parametrize("n", [4, 5])
def test_shard_calibration_ragged_raises(n):
    calib = torch.zeros((6, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="divide"):
        tshard(calib, n)
    with pytest.raises(ValueError, match="divide"):
        jshard(np.zeros((6, 4)), n)


# ---------------------------------------------------------------------------
# tabu memory
# ---------------------------------------------------------------------------

def test_tabu_memory_unit():
    """``tests/test_search_v2.py::test_tabu_memory_unit`` on the port."""
    t = tinv.FFNTransform(torch.arange(8), torch.ones(8), torch.zeros(4))
    b = ttabu.transform_bytes(t)
    mem = ttabu.TabuMemory(capacity=2)
    fp = mem.fingerprint(3, b)
    assert mem.lookup(fp) is None and mem.hits == 0
    mem.record(fp, 1.5, 1.0, 0.5)
    assert mem.lookup(fp) == (1.5, 1.0, 0.5) and mem.hits == 1
    mem.advance(b)
    assert mem.fingerprint(3, b) != fp
    assert mem.lookup(mem.fingerprint(3, b)) is None
    for i in range(4):
        mem.record(mem.fingerprint(i, b), float(i), 0.0, 0.0)
    assert len(mem) == 2
    other = ttabu.TabuMemory()
    other.advance(b)
    before = mem.fingerprint(0, b)
    mem.adopt_digest(other)
    assert mem.fingerprint(0, b) != before


def test_tabu_memory_digests_match_reference():
    """The host logic is the reference's verbatim: the same byte strings
    give the same fingerprints through record/advance/adopt."""
    pieces = [bytes([i]) * (i + 3) for i in range(5)]
    mems = [ttabu.TabuMemory(3), jtabu.TabuMemory(3)]
    donors = [ttabu.TabuMemory(), jtabu.TabuMemory()]
    for m, d in zip(mems, donors):
        d.advance(pieces[4])
        for i, p in enumerate(pieces):
            m.record(m.fingerprint(i, p), float(i), 0.0, 0.0)
            if i == 2:
                m.advance(p)
        m.adopt_digest(d)
    assert mems[0]._digest == mems[1]._digest
    assert list(mems[0]._seen) == list(mems[1]._seen)
    assert mems[0].fingerprint(7, pieces[1]) == mems[1].fingerprint(
        7, pieces[1])


def test_transform_bytes_hashes_host_bytes():
    t = tinv.identity_transform(16, "cpu")
    moved = t._replace(s=t.s.clone().index_fill_(0, torch.tensor([3]), 2.0))
    assert ttabu.transform_bytes(t) == ttabu.transform_bytes(
        tinv.identity_transform(16, "cpu"))
    assert ttabu.transform_bytes(t) != ttabu.transform_bytes(moved)
    assert len(ttabu.transform_bytes(t)) == 16 * 8 + 16 * 4 + 8 * 4


# ---------------------------------------------------------------------------
# islands: streams + migration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("index", [0, 1, 2, 3])
def test_island_host_streams_match_reference(index):
    rng, src = tislands.make_island_streams(7, index, "cpu")
    jrng, _ = jislands.make_island_streams(7, index)
    np.testing.assert_array_equal(rng.integers(24, size=16),
                                  jrng.integers(24, size=16))
    assert rng.random() == jrng.random()
    assert isinstance(src, tinv.NativeProposals)


def test_island_zero_proposals_are_the_single_chain_source():
    t = tinv.identity_transform(64, "cpu")
    pcfg = tinv.ProposalConfig()
    a = tislands.make_island_streams(5, 0, "cpu")[1](t, 2, pcfg)
    b = tinv.NativeProposals(5, "cpu")(t, 2, pcfg)
    c = tislands.make_island_streams(5, 1, "cpu")[1](t, 2, pcfg)
    assert all(torch.equal(x, y) for ca, cb in zip(a, b)
               for x, y in zip(ca, cb))
    assert not torch.equal(a[0].pi, c[0].pi)
    assert tislands.island_seed(5, 1) == int(
        np.random.SeedSequence([5, 1]).generate_state(1, np.uint64)[0])


def _islands(mod, losses):
    out = []
    for i, (cur, best) in enumerate(losses):
        kw = {"proposals": None} if mod is tislands else {"key": None}
        out.append(mod.IslandState(
            index=i, rng=None, transforms=f"t{i}", fq_stack=f"fq{i}",
            current_loss=cur, best_loss=best, best_transforms=f"bt{i}",
            best_fq=f"bfq{i}", **kw))
    return out


@pytest.mark.parametrize("losses", [
    [(1.0, 0.5), (3.0, 2.0)],                 # elite to worst
    [(1.0, 0.5)],                             # a single island
    [(2.0, 0.1), (1.0, 0.5)],                 # the elite is the worst
    [(1.0, 0.5), (0.5, 0.5)],                 # elite not better than dst
    [(1.0, 0.4), (3.0, 0.4), (3.0, 0.2)],     # ties: first min, first max
    [(4.0, 0.2), (2.0, 0.3), (4.0, 0.9)],     # dst keeps its better elite
], ids=["moves", "single", "src-is-dst", "not-better", "ties", "three"])
def test_migrate_matches_reference(losses):
    port, ref = _islands(tislands, losses), _islands(jislands, losses)
    assert tislands.migrate(port) == jislands.migrate(ref)
    for p, r in zip(port, ref):
        assert (p.transforms, p.fq_stack, p.current_loss, p.best_loss,
                p.best_transforms, p.best_fq) == (
            r.transforms, r.fq_stack, r.current_loss, r.best_loss,
            r.best_transforms, r.best_fq)


def test_migrate_moves_elite_to_worst():
    a, b = _islands(tislands, [(1.0, 0.5), (3.0, 2.0)])
    assert tislands.migrate([a, b])
    assert b.current_loss == 0.5 and b.fq_stack == "bfq0"
    assert b.best_loss == 0.5 and b.best_transforms == "bt0"
    assert a.current_loss == 1.0 and a.best_loss == 0.5


# ---------------------------------------------------------------------------
# install helpers
# ---------------------------------------------------------------------------

def _unit_arrays(seed, k=3):
    rng = np.random.default_rng(seed)
    return [{"up": rng.standard_normal((4, 6)).astype(np.float32),
             "down": rng.standard_normal((6, 4)).astype(np.float32),
             "b_up": rng.standard_normal(6).astype(np.float32)}
            for _ in range(k)]


def test_stack_unit_batch_and_tree_bytes_match_reference():
    units = _unit_arrays(0)
    got = tinstall.stack_unit_batch(
        [{k: torch.from_numpy(v) for k, v in u.items()} for u in units])
    want = jinstall.stack_unit_batch(
        [{k: jnp.asarray(v) for k, v in u.items()} for u in units])
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert tinstall.tree_bytes(got) == jinstall.tree_bytes(want)
    assert tinstall.tree_bytes([got, got]) == 2 * jinstall.tree_bytes(want)
    t = tinv.identity_transform(8, "cpu")
    ts = tinstall.stack_unit_batch([t] * 3)
    assert isinstance(ts, tinv.FFNTransform) and ts.pi.shape == (3, 8)
    assert tinstall.tree_bytes(ts) == 3 * (8 * 8 + 8 * 4 + 4 * 4)


def test_tree_install_unit_matches_reference_and_is_fresh():
    units = _unit_arrays(1)
    stack = tinstall.stack_unit_batch(
        [{k: torch.from_numpy(v) for k, v in u.items()} for u in units])
    jstack = jinstall.stack_unit_batch(
        [{k: jnp.asarray(v) for k, v in u.items()} for u in units])
    new = _unit_arrays(2, 1)[0]
    got = tinstall.tree_install_unit(
        stack, 1, {k: torch.from_numpy(v) for k, v in new.items()})
    want = jinstall.tree_install_unit(
        jstack, jnp.int32(1), {k: jnp.asarray(v) for k, v in new.items()})
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
        assert got[k].data_ptr() != stack[k].data_ptr()
    np.testing.assert_array_equal(stack["up"][1].numpy(), units[1]["up"])


# ---------------------------------------------------------------------------
# the engine against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def opt_pair():
    jcfg = jget_config("opt-tiny").reduced(**TINY)
    tcfg = tget_config("opt-tiny").reduced(**TINY)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    calib = calibration_tokens(jcfg.vocab_size, n_seqs=2, seq_len=64)
    jqc = jq.QuantConfig(bits=QBITS, group_size=GROUP)
    tqc = tq.QuantConfig(bits=QBITS, group_size=GROUP)
    not_ffn = lambda p: p[-1] not in ("up", "down")  # noqa: E731
    jbase = jrtn.map_quantizable(jparams, lambda w, p: jq.fake_quant(w, jqc),
                                 only=not_ffn)
    tbase = trtn.map_quantizable(tparams, lambda w, p: tq.fake_quant(w, tqc),
                                 only=not_ffn)
    return dict(jcfg=jcfg, tcfg=tcfg, jparams=jparams, tparams=tparams,
                jbase=jbase, tbase=tbase, jqc=jqc, tqc=tqc,
                calib=calib, tcalib=torch.from_numpy(calib.astype(np.int64)))


def _to_port(c):
    return tinv.FFNTransform(
        torch.from_numpy(np.asarray(c.pi).astype(np.int64)),
        torch.from_numpy(np.array(c.s)), torch.from_numpy(np.array(c.phi)))


def _to_ref(t_u):
    return jinv.FFNTransform(jnp.asarray(t_u.pi.numpy().astype(np.int32)),
                             jnp.asarray(t_u.s.numpy()),
                             jnp.asarray(t_u.phi.numpy()))


_propose = jax.jit(jinv.propose, static_argnums=2)


class IslandReplay:
    """Proposal source replaying one reference island's draws."""

    def __init__(self, seed, index):
        self.key = jislands.make_island_streams(seed, index)[1]
        self.calls = 0

    def __call__(self, t_u, k, pcfg):
        self.calls += 1
        self.key, sub = jax.random.split(self.key)
        jp = jinv.ProposalConfig(**dataclasses.asdict(pcfg))
        jt = _to_ref(t_u)
        return [_to_port(_propose(key, jt, jp))
                for key in candidate_keys(sub, k)]


class ConstReplay:
    """State-deterministic source: every candidate is the reference's
    ``propose`` at ``PRNGKey(7)`` (the reference's ``_ConstProposalAdapter``,
    ``tests/test_search_v2.py``), so an unaccepted state re-proposes the
    same points."""

    def __call__(self, t_u, k, pcfg):
        jp = jinv.ProposalConfig(**dataclasses.asdict(pcfg))
        c = _to_port(_propose(jax.random.PRNGKey(7), _to_ref(t_u), jp))
        return [c] * k


class _JConstAdapter(jcs.DenseFFNAdapter):
    def propose(self, key, t, pcfg):
        del key
        return jinv.propose(jax.random.PRNGKey(7), t, pcfg)


def _compare(th, jh):
    """One island's histories: rtol 1e-5 and exact accept flags."""
    assert len(th) == len(jh)
    cur = jh[0][1]
    np.testing.assert_allclose(th[0][1:4], jh[0][1:4], rtol=1e-5)
    for (ts, tl, tp, ta, tacc), (js, jl, jp, ja, jacc) in zip(th[1:], jh[1:]):
        assert ts == js
        assert abs(jl - cur) >= 1e-5 * abs(jl), (
            f"step {js}: near tie; pick another seed")
        np.testing.assert_allclose([tl, tp, ta], [jl, jp, ja], rtol=1e-5)
        assert tacc == jacc, f"step {js}: accept flags differ"
        if jacc:
            cur = jl


def _runs(op, scfg_kw, *, sources=None, adapter=None):
    jres = jsearch.run(op["jparams"], op["jbase"], op["jcfg"], op["jqc"],
                       jnp.asarray(op["calib"]),
                       jcs.SearchConfig(log_every=0, **scfg_kw),
                       adapter=adapter)
    tres = tsearch.run(op["tparams"], op["tbase"], op["tcfg"], op["tqc"],
                       op["tcalib"], tcs.SearchConfig(log_every=0, **scfg_kw),
                       proposals=sources)
    return tres, jres


def _assert_runs_agree(tres, jres):
    assert len(tres.island_histories) == len(jres.island_histories)
    for th, jh in zip(tres.island_histories, jres.island_histories):
        _compare(th, jh)
    for key in ("migrations", "tabu_hits", "proposals", "uphill_accepts"):
        assert tres.stats[key] == jres.stats[key], key
    np.testing.assert_allclose(tres.final_loss, jres.final_loss, rtol=1e-5)
    np.testing.assert_allclose(tres.initial_loss, jres.initial_loss,
                               rtol=1e-5)
    assert tres.accept_rate == jres.accept_rate
    # the same elite island: its history is the result's
    elite = tres.island_histories.index(tres.history)
    assert jres.island_histories[elite] == jres.history


ISLAND_KW = dict(steps=6, seed=0, population=2, islands=2, migrate_every=3)


@pytest.mark.parametrize("shard_calib", [False, True],
                         ids=["replicated", "shard_calib"])
def test_island_replay_matches_reference(opt_pair, shard_calib):
    kw = dict(ISLAND_KW, shard_calib=shard_calib)
    sources = [IslandReplay(kw["seed"], i) for i in range(2)]
    tres, jres = _runs(opt_pair, kw, sources=sources)
    _assert_runs_agree(tres, jres)
    assert tres.stats["migrations"] > 0, "no migration moved a state"
    assert [s.calls for s in sources] == [kw["steps"]] * 2
    assert tres.stats["shard_calib"] is shard_calib
    l0 = [h[0][1] for h in tres.island_histories]
    assert (l0[0] != l0[1]) is shard_calib


def test_one_island_shard_calib_is_replicated(opt_pair):
    op = opt_pair
    s = tcs.SearchConfig(steps=6, seed=1, population=2, log_every=0)
    runs = [tsearch.run(op["tparams"], op["tbase"], op["tcfg"], op["tqc"],
                        op["tcalib"], dataclasses.replace(s, shard_calib=sc))
            for sc in (False, True)]
    assert runs[1].stats["shard_calib"] is True
    assert runs[0].history == runs[1].history
    assert runs[0].final_loss == runs[1].final_loss


def test_island_zero_is_independent_of_the_island_count(opt_pair):
    op = opt_pair
    s = tcs.SearchConfig(steps=5, seed=2, population=2, log_every=0,
                         migrate_every=0)
    one = tsearch.run(op["tparams"], op["tbase"], op["tcfg"], op["tqc"],
                      op["tcalib"], s)
    two = tsearch.run(op["tparams"], op["tbase"], op["tcfg"], op["tqc"],
                      op["tcalib"], dataclasses.replace(s, islands=2))
    assert two.island_histories[0] == one.history
    assert two.island_histories[1] != one.history
    assert two.stats["proposals"] == 2 * one.stats["proposals"]


# T = 1e-3 at these losses (Δ ≈ 2e-3) accepts some uphill moves, among
# them cached ones: the rebuild path runs
@pytest.mark.parametrize("temperature", [0.0, 1e-3], ids=["greedy", "warm"])
def test_tabu_replay_matches_reference(opt_pair, temperature):
    """The state-deterministic source against the reference's
    ``_ConstProposalAdapter``: the same hits, the same histories."""
    kw = dict(steps=12, seed=0, population=2, n_match_layers=0, tabu=64,
              temperature=temperature, anneal="constant")
    tres, jres = _runs(opt_pair, kw, sources=ConstReplay(),
                       adapter=_JConstAdapter(opt_pair["jcfg"]))
    _assert_runs_agree(tres, jres)
    assert tres.stats["tabu_hits"] > 0
    assert tres.stats["tabu_skips"] > 0
    assert (tres.stats["tabu_rebuilds"] > 0) is (temperature > 0)


def test_tabu_is_transparent_and_deterministic(opt_pair):
    op = opt_pair

    def run(**kw):
        s = tcs.SearchConfig(steps=12, seed=0, population=2, log_every=0,
                             n_match_layers=0, **kw)
        return tsearch.run(op["tparams"], op["tbase"], op["tcfg"], op["tqc"],
                           op["tcalib"], s, proposals=ConstReplay())

    plain, tabu = run(), run(tabu=64)
    assert tabu.stats["tabu_hits"] > 0
    assert tabu.history == plain.history
    for a, b in zip(tabu.transforms, plain.transforms):
        assert torch.equal(a, b)
    # T > 0: cached (rejected) moves may be accepted and rebuilt
    hot = dict(temperature=1e-3, anneal="constant", tabu=64)
    r1, r2 = run(**hot), run(**hot)
    assert r1.history == r2.history
    assert r1.stats["tabu_hits"] == r2.stats["tabu_hits"] > 0
    assert r1.stats["tabu_rebuilds"] > 0, "no cached move was accepted"
    assert r1.final_loss <= r1.initial_loss
    for u in range(r1.transforms.pi.shape[0]):
        assert torch.equal(torch.sort(r1.transforms.pi[u]).values,
                           torch.arange(op["tcfg"].d_ff))
    # the stacks rebuilt from the cache are the accepted transforms': the
    # returned params reproduce the elite loss (CE alone at n_match 0)
    from repro_torch.core.objective import calib_ce
    from repro_torch.models.model import forward
    logits = forward(r1.params_q, op["tcfg"], op["tcalib"])
    np.testing.assert_allclose(
        float(calib_ce(logits, op["tcalib"], op["tcfg"].vocab_size)),
        r1.final_loss, rtol=1e-6)


def test_tabu_with_native_proposals_is_transparent(opt_pair):
    op = opt_pair
    s = tcs.SearchConfig(steps=6, seed=0, population=2, log_every=0)
    plain = tsearch.run(op["tparams"], op["tbase"], op["tcfg"], op["tqc"],
                        op["tcalib"], s)
    tabu = tsearch.run(op["tparams"], op["tbase"], op["tcfg"], op["tqc"],
                       op["tcalib"], dataclasses.replace(s, tabu=64))
    assert tabu.history == plain.history and tabu.stats["tabu_hits"] == 0


@pytest.mark.parametrize("K", [1, 3])
@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_install_modes_give_identical_histories(opt_pair, K, fused):
    op = opt_pair
    s = tcs.SearchConfig(steps=6, seed=3, population=K, log_every=0,
                         fused_kernel=fused, temperature=0.01,
                         anneal="constant")
    res = {m: tsearch.run(op["tparams"], op["tbase"], op["tcfg"], op["tqc"],
                          op["tcalib"], dataclasses.replace(s, install=m))
           for m in ("unit", "stack")}
    assert res["unit"].stats["install"] == "unit"
    assert res["stack"].stats["install"] == "stack"
    assert res["unit"].history == res["stack"].history
    for k in res["unit"].params_q["blocks"]["mlp"]:
        assert torch.equal(res["unit"].params_q["blocks"]["mlp"][k],
                           res["stack"].params_q["blocks"]["mlp"][k])


@pytest.mark.parametrize("kw,err,match", [
    (dict(install="bogus"), ValueError, "install"),
    (dict(measure_memory=True), ValueError, "measure_memory"),
    (dict(tabu=8, mapped=True), ValueError, "tabu"),
    (dict(mapped=True, islands=2), ValueError, "one island per device"),
    (dict(islands=2, shard_calib=True, population=1), None, None),
], ids=["bogus-install", "measure-on-cpu", "tabu-mapped", "mapped", "ok"])
def test_engine_option_guards(opt_pair, kw, err, match):
    op = opt_pair
    s = tcs.SearchConfig(steps=1, log_every=0, **kw)

    def go():
        return tsearch.run(op["tparams"], op["tbase"], op["tcfg"], op["tqc"],
                           op["tcalib"], s)

    if err is None:
        assert len(go().island_histories) == 2
    else:
        with pytest.raises(err, match=match):
            go()


@pytest.mark.parametrize("islands,sources", [(2, 1), (2, 3), (1, 2)])
def test_proposal_sources_must_match_the_islands(opt_pair, islands, sources):
    op = opt_pair
    src = [tinv.NativeProposals(i, "cpu") for i in range(sources)]
    with pytest.raises(ValueError, match="proposal source"):
        tsearch.run(op["tparams"], op["tbase"], op["tcfg"], op["tqc"],
                    op["tcalib"], tcs.SearchConfig(steps=1, log_every=0,
                                                   islands=islands),
                    proposals=src[0] if sources == 1 else src)


# ---------------------------------------------------------------------------
# obs
# ---------------------------------------------------------------------------

def _totals(names):
    reg = tobs.get_registry()
    return {n: reg.counter(n).total() for n in names}


COUNTERS = ("search_proposals_total", "search_accepts_total",
            "search_uphill_accepts_total", "search_migrations_total",
            "search_tabu_hits_total")


def test_registry_deltas_equal_stats(opt_pair, tmp_path):
    op = opt_pair
    before = _totals(COUNTERS)
    sink = tmp_path / "trace.jsonl"
    tobs.set_trace_sink(str(sink))
    try:
        res = tsearch.run(op["tparams"], op["tbase"], op["tcfg"], op["tqc"],
                          op["tcalib"], tcs.SearchConfig(
                              steps=6, seed=0, population=2, islands=2,
                              migrate_every=2, temperature=5.0,
                              anneal="constant", tabu=16, log_every=3),
                          proposals=[ConstReplay(), ConstReplay()])
    finally:
        tobs.set_trace_sink(None)
    after = _totals(COUNTERS)
    delta = {n: after[n] - before[n] for n in COUNTERS}
    accepts = sum(h[4] for hist in res.island_histories for h in hist[1:])
    assert delta == {
        "search_proposals_total": res.stats["proposals"],
        "search_accepts_total": accepts,
        "search_uphill_accepts_total": res.stats["uphill_accepts"],
        "search_migrations_total": res.stats["migrations"],
        "search_tabu_hits_total": res.stats["tabu_hits"]}
    assert res.stats["proposals"] == 6 * 2 * 2
    reg = tobs.get_registry()
    assert reg.gauge("search_objective_best").value() == min(
        h[1] for hist in res.island_histories for h in hist)
    assert reg.gauge("search_temperature").value() == 5.0
    events = [json.loads(line) for line in sink.read_text().splitlines()]
    begins = [e["name"] for e in events if e["ph"] == "B"]
    assert begins.count("search.run") == 1
    assert begins.count("search.step") == 6
    assert begins.count("search.eval") == 12
    run_b = next(e for e in events if e.get("name") == "search.run")
    assert run_b["attrs"] == {"mode": "sequential", "islands": 2,
                              "population": 2}
    inst = [e for e in events if e["ph"] == "i"]
    assert [e["step"] for e in inst] == [3, 6]
    assert set(inst[0]) == {"ph", "name", "ts", "step", "best", "accept",
                            "T", "elapsed_s"}


class _EventSink:
    """An in-memory trace sink: every event the program writes, parsed."""

    def __init__(self):
        self.events = []

    def write(self, line):
        self.events += [json.loads(t) for t in line.splitlines() if t.strip()]

    def flush(self):
        pass


def _span_parents(events):
    """(name, enclosing span names outermost first) of each span begun."""
    stack, out = [], []
    for e in events:
        if e["ph"] == "B":
            out.append((e["name"], tuple(stack)))
            stack.append(e["name"])
        elif e["ph"] == "E":
            assert stack.pop() == e["name"]
    assert not stack
    return out


JOB_LANES = {
    # tabu replays, accepted cached moves and migration
    "sequential": dict(steps=12, seed=0, population=2, islands=2,
                       migrate_every=3, n_match_layers=0, tabu=64,
                       temperature=1e-3, anneal="constant"),
    # one island, one process: the mapped loop without a process group
    "mapped": dict(steps=4, seed=1, population=2, mapped=True,
                   temperature=5.0, anneal="constant"),
}


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _job(op, lane, traced):
    """The lane's run, with the sink and the profiler ranges on
    (``traced``) or off: the result and the spans begun, each with its
    enclosing spans. The sequential lane replays ``ConstReplay`` sources
    through ``search.run``; the mapped one runs the native sources through
    ``quantize_model`` (RTN, then the search)."""
    from repro_torch.core.pipeline import quantize_model
    scfg = tcs.SearchConfig(log_every=0, **JOB_LANES[lane])

    def go():
        if lane == "sequential":
            return tsearch.run(op["tparams"], op["tbase"], op["tcfg"],
                               op["tqc"], op["tcalib"], scfg,
                               proposals=[ConstReplay(), ConstReplay()])
        return quantize_model(op["tparams"], op["tcfg"], op["tqc"],
                              method="rtn", calib_tokens=op["tcalib"],
                              search=scfg, device="cpu").search

    if not traced:
        return go(), []
    sink = _EventSink()
    tobs.set_trace_sink(sink)
    tobs.enable_profiler(True)
    try:
        res = go()
    finally:
        tobs.enable_profiler(False)
        tobs.set_trace_sink(None)
    return res, _span_parents([e for e in sink.events if e["ph"] in "BE"])


@pytest.mark.parametrize("lane", sorted(JOB_LANES))
def test_job_spans_count_and_nest(opt_pair, lane):
    """Each phase of a job opens its span as often as it runs, inside the
    span it belongs to; a tabu replay opens no build, score or sync span;
    and tracing leaves the result bit for bit."""
    res, spans = _job(opt_pair, lane, traced=True)
    plain, _ = _job(opt_pair, lane, traced=False)
    names = [n for n, _ in spans]
    parents = {}
    for n, p in spans:
        parents.setdefault(n, set()).add(p[-1] if p else None)
    # each rank scores its own island: one here
    evals = JOB_LANES[lane]["steps"] * (2 if lane == "sequential" else 1)
    skips = res.stats["tabu_skips"]
    accepts = sum(h[4] for hist in res.island_histories for h in hist[1:])
    assert accepts > 0
    if lane == "sequential":
        assert skips > 0 and res.stats["tabu_rebuilds"] > 0
    top = ["search.setup", "search.run", "search.finish"]
    if lane == "mapped":
        top = ["quantize.base"] + top
    assert [n for n in names if n in top + ["quantize.base"]] == top
    assert names.count("search.eval") == evals
    for n in ("search.build", "search.score", "search.sync"):
        assert names.count(n) == evals - skips, n
        assert parents[n] == {"search.eval"}, n
    assert names.count("search.accept") == accepts
    assert parents["search.accept"] == {"search.step"}
    assert parents["search.eval"] == {"search.step"}
    assert parents["search.step"] == {"search.run"}
    for n in top:
        assert parents[n] == {None}, n
    # the same result, bit for bit, with the sink and the ranges on
    assert res.history == plain.history
    assert res.island_histories == plain.island_histories
    for a, b in zip(res.transforms, plain.transforms):
        assert torch.equal(a, b)
    got, want = _leaves(res.params_q), _leaves(plain.params_q)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_quantize_base_span_once_per_call(opt_pair):
    """Without the search, ``quantize_model`` opens ``quantize.base`` once
    and no search span."""
    from repro_torch.core.pipeline import quantize_model
    op, sink = opt_pair, _EventSink()
    with tobs.trace_to(sink):
        quantize_model(op["tparams"], op["tcfg"], op["tqc"], method="rtn",
                       device="cpu")
    names = [n for n, _ in _span_parents(
        [e for e in sink.events if e["ph"] in "BE"])]
    assert names == ["quantize.base"]


def test_search_metric_names_and_help_match_reference():
    from repro.search.engine import _search_metrics as jmetrics
    from repro_torch.search.engine import _search_metrics as tmetrics
    tm, jm = tmetrics(), jmetrics()
    assert tm.keys() == jm.keys()
    for k in tm:
        assert (tm[k].name, tm[k].help, tm[k].kind) == (
            jm[k].name, jm[k].help, jm[k].kind)


def test_emit_line_matches_reference(tmp_path, capsys):
    fields = dict(step=4, best="7.12345", accept="50.00%", T="0.5",
                  elapsed_s="1.2")
    sink = tmp_path / "e.jsonl"
    tobs.set_trace_sink(str(sink))
    try:
        got = tobs.emit("search", **fields)
    finally:
        tobs.set_trace_sink(None)
    want = jobs.emit("search", _print=False, **fields)
    assert got == want == ("[search] step=4 best=7.12345 accept=50.00% T=0.5 "
                           "elapsed_s=1.2")
    assert capsys.readouterr().out == got + "\n"
    ev = json.loads(sink.read_text().splitlines()[-1])
    assert ev["ph"] == "i" and ev["name"] == "search"
    assert {k: ev[k] for k in fields} == fields


def test_module_level_instruments_share_the_default_registry():
    c = tobs.counter("test_search_engine_total", "help")
    assert tobs.get_registry().counter("test_search_engine_total") is c
    assert tobs.gauge("test_search_engine_gauge") is \
        tobs.get_registry().gauge("test_search_engine_gauge")
    assert tobs.histogram("test_search_engine_seconds") is \
        tobs.get_registry().histogram("test_search_engine_seconds")


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv,name", [
    (["--islands", "2", "--population", "2", "--steps", "4", "--fused",
      "--migrate-every", "2"], "search/engine/opt-tinys4p2i2b2g32fused"),
    (["--population", "2", "--steps", "3", "--install", "stack",
      "--objective", "kl", "--tabu", "8"],
     "search/engine/opt-tinys3p2i1b2g32-kl"),
    (["--islands", "2", "--population", "1", "--steps", "2",
      "--shard-calib", "--bits", "3", "--group", "16"],
     "search/engine/opt-tinys2p1i2b3g16"),
], ids=["islands-fused", "stack-kl-tabu", "shard-calib"])
def test_cli_rows_match_reference_names(tmp_path, capsys, argv, name):
    out = tmp_path / "bench.json"
    metrics = tmp_path / "metrics.json"
    assert tlaunch.main(argv + ["--seqs", "2", "--seq-len", "32",
                                "--out", str(out), "--metrics-out",
                                str(metrics)], device="cpu") == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.split(",")[0] == name
    rows = json.loads(out.read_text())
    assert [r["name"] for r in rows] == [name]
    derived = rows[0]["derived"]
    for key in ("proposals_per_sec=", "loss=", "accept=", "migrations=",
                "objective=", "install=", "tabu_hits="):
        assert key in derived
    assert "search_proposals_total" in json.loads(metrics.read_text())


def test_cli_merges_rows_by_name(tmp_path):
    out = tmp_path / "bench.json"
    base = ["--steps", "1", "--population", "1", "--seqs", "2", "--seq-len",
            "16", "--out", str(out), "--metrics-out", ""]
    for argv in (base, base, base + ["--fused"]):
        tlaunch.main(argv, device="cpu")
    assert [r["name"] for r in json.loads(out.read_text())] == [
        "search/engine/opt-tinys1p1i1b2g32",
        "search/engine/opt-tinys1p1i1b2g32fused"]


@pytest.mark.parametrize("extra,err,match", [
    (["--mapped", "--islands", "2"], ValueError, "one island per device"),
    (["--mapped", "--tabu", "4"], ValueError, "tabu"),
    (["--measure-mem"], ValueError, "measure_memory"),
])
def test_cli_guards(tmp_path, extra, err, match):
    with pytest.raises(err, match=match):
        tlaunch.main(["--steps", "1", "--population", "1", "--seqs", "2",
                      "--seq-len", "16", "--out", str(tmp_path / "b.json"),
                      "--metrics-out", ""] + extra, device="cpu")


def _ignored_dirs():
    lines = (REPO / ".gitignore").read_text().splitlines()
    return {ln.strip().rstrip("/") for ln in lines
            if ln.strip() and not ln.startswith(("#", "!"))}


@pytest.mark.parametrize("path", [tobs.DEFAULT_METRICS_PATH,
                                  tlaunch.DEFAULT_OUT],
                         ids=["metrics", "search-out"])
def test_cli_defaults_write_under_an_ignored_directory(path):
    p = pathlib.PurePosixPath(path)
    assert not p.is_absolute()
    assert p.parts[0] in _ignored_dirs()
    assert "artifacts" not in p.parts


def test_cli_defaults_land_under_build(tmp_path, monkeypatch):
    """Both CLIs, run with their default output paths from a directory,
    write only under its ``build/``."""
    from repro_torch.launch import serve as tserve
    monkeypatch.chdir(tmp_path)
    tlaunch.main(["--steps", "1", "--population", "1", "--seqs", "2",
                  "--seq-len", "16"], device="cpu")
    tserve.main(["--requests", "2", "--max-new", "2", "--batch", "2"],
                device="cpu")
    written = sorted(str(p.relative_to(tmp_path))
                     for p in tmp_path.rglob("*") if p.is_file())
    assert written == ["build/bench/BENCH_search.json",
                       "build/obs/metrics.json"]
