"""Port parity: invariant transforms, RTN and the InvarExplore search
(``repro_torch``) vs the JAX reference.

The search test replays the reference's proposals: a proposal source
rebuilds the engine's key chain (``key, sub = split(key)``;
``candidate_keys(sub, K)``, i.e. ``split(sub)[0]`` at K=1, as
``search/engine.py`` and ``search/population.py`` do) and calls the JAX
``propose`` on the port's current transform. The unit picks come from the
same ``default_rng(seed)`` stream on both sides. Per-step losses must agree
to ``rtol=1e-5`` and the accept flags exactly, up to the first step whose
|Δ| falls under ``1e-5·loss`` (a near tie, where fp32 summation order may
decide); the seed below keeps all 10 steps clear of that.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import assert_within_one_step, to_np
from repro import search as jsearch
from repro.configs import get_config as jget_config
from repro.core import invariance as jinv
from repro.core import quant as jq
from repro.core import rtn as jrtn
from repro.core import search as jcs
from repro.core.pipeline import quantize_model as jquantize_model
from repro.models import model as jmodel
from repro.search.population import candidate_keys
from repro_torch import search as tsearch
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import invariance as tinv
from repro_torch.core import objective as tobj
from repro_torch.core import quant as tq
from repro_torch.core import rtn as trtn
from repro_torch.core import search as tcs
from repro_torch.core.pipeline import quantize_model as tquantize_model
from repro_torch.data.calib import calibration_tokens

TINY = dict(n_layers=2, d_model=64, d_ff=128, vocab_size=256, n_heads=4,
            n_kv_heads=4, max_seq_len=256)
SEED = 0
STEPS = 10


def _rand_transform(f, seed):
    rng = np.random.default_rng(seed)
    return (rng.permutation(f), (1 + 0.05 * rng.standard_normal(f)).astype(
        np.float32), (0.3 * rng.standard_normal(f // 2)).astype(np.float32))


def _pair(pi, s, phi):
    return (jinv.FFNTransform(jnp.asarray(pi.astype(np.int32)),
                              jnp.asarray(s), jnp.asarray(phi)),
            tinv.FFNTransform(torch.from_numpy(pi.astype(np.int64)),
                              torch.from_numpy(s), torch.from_numpy(phi)))


# ---------------------------------------------------------------------------
# invariant transforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inverse", [False, True])
def test_rotations_match_reference(inverse):
    rng = np.random.default_rng(1)
    phi = (0.5 * rng.standard_normal(16)).astype(np.float32)
    rows = rng.standard_normal((32, 8)).astype(np.float32)
    cols = rng.standard_normal((8, 32)).astype(np.float32)
    np.testing.assert_allclose(
        to_np(tinv.apply_rotation_rows(torch.from_numpy(rows),
                                       torch.from_numpy(phi), inverse)),
        to_np(jinv.apply_rotation_rows(jnp.asarray(rows), jnp.asarray(phi),
                                       inverse)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        to_np(tinv.apply_rotation_cols(torch.from_numpy(cols),
                                       torch.from_numpy(phi), inverse)),
        to_np(jinv.apply_rotation_cols(jnp.asarray(cols), jnp.asarray(phi),
                                       inverse)), rtol=0, atol=1e-6)


@pytest.mark.parametrize("gated", [False, True])
def test_apply_transform_ffn_matches_reference(gated):
    D, F = 16, 32
    rng = np.random.default_rng(2)
    ws = {k: rng.standard_normal(shape).astype(np.float32) for k, shape in (
        ("up", (D, F)), ("down", (F, D)), ("b_up", (F,)), ("gate", (D, F)),
        ("b_gate", (F,)))}
    if not gated:
        ws["gate"] = ws["b_gate"] = None
    jt, tt = _pair(*_rand_transform(F, 3))

    def args(conv):
        return [None if ws[k] is None else conv(ws[k])
                for k in ("up", "down", "b_up", "gate", "b_gate")]

    got = tinv.apply_transform_ffn(tt, *args(torch.from_numpy))
    want = jinv.apply_transform_ffn(jt, *args(jnp.asarray))
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_allclose(to_np(g), to_np(w), rtol=0, atol=1e-6)


def test_invert_permutation_matches_reference():
    pi = np.random.default_rng(4).permutation(40)
    got = tinv.invert_permutation(torch.from_numpy(pi))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jinv.invert_permutation(jnp.asarray(pi))))
    np.testing.assert_array_equal(got.numpy()[pi], np.arange(40))


@pytest.mark.parametrize("f", [2, 16, 128, 1000])
def test_native_propose_properties(f):
    """pi stays a permutation and moves at most max(2, round(0.1 F))
    slots; s >= 1e-3; only the masked entries of s and phi move."""
    pcfg = tinv.ProposalConfig()
    gen = torch.Generator().manual_seed(f)
    t = tinv.identity_transform(f, "cpu")
    t = t._replace(s=torch.full((f,), 5e-4))      # exercise the 1e-3 floor
    n_move = max(2, int(round(0.1 * f)))
    n_rot = max(1, int(round(0.1 * (f // 2))))
    for _ in range(5):
        c = tinv.propose(gen, t, pcfg)
        assert torch.equal(torch.sort(c.pi).values, torch.arange(f))
        assert int((c.pi != t.pi).sum()) <= n_move
        assert bool((c.s >= 1e-3).all())
        moved_s = c.s != torch.clamp_min(t.s, 1e-3)
        assert int(moved_s.sum()) <= n_move
        assert int((c.phi != t.phi).sum()) <= n_rot
        assert c.pi.dtype == torch.int64 and c.s.dtype == torch.float32
        t = c


def test_native_proposals_are_seeded():
    t = tinv.identity_transform(64, "cpu")
    a = tinv.NativeProposals(3, "cpu")(t, 2, tinv.ProposalConfig())
    b = tinv.NativeProposals(3, "cpu")(t, 2, tinv.ProposalConfig())
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            assert torch.equal(u, v)
    assert not torch.equal(a[0].pi, a[1].pi)


# ---------------------------------------------------------------------------
# RTN and the search
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def opt_pair():
    jcfg = jget_config("opt-tiny").reduced(**TINY)
    tcfg = tget_config("opt-tiny").reduced(**TINY)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    calib = calibration_tokens(jcfg.vocab_size, n_seqs=2, seq_len=64)
    return jcfg, tcfg, jparams, tparams, calib


def test_quantize_model_rtn_matches_reference(opt_pair):
    jcfg, tcfg, jparams, tparams, _ = opt_pair
    group = 32
    jr = jquantize_model(jparams, jcfg, jq.QuantConfig(bits=2, group_size=group))
    tr = tquantize_model(tparams, tcfg, tq.QuantConfig(bits=2, group_size=group),
                         device="cpu")
    assert tr.method == jr.method == "rtn" and tr.search is None
    paths = jmodel.quantizable_paths(jparams)
    assert len(paths) == 6
    for path in paths:
        jw, tw = jrtn.get_by_path(jr.params_q, path), trtn.get_by_path(
            tr.params_q, path)
        for i in range(jw.shape[0]):
            s, _ = jq.compute_qparams(jrtn.get_by_path(jparams, path)[i],
                                      jq.QuantConfig(bits=2, group_size=group))
            assert_within_one_step(tw[i], jw[i], s, group)
    # non-quantized leaves pass through untouched
    np.testing.assert_array_equal(tr.params_q["blocks"]["mlp"]["b_up"].numpy(),
                                  np.asarray(jparams["blocks"]["mlp"]["b_up"]))


class JaxReplay:
    """Proposal source replaying the reference engine's draws."""

    def __init__(self, seed):
        self.key = jax.random.PRNGKey(seed)
        self.propose = jax.jit(jinv.propose, static_argnums=2)

    def __call__(self, t_u, k, pcfg):
        self.key, sub = jax.random.split(self.key)
        jt = jinv.FFNTransform(jnp.asarray(t_u.pi.numpy().astype(np.int32)),
                               jnp.asarray(t_u.s.numpy()),
                               jnp.asarray(t_u.phi.numpy()))
        jp = jinv.ProposalConfig(**dataclasses.asdict(pcfg))
        out = []
        for key in candidate_keys(sub, k):
            c = self.propose(key, jt, jp)
            out.append(tinv.FFNTransform(
                torch.from_numpy(np.asarray(c.pi).astype(np.int64)),
                torch.from_numpy(np.array(c.s)),
                torch.from_numpy(np.array(c.phi))))
        return out


def _bases(opt_pair, qbits=2, group=32):
    jcfg, tcfg, jparams, tparams, calib = opt_pair
    jqc = jq.QuantConfig(bits=qbits, group_size=group)
    tqc = tq.QuantConfig(bits=qbits, group_size=group)
    not_ffn = lambda p: p[-1] not in ("up", "down")  # noqa: E731
    jbase = jrtn.map_quantizable(jparams, lambda w, p: jq.fake_quant(w, jqc),
                                 only=not_ffn)
    tbase = trtn.map_quantizable(tparams, lambda w, p: tq.fake_quant(w, tqc),
                                 only=not_ffn)
    return jqc, tqc, jbase, tbase


def _compare_histories(th, jh):
    assert len(th) == len(jh) == STEPS + 1
    cur = jh[0][1]
    np.testing.assert_allclose(th[0][1:4], jh[0][1:4], rtol=1e-5)
    for (ts, tl, tp, ta, tacc), (js, jl, jp, ja, jacc) in zip(th[1:], jh[1:]):
        assert ts == js
        delta = jl - cur
        assert abs(delta) >= 1e-5 * abs(jl), (
            f"step {js}: near tie |delta|={abs(delta):.3g}; pick another seed")
        np.testing.assert_allclose([tl, tp, ta], [jl, jp, ja], rtol=1e-5)
        assert tacc == jacc, f"step {js}: accept flags differ"
        if jacc:
            cur = jl


def _port_objective(name, tcfg):
    """The port's objective for a replayed run: SWD on the reference's raw
    projection directions (``jax.random`` at proj_seed 0; the port does not
    re-derive threefry), every other objective by name."""
    if name != "swd_actmatch":
        return name
    dirs = np.array(jax.random.normal(jax.random.PRNGKey(0),
                                      (tcfg.d_model, 64), jnp.float32))
    return tobj.SWDActMatchObjective(dirs=torch.from_numpy(dirs))


@pytest.mark.parametrize("fused,objective", [
    (False, "ce"), (True, "ce"), (False, "kl"), (True, "swd_actmatch"),
    (True, "saliency_ce")],
    ids=["unfused", "fused", "unfused-kl", "fused-swd", "fused-saliency"])
def test_search_replay_matches_reference(opt_pair, fused, objective):
    jcfg, tcfg, jparams, tparams, calib = opt_pair
    jqc, tqc, jbase, tbase = _bases(opt_pair)
    jres = jsearch.run(jparams, jbase, jcfg, jqc, jnp.asarray(calib),
                       jcs.SearchConfig(steps=STEPS, seed=SEED,
                                        fused_kernel=fused, log_every=0),
                       objective=objective)
    tres = tsearch.run(tparams, tbase, tcfg, tqc,
                       torch.from_numpy(calib.astype(np.int64)),
                       tcs.SearchConfig(steps=STEPS, seed=SEED,
                                        fused_kernel=fused, log_every=0),
                       objective=_port_objective(objective, tcfg),
                       proposals=JaxReplay(SEED))
    assert tres.stats["objective"] == objective
    _compare_histories(tres.history, jres.history)
    assert sum(h[4] for h in tres.history[1:]) > 0, "no move was accepted"
    np.testing.assert_allclose(tres.final_loss, jres.final_loss, rtol=1e-5)
    np.testing.assert_allclose(tres.initial_loss, jres.initial_loss, rtol=1e-5)
    assert tres.accept_rate == jres.accept_rate
    for a, b in zip(tres.transforms, jres.transforms):
        np.testing.assert_allclose(to_np(a), to_np(b), rtol=0, atol=1e-7)
    assert tres.stats["fused"] is fused
    assert tres.stats["proposals"] == STEPS


def test_search_population_and_annealing_run(opt_pair):
    """K=2, T>0 on native proposals: K candidates per step, the history and
    the elite stay consistent, and the elite stack is not aliased by later
    accepts."""
    jcfg, tcfg, jparams, tparams, calib = opt_pair
    _, tqc, _, tbase = _bases(opt_pair)
    res = tsearch.run(tparams, tbase, tcfg, tqc,
                      torch.from_numpy(calib.astype(np.int64)),
                      tcs.SearchConfig(steps=6, seed=1, population=2,
                                       temperature=0.05, anneal="constant",
                                       fused_kernel=True, log_every=0))
    assert res.stats["proposals"] == 12
    assert res.final_loss == min(h[1] for h in res.history if h[4])
    assert res.final_loss <= res.initial_loss
    # the elite params reproduce the elite loss
    from repro_torch.core.objective import activation_mse, calib_ce
    from repro_torch.models.model import forward
    toks = torch.from_numpy(calib.astype(np.int64))
    _, h_fp = forward(tparams, tcfg, toks, collect_hidden=True)
    logits, h = forward(res.params_q, tcfg, toks, collect_hidden=True)
    p = float(calib_ce(logits, toks, tcfg.vocab_size))
    a = float(activation_mse(h, h_fp, 2))
    p0, a0 = res.history[0][2], res.history[0][3]
    alpha = p0 / (10.0 * a0)
    np.testing.assert_allclose(p + alpha * a, res.final_loss, rtol=1e-5)


def test_install_unit_returns_a_fresh_stack():
    adapter = tcs.DenseFFNAdapter(tget_config("opt-tiny").reduced(**TINY))
    stack = {"up": torch.zeros(2, 3, 4), "down": torch.zeros(2, 4, 3)}
    out = adapter.install_unit(stack, 1, {"up": torch.ones(3, 4),
                                          "down": torch.ones(4, 3)})
    assert float(stack["up"].sum()) == 0.0          # original untouched
    assert float(out["up"][1].sum()) == 12.0 and float(out["up"][0].sum()) == 0


@pytest.mark.parametrize("field,value", [("mapped", True)])
def test_unported_options_raise(opt_pair, field, value):
    """Mapped islands are ported (one island a rank): in a world of one
    process, two islands are refused as the reference refuses more islands
    than devices."""
    _, tcfg, _, tparams, calib = opt_pair
    scfg = dataclasses.replace(tcs.SearchConfig(steps=1, log_every=0,
                                                islands=2),
                               **{field: value})
    with pytest.raises(ValueError, match="one island per device"):
        tsearch.run(tparams, tparams, tcfg, tq.QuantConfig(bits=2, group_size=32),
                    torch.from_numpy(calib.astype(np.int64)), scfg)


def test_quantize_model_search_and_method_guards(opt_pair):
    _, tcfg, _, tparams, calib = opt_pair
    qc = tq.QuantConfig(bits=2, group_size=32)
    res = tquantize_model(tparams, tcfg, qc, "rtn", calib,
                          tcs.SearchConfig(steps=2, log_every=0), device="cpu")
    assert res.method == "rtn+invarexplore" and len(res.search.history) == 3
    awq = tquantize_model(tparams, tcfg, qc, "awq", calib, device="cpu")
    assert awq.method == "awq" and awq.search is None
    with pytest.raises(ValueError, match="unknown method 'nope'"):
        tquantize_model(tparams, tcfg, qc, "nope", calib, device="cpu")
    with pytest.raises(ValueError, match="calib_tokens"):
        tquantize_model(tparams, tcfg, qc, "rtn", None, tcs.SearchConfig(),
                        device="cpu")
