"""Port parity: the ``swd_actmatch`` and ``saliency_ce`` search objectives
(``repro_torch.core.objective``) vs the JAX reference.

The reference draws SWD's projection directions from ``jax.random``; the
port does not re-derive threefry, so these tests hand the reference's raw
draws to the port (``dirs=``) and hold ``prepare``/``evaluate`` to rtol
1e-5 (the losses' bar in ``test_torch_model.py``). The objectives inside
the search are held by ``test_torch_search.py``'s replayed runs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import to_np
from repro.core import objective as jobj
from repro_torch.core import objective as tobj

L_, B, S, D, V, VOCAB = 3, 2, 16, 32, 64, 60


@pytest.fixture(scope="module")
def env_pair():
    """The same (B, S) tokens, (B, S, V) FP logits and (L, B, S, D) FP taps
    on both sides, with a padded vocabulary (V > vocab_size); quantized
    logits and taps near them."""
    rng = np.random.default_rng(5)
    toks = rng.integers(0, VOCAB, size=(B, S))
    lf = (2 * rng.standard_normal((B, S, V))).astype(np.float32)
    hf = rng.standard_normal((L_, B, S, D)).astype(np.float32)
    lq = (lf + 0.3 * rng.standard_normal(lf.shape)).astype(np.float32)
    hq = (hf + 0.2 * rng.standard_normal(hf.shape)).astype(np.float32)
    return toks, lf, hf, lq, hq


def _envs(env_pair, n_match):
    toks, lf, hf, _, _ = env_pair
    kw = dict(vocab_size=VOCAB, n_match=n_match, ce_weight=10.0)
    jenv = jobj.ObjectiveEnv(calib=jnp.asarray(toks), logits_fp=jnp.asarray(lf),
                             hidden_fp=jnp.asarray(hf[:n_match]) if n_match
                             else None, **kw)
    tenv = tobj.ObjectiveEnv(calib=torch.from_numpy(toks),
                             logits_fp=torch.from_numpy(lf),
                             hidden_fp=torch.from_numpy(hf[:n_match]) if n_match
                             else None, **kw)
    return jenv, tenv


def _reference_dirs(d, n_proj=64, seed=0):
    """The reference's raw draws (``SWDActMatchObjective.prepare``)."""
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), (d, n_proj),
                                      jnp.float32))


@pytest.mark.parametrize("n_match", [0, 2, 3], ids=["logits", "taps2", "taps3"])
@pytest.mark.parametrize("ce_anchor", [True, False], ids=["anchor", "plain"])
def test_swd_matches_reference_on_its_directions(env_pair, n_match, ce_anchor):
    _, _, _, lq, hq = env_pair
    jenv, tenv = _envs(env_pair, n_match)
    jo = jobj.SWDActMatchObjective(ce_anchor=ce_anchor)
    d = D if n_match else V
    to = tobj.SWDActMatchObjective(ce_anchor=ce_anchor,
                                   dirs=torch.from_numpy(_reference_dirs(d)))
    js, ts = jo.prepare(jenv), to.prepare(tenv)
    for k in ("dirs", "ref_sorted"):
        np.testing.assert_allclose(to_np(ts[k]), to_np(js[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    jp, ja = jo.evaluate(jnp.asarray(lq), jnp.asarray(hq), js, jenv)
    tp, ta = to.evaluate(torch.from_numpy(lq), torch.from_numpy(hq), ts, tenv)
    np.testing.assert_allclose(float(tp), float(jp), rtol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5)
    assert to.resolve_mix(float(tp), float(ta), tenv) == pytest.approx(
        jo.resolve_mix(float(jp), float(ja), jenv), rel=1e-5)


def test_swd_is_invariant_to_a_token_permutation(env_pair):
    """A distributional match: shuffling the quantized model's token
    positions (the same shuffle in every layer) leaves the SWD unchanged."""
    toks, lf, hf, lq, hq = env_pair
    _, tenv = _envs(env_pair, 2)
    to = tobj.SWDActMatchObjective(ce_anchor=False)
    state = to.prepare(tenv)
    perm = np.random.default_rng(0).permutation(B * S)
    hp = hq.reshape(L_, B * S, D)[:, perm].reshape(hq.shape)
    a, _ = to.evaluate(torch.from_numpy(lq), torch.from_numpy(hq), state, tenv)
    b, _ = to.evaluate(torch.from_numpy(lq), torch.from_numpy(hp), state, tenv)
    np.testing.assert_allclose(float(b), float(a), rtol=1e-6)
    same, _ = to.evaluate(torch.from_numpy(lf), torch.from_numpy(hf), state,
                          tenv)
    assert float(same) < 1e-10 < float(a)


def test_swd_native_directions_are_seeded_and_checked(env_pair):
    _, tenv = _envs(env_pair, 2)
    a = tobj.SWDActMatchObjective(n_proj=8, proj_seed=3).prepare(tenv)["dirs"]
    b = tobj.SWDActMatchObjective(n_proj=8, proj_seed=3).prepare(tenv)["dirs"]
    c = tobj.SWDActMatchObjective(n_proj=8, proj_seed=4).prepare(tenv)["dirs"]
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert tuple(a.shape) == (D, 8)
    np.testing.assert_allclose(to_np(torch.linalg.norm(a, dim=0)), 1.0,
                               rtol=1e-6)
    with pytest.raises(ValueError, match="dirs has shape"):
        tobj.SWDActMatchObjective(n_proj=8, dirs=torch.ones(D, 4)).prepare(tenv)


@pytest.mark.parametrize("temperature", [1.0, 0.5, 2.0])
@pytest.mark.parametrize("n_match", [0, 2], ids=["ce-only", "mse"])
def test_saliency_ce_matches_reference(env_pair, temperature, n_match):
    _, _, _, lq, hq = env_pair
    jenv, tenv = _envs(env_pair, n_match)
    jo = jobj.SaliencyCEObjective(temperature=temperature)
    to = tobj.SaliencyCEObjective(temperature=temperature)
    js, ts = jo.prepare(jenv), to.prepare(tenv)
    np.testing.assert_allclose(to_np(ts["w"]), to_np(js["w"]), rtol=1e-5)
    np.testing.assert_allclose(float(ts["w"].mean()), 1.0, rtol=1e-5)
    jp, ja = jo.evaluate(jnp.asarray(lq), jnp.asarray(hq), js, jenv)
    tp, ta = to.evaluate(torch.from_numpy(lq), torch.from_numpy(hq), ts, tenv)
    np.testing.assert_allclose(float(tp), float(jp), rtol=1e-5)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5, atol=1e-12)
    assert to.resolve_mix(float(tp), float(ta), tenv) == pytest.approx(
        jo.resolve_mix(float(jp), float(ja), jenv), rel=1e-5)


def test_saliency_ce_with_uniform_weights_is_the_ce(env_pair):
    """The unweighted CE is the all-ones special case."""
    toks, _, _, lq, _ = env_pair
    _, tenv = _envs(env_pair, 0)
    state = {"w": torch.ones(B, S - 1)}
    got, _ = tobj.SaliencyCEObjective().evaluate(torch.from_numpy(lq), None,
                                                 state, tenv)
    want = tobj.calib_ce(torch.from_numpy(lq), torch.from_numpy(toks), VOCAB)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("name", sorted(jobj.OBJECTIVES))
def test_registry_resolves_every_reference_name(name):
    objv = tobj.get_objective(name)
    assert objv.name == name == jobj.get_objective(name).name
    assert type(objv).__name__ == type(jobj.get_objective(name)).__name__
    assert tobj.objective_name(name) == name


def test_objective_defaults_match_reference():
    for cls in ("SWDActMatchObjective", "SaliencyCEObjective"):
        j, t = getattr(jobj, cls)(), getattr(tobj, cls)()
        for f, v in vars(j).items():
            assert getattr(t, f) == v, (cls, f)
    assert dataclasses.fields(tobj.ObjectiveEnv)[-1].default == 10.0


@pytest.mark.parametrize("name,kw", [
    ("ce", {}), ("kl", {}), ("swd_actmatch", {}),
    ("swd_actmatch", {"n_proj": 16}), ("saliency_ce", {}),
    ("saliency_ce", {"temperature": 2.5})],
    ids=["ce", "kl", "swd", "swd-16", "saliency", "saliency-t2.5"])
def test_metrics_labels_equal_reference(name, kw):
    """``metrics()``, the obs registry labels: the base's {"objective"},
    SWD's n_proj and saliency's temperature, as the reference's strings."""
    j = type(jobj.get_objective(name))(**kw)
    t = type(tobj.get_objective(name))(**kw)
    assert t.metrics() == j.metrics()
