"""Port parity on the encoder-decoder and vision families, continued: RTN,
the search with ``forward_kwargs``, the base methods, the train step and
CLI, and the deprecated search aliases.

Configs, weights and frontend inputs as in
``tests/test_torch_encdec_vision.py`` (the reduced sizes; 8 encoder frames
or 8 patches). The reference's semantics are kept where they surprise:

1. the search on an encoder-decoder stack transforms the decoder's FFNs
   only, so the encoder's FFN leaves come back at full precision, while
   RTN alone fake-quantizes them;
2. the CE search with ``vision_embeds`` compares P+S-1 logits with S-1
   labels and raises ``ValueError`` in both packages (the KL objective,
   label-free, runs); ``shard_calib`` over islands slices the tokens but
   not ``forward_kwargs`` and fails in both;
3. GPTQ, AWQ and OmniQuant refuse an encoder-decoder stack (the reference
   asserts, the port raises ``ValueError``); AWQ runs on InternVL2's text.

Bars (measured worst case on the CPU beside each):
- RTN and the searched weights: ``group_quant``'s one-step bar
  (``assert_within_one_step``);
- the search under the reference's replayed proposals: equal accept
  decisions, losses within rtol 1e-5 (measured ≤ 3e-7) clear of 1e-5 ties;
- AWQ: ``test_torch_baselines.py``'s ``assert_gptq_close``;
- the train step: loss and grad norm within rtol 1e-5, params within rtol
  2e-3 / atol 2e-4 (``tests/test_substrate.py``'s bar).
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import (assert_within_one_step, one_torch_thread,  # noqa: F401
                                  to_np)
from repro.core import quant as jq
from repro.core import rtn as jrtn
from repro.core import search as jcs
from repro.core.pipeline import quantize_model as jquantize_model
from repro.launch import steps as jsteps
from repro.launch import train as jtrain
from repro.models import model as jmodel
from repro.optim import adamw as ja
from repro_torch import search as tsearch
from repro_torch.configs import get_config as tget_config
from repro_torch.core import pipeline as tpipeline
from repro_torch.core import quant as tq
from repro_torch.core import rtn as trtn
from repro_torch.core import search as tcs
from repro_torch.core.pipeline import quantize_model as tquantize_model
from repro_torch.data.calib import calibration_tokens
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import model as tmodel
from repro_torch.optim import adamw as ta
from repro_torch.search import engine as tengine
from test_torch_baselines import _grid_position, assert_gptq_close
from test_torch_encdec_vision import (ARCHS, IDS, INTERNVL, SEAMLESS,
                                      frontend_inputs, jkw, pair, tkw)
from test_torch_search import JaxReplay
from test_torch_search_engine import IslandReplay

pytestmark = pytest.mark.usefixtures("one_torch_thread")
STEPS, SEED = 8, 0
ENC_FFN = (("enc_blocks", "mlp", "up"), ("enc_blocks", "mlp", "down"))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _assert_leaves_within_one_step(tparams_q, jparams_q, paths, group=32):
    for path in paths:
        jw = np.asarray(jrtn.get_by_path(jparams_q, path))
        tw = trtn.get_by_path(tparams_q, path)
        for i in range(jw.shape[0]):
            s, _ = jq.compute_qparams(jnp.asarray(jw[i]), jq.QuantConfig(2, group))
            assert_within_one_step(tw[i], jw[i], s, group)


def _calib(cfg, n_seqs=2, seq_len=16):
    return calibration_tokens(cfg.vocab_size, n_seqs=n_seqs, seq_len=seq_len)


class _Replayed:
    """``tpipeline.run_invar_search`` with ``proposals`` handed in: the
    pipeline's own search call, on the reference's proposal stream."""

    def __init__(self, proposals):
        self.proposals, self.real = proposals, tpipeline.run_invar_search

    def __enter__(self):
        def replayed(*a, **kw):
            return self.real(*a, proposals=self.proposals, **kw)
        tpipeline.run_invar_search = replayed

    def __exit__(self, *exc):
        tpipeline.run_invar_search = self.real


def _compare_histories(th, jh, steps):
    assert len(th) == len(jh) == steps + 1
    np.testing.assert_allclose(th[0][1:4], jh[0][1:4], rtol=1e-5)
    cur = jh[0][1]
    for (ts_, tl, tp, ta_, tacc), (js_, jl, jp, ja_, jacc) in zip(th[1:],
                                                                  jh[1:]):
        assert ts_ == js_
        assert abs(jl - cur) >= 1e-5 * abs(jl), f"step {js_}: near tie"
        np.testing.assert_allclose([tl, tp, ta_], [jl, jp, ja_], rtol=1e-5)
        assert tacc == jacc, f"step {js_}: accept flags differ"
        if jacc:
            cur = jl


# ---------------------------------------------------------------------------
# RTN and the search with forward_kwargs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_quantize_model_rtn_matches_reference(arch):
    """RTN quantizes every quantizable leaf — the encoder's and the
    cross-attention's included — and leaves the rest untouched."""
    jcfg, tcfg, jparams, tparams = pair(arch)
    jq_params = jax.jit(lambda p: jquantize_model(
        p, jcfg, jq.QuantConfig(2, 32)).params_q)(jparams)
    tr = tquantize_model(tparams, tcfg, tq.QuantConfig(2, 32), device="cpu")
    paths = jmodel.quantizable_paths(jparams)
    _assert_leaves_within_one_step(tr.params_q, jq_params, paths)
    for path, v in _flat(tr.params_q).items():
        if path not in paths:
            np.testing.assert_array_equal(
                to_np(v), np.asarray(jrtn.get_by_path(jparams, path)))
        else:
            assert not torch.equal(v, trtn.get_by_path(tparams, path)), path
    if tcfg.is_enc_dec:
        assert set(ENC_FFN) < set(paths)


@pytest.fixture(scope="module")
def seamless_searched():
    """RTN + 8 fused steps on Seamless with ``enc_embeds``, through both
    pipelines, the port's on the reference's replayed proposals."""
    jcfg, tcfg, jparams, tparams = pair(SEAMLESS)
    calib = _calib(jcfg)
    kw = frontend_inputs(jcfg, 2)
    jscfg = jcs.SearchConfig(steps=STEPS, seed=SEED, fused_kernel=True,
                             log_every=0)
    tscfg = tcs.SearchConfig(steps=STEPS, seed=SEED, fused_kernel=True,
                             log_every=0)
    jr = jquantize_model(jparams, jcfg, jq.QuantConfig(2, 32), "rtn",
                         jnp.asarray(calib), jscfg, forward_kwargs=jkw(kw))
    with _Replayed(JaxReplay(SEED)):
        tr = tquantize_model(tparams, tcfg, tq.QuantConfig(2, 32), "rtn",
                             calib, tscfg, forward_kwargs=tkw(kw),
                             device="cpu")
    return jparams, tparams, jr, tr


def test_search_with_enc_embeds_matches_reference(seamless_searched):
    jparams, tparams, jr, tr = seamless_searched
    assert tr.method == jr.method == "rtn+invarexplore"
    _compare_histories(tr.search.history, jr.search.history, STEPS)
    assert sum(h[4] for h in tr.search.history[1:]) > 0, "no move accepted"
    assert tr.search.accept_rate == jr.search.accept_rate
    np.testing.assert_allclose(tr.search.final_loss, jr.search.final_loss,
                               rtol=1e-5)
    paths = [p for p in jmodel.quantizable_paths(jparams)
             if p[0] == "blocks"]
    _assert_leaves_within_one_step(tr.params_q, jr.params_q, paths)


def test_encdec_search_leaves_the_encoder_ffn_at_full_precision(
        seamless_searched):
    """Finding 1, in both packages: the search leaves ``enc_blocks/mlp/up``
    and ``down`` equal to the FP weights (the search's units are the
    decoder's FFNs); the encoder's attention is frozen at its fake-quant
    values; RTN alone quantizes the encoder FFN."""
    jparams, tparams, jr, tr = seamless_searched
    for path in ENC_FFN:
        assert torch.equal(trtn.get_by_path(tr.params_q, path),
                           trtn.get_by_path(tparams, path))
        np.testing.assert_array_equal(
            np.asarray(jrtn.get_by_path(jr.params_q, path)),
            np.asarray(jrtn.get_by_path(jparams, path)))
    rtn = tquantize_model(tparams, tget_config(SEAMLESS).reduced(),
                          tq.QuantConfig(2, 32), device="cpu")
    for path in ENC_FFN + (("enc_blocks", "attn", "wq"),):
        assert not torch.equal(trtn.get_by_path(rtn.params_q, path),
                               trtn.get_by_path(tparams, path))
    assert torch.equal(trtn.get_by_path(tr.params_q, ("enc_blocks", "attn",
                                                      "wq")),
                       trtn.get_by_path(rtn.params_q, ("enc_blocks", "attn",
                                                       "wq")))


def test_search_islands_with_enc_embeds_match_reference():
    """Two islands (no migration) on the full batch with ``enc_embeds``:
    each island's history equals the reference island's under its replayed
    key chain."""
    jcfg, tcfg, jparams, tparams = pair(SEAMLESS)
    calib = _calib(jcfg)
    kw = frontend_inputs(jcfg, 2)
    opts = dict(steps=4, seed=SEED, islands=2, migrate_every=0, log_every=0)
    jr = jquantize_model(jparams, jcfg, jq.QuantConfig(2, 32), "rtn",
                         jnp.asarray(calib), jcs.SearchConfig(**opts),
                         forward_kwargs=jkw(kw))
    with _Replayed([IslandReplay(SEED, i) for i in range(2)]):
        tr = tquantize_model(tparams, tcfg, tq.QuantConfig(2, 32), "rtn",
                             calib, tcs.SearchConfig(**opts),
                             forward_kwargs=tkw(kw), device="cpu")
    for th, jh in zip(tr.search.island_histories, jr.search.island_histories):
        assert [h[4] for h in th] == [h[4] for h in jh]
        np.testing.assert_allclose([h[1] for h in th], [h[1] for h in jh],
                                   rtol=1e-5)


def test_shard_calib_with_forward_kwargs_fails_in_both():
    """The reference slices the calibration tokens across islands but not
    ``forward_kwargs``: its per-island forward fails on the batch
    (TypeError from jnp); the port raises ValueError before it starts."""
    jcfg, tcfg, jparams, tparams = pair(SEAMLESS)
    calib = _calib(jcfg, n_seqs=4)
    kw = frontend_inputs(jcfg, 4)
    opts = dict(steps=2, islands=2, shard_calib=True, log_every=0)
    with pytest.raises(TypeError):
        jquantize_model(jparams, jcfg, jq.QuantConfig(2, 32), "rtn",
                        jnp.asarray(calib), jcs.SearchConfig(**opts),
                        forward_kwargs=jkw(kw))
    with pytest.raises(ValueError, match="shard_calib"):
        tquantize_model(tparams, tcfg, tq.QuantConfig(2, 32), "rtn", calib,
                        tcs.SearchConfig(**opts), forward_kwargs=tkw(kw),
                        device="cpu")


def test_ce_search_with_vision_embeds_fails_in_both():
    """Finding 2: CE compares P+S-1 logits with S-1 labels."""
    jcfg, tcfg, jparams, tparams = pair(INTERNVL)
    calib = _calib(jcfg)
    kw = frontend_inputs(jcfg, 2)
    with pytest.raises(ValueError, match="Incompatible shapes"):
        jquantize_model(jparams, jcfg, jq.QuantConfig(2, 32), "rtn",
                        jnp.asarray(calib), jcs.SearchConfig(steps=1),
                        forward_kwargs=jkw(kw))
    with pytest.raises(ValueError, match="Incompatible shapes"):
        tquantize_model(tparams, tcfg, tq.QuantConfig(2, 32), "rtn", calib,
                        tcs.SearchConfig(steps=1), forward_kwargs=tkw(kw),
                        device="cpu")


def test_kl_search_with_vision_embeds_matches_reference():
    """The label-free KL objective compares P+S logits with P+S: the
    vision search runs in both packages, with equal histories."""
    jcfg, tcfg, jparams, tparams = pair(INTERNVL)
    calib = _calib(jcfg)
    kw = frontend_inputs(jcfg, 2)
    opts = dict(steps=4, seed=SEED, objective="kl", fused_kernel=True,
                log_every=0)
    jr = jquantize_model(jparams, jcfg, jq.QuantConfig(2, 32), "rtn",
                         jnp.asarray(calib), jcs.SearchConfig(**opts),
                         forward_kwargs=jkw(kw))
    with _Replayed(JaxReplay(SEED)):
        tr = tquantize_model(tparams, tcfg, tq.QuantConfig(2, 32), "rtn",
                             calib, tcs.SearchConfig(**opts),
                             forward_kwargs=tkw(kw), device="cpu")
    _compare_histories(tr.search.history, jr.search.history, 4)


# ---------------------------------------------------------------------------
# the base methods
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ["gptq", "awq", "omniquant"])
def test_calibrated_methods_refuse_the_encdec_stack(method):
    """Finding 3: the reference asserts in ``capture_dense_taps``."""
    jcfg, tcfg, jparams, tparams = pair(SEAMLESS)
    calib = _calib(jcfg)
    with pytest.raises(AssertionError):
        jquantize_model(jparams, jcfg, jq.QuantConfig(2, 32), method,
                        jnp.asarray(calib))
    with pytest.raises(ValueError, match="encoder-decoder"):
        tquantize_model(tparams, tcfg, tq.QuantConfig(2, 32), method, calib,
                        device="cpu")


def test_awq_on_internvl_text_matches_reference():
    """AWQ on the vision stack's text (tied embeddings, qkv biases, GQA rep
    2 at the reduced size): every quantized leaf within the base methods'
    bar; the grid choices equal."""
    jcfg, tcfg, jparams, tparams = pair(INTERNVL)
    calib = _calib(jcfg, n_seqs=4, seq_len=32)
    jr = jquantize_model(jparams, jcfg, jq.QuantConfig(2, 32), "awq",
                         jnp.asarray(calib))
    tr = tquantize_model(tparams, tcfg, tq.QuantConfig(2, 32), "awq", calib,
                         device="cpu")
    assert tr.method == jr.method == "awq"
    assert "lm_head" not in tr.params_q
    for path in jmodel.quantizable_paths(jparams):
        want = to_np(jrtn.get_by_path(jr.params_q, path))
        _, scale = _grid_position(want, 2, 32)
        assert_gptq_close(trtn.get_by_path(tr.params_q, path), want, scale,
                          f"awq {path}")


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_train_step_with_frontend_inputs_matches_reference(arch):
    """One step with ``enc_embeds`` / ``vision_embeds`` in the batch (the
    vision loss drops the patches' logits); ``accum_steps=2`` splits every
    batch entry and lands within the same bar."""
    jcfg, tcfg, jp, tp = pair(arch)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                               (4, 16)).astype(np.int32)
    kw = frontend_inputs(jcfg, 4)
    opt = dict(lr=1e-3, total_steps=10, warmup_steps=2)
    jnew, _, jm = jax.jit(jsteps.make_train_step(jcfg, ja.AdamWConfig(**opt)))(
        jp, ja.adamw_init(jp), {"tokens": jnp.asarray(tokens), **jkw(kw)})
    jflat = _flat(jax.tree.map(np.asarray, jnew))
    for accum in (1, 2):
        tnew, _, tm = tsteps.make_train_step(tcfg, ta.AdamWConfig(**opt),
                                             accum_steps=accum)(
            tp, ta.adamw_init(tp), {"tokens": torch.from_numpy(tokens),
                                    **tkw(kw)})
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=f"{k} accum {accum}")
        tflat = _flat(tnew)
        assert sorted(tflat) == sorted(jflat)
        for path, j in jflat.items():
            np.testing.assert_allclose(to_np(tflat[path]), j, rtol=2e-3,
                                       atol=2e-4, err_msg="/".join(path))
    if tcfg.is_enc_dec:   # the encoder trained too
        assert not np.array_equal(jflat[("enc_blocks", "mlp", "up")],
                                  np.asarray(jp["enc_blocks"]["mlp"]["up"]))
    with pytest.raises(KeyError):     # the reference's step reads the key
        tsteps.make_train_step(tcfg)(tp, ta.adamw_init(tp), {
            "tokens": torch.from_numpy(tokens)})


@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_train_cli_fails_as_the_reference_does(arch):
    """The train CLI's batches carry only tokens (as the reference's), so
    the step asks for the frontend input: KeyError in both."""
    key = "enc_embeds" if arch == SEAMLESS else "vision_embeds"
    with pytest.raises(KeyError, match=key):
        jtrain.train(arch, steps=1, batch=2, seq=16, log_every=1)
    with pytest.raises(KeyError, match=key):
        ttrain.train(arch, steps=1, batch=2, seq=16, log_every=1,
                     device="cpu")


# ---------------------------------------------------------------------------
# the deprecated search aliases
# ---------------------------------------------------------------------------

def _text_search_inputs(arch=INTERNVL):
    tcfg = tget_config(arch).reduced()
    tparams = tmodel.init_params(tcfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    tqc = tq.QuantConfig(2, 32)
    keys = ("up", "gate", "down", "w_z", "w_x", "out_proj")
    base = trtn.map_quantizable(tparams, lambda w, p: tq.fake_quant(w, tqc),
                                only=lambda p: p[-1] not in keys)
    calib = torch.from_numpy(_calib(tcfg).astype(np.int64))
    return tparams, base, tcfg, tqc, calib


@pytest.mark.parametrize("alias", ["run_search", "run_search_hybrid",
                                   "run_population_search"])
def test_deprecated_search_aliases_warn_and_run_the_front_door(alias):
    """Each alias warns with DeprecationWarning and returns what
    ``search.run`` returns for the same call (the reference's shims)."""
    arch = "zamba2-7b" if alias == "run_search_hybrid" else INTERNVL
    tparams, base, tcfg, tqc, calib = _text_search_inputs(arch)
    scfg = tcs.SearchConfig(steps=2, seed=1, log_every=0)
    fn = {"run_search": tcs.run_search,
          "run_search_hybrid": tcs.run_search_hybrid,
          "run_population_search": tengine.run_population_search}[alias]
    args = (tparams, base, tcfg, tqc, calib, scfg)
    if alias == "run_population_search":
        args += (tcs.make_adapter(tcfg),)
    with pytest.warns(DeprecationWarning, match="search.run"):
        got = fn(*args)
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        want = tsearch.run(tparams, base, tcfg, tqc, calib, scfg)
    assert got.history == want.history
    assert len(got.history) == scfg.steps + (2 if alias ==
                                             "run_search_hybrid" else 1)
