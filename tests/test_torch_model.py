"""Port parity: the dense model (``repro_torch.models``) and the objectives
(``repro_torch.core.objective``) vs the JAX reference.

JAX-initialised weights are carried across with ``params_from_numpy``. The
forward's logits and (L, B, S, D) taps are held to ``rtol=1e-4,
atol=1e-5``: the fp32 sums run in another order, and the reference's
``blocked_attention`` uses an online softmax. The losses, fed the same
logits, are held to ``rtol=1e-5``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import to_np
from repro.configs import get_config as jget_config
from repro.core import objective as jobj
from repro.data.calib import calibration_tokens as jcalibration_tokens
from repro.models import model as jmodel
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import objective as tobj
from repro_torch.data.calib import calibration_tensor, calibration_tokens
from repro_torch.models import model as tmodel

TINY = dict(n_layers=2, d_model=64, d_ff=128, vocab_size=256, n_heads=4,
            max_seq_len=256)


def _configs(**kw):
    over = {**TINY, **kw}
    return (jget_config("opt-tiny").reduced(**over),
            tget_config("opt-tiny").reduced(**over))


@pytest.fixture(scope="module", params=[4, 2], ids=["mha", "gqa"])
def tiny(request):
    jcfg, tcfg = _configs(n_kv_heads=request.param)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    tokens = calibration_tokens(jcfg.vocab_size, n_seqs=2, seq_len=64)
    return jcfg, tcfg, jparams, tparams, tokens


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def test_config_fields_match_reference():
    jcfg, tcfg = jget_config("opt-1.3b"), tget_config("opt-1.3b")
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
              "vocab_size", "activation", "gated_mlp", "use_bias", "pos_emb",
              "norm", "max_seq_len", "padded_vocab", "resolved_head_dim",
              "attn_chunk", "use_flash_decode", "kv_cache_dtype"):
        assert getattr(tcfg, f) == getattr(jcfg, f), f
    assert tcfg.reduced().attn_chunk == jcfg.reduced().attn_chunk == 64
    assert (tcfg.n_layers, tcfg.d_model, tcfg.d_ff) == (24, 2048, 8192)


def test_calibration_tokens_are_the_reference_tokens():
    want = jcalibration_tokens(256, n_seqs=3, seq_len=32, seed=5)
    np.testing.assert_array_equal(calibration_tokens(256, 3, 32, seed=5), want)
    got = calibration_tensor(256, 3, 32, seed=5, device="cpu")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_init_params_shapes_and_scales_match_reference():
    jcfg, tcfg = _configs(n_kv_heads=2)
    jflat = _flat(jax.tree.map(np.asarray, jmodel.init_params(
        jax.random.PRNGKey(0), jcfg)))
    tflat = _flat(tmodel.init_params(tcfg, torch.Generator().manual_seed(0),
                                     device="cpu"))
    assert sorted(tflat) == sorted(jflat)
    for path, j in jflat.items():
        t = tflat[path]
        assert tuple(t.shape) == j.shape and str(t.dtype).endswith(
            str(j.dtype)), path
        if j.std() == 0:      # ones / zeros leaves are exact
            np.testing.assert_array_equal(t.numpy(), j)
        else:                 # random leaves: the same scale
            assert abs(float(t.std()) / float(j.std()) - 1) < 0.15, path


def test_params_from_numpy_round_trip_and_bf16():
    tree = {"a": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)},
            "b": np.asarray(jnp.ones((4,), jnp.bfloat16))}
    out = params_from_numpy(tree, "cpu")
    np.testing.assert_array_equal(out["a"]["w"].numpy(), tree["a"]["w"])
    assert out["b"].dtype == torch.bfloat16 and float(out["b"].sum()) == 4.0


def test_forward_logits_and_taps_match_reference(tiny):
    jcfg, tcfg, jparams, tparams, tokens = tiny
    jl, jh = jmodel.forward(jparams, jcfg, jnp.asarray(tokens),
                            collect_hidden=True)
    tl, th = tmodel.forward(tparams, tcfg, torch.from_numpy(
        tokens.astype(np.int64)), collect_hidden=True)
    assert tuple(th.shape) == jh.shape == (2, 2, 64, 64)
    np.testing.assert_allclose(to_np(tl), to_np(jl), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to_np(th), to_np(jh), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        to_np(tmodel.forward(tparams, tcfg, torch.from_numpy(
            tokens.astype(np.int64)))), to_np(jl), rtol=1e-4, atol=1e-5)


def test_forward_layer_override_reads_the_override(tiny):
    """layer_override=(i, tree) == forward over a stack with layer i
    replaced (the search's O(unit) candidate install)."""
    _, tcfg, _, tparams, tokens = tiny
    toks = torch.from_numpy(tokens.astype(np.int64))
    mlp = tparams["blocks"]["mlp"]
    new_up = mlp["up"][1] * 1.5
    replaced = {**tparams, "blocks": {**tparams["blocks"], "mlp": {
        **mlp, "up": torch.stack([mlp["up"][0], new_up])}}}
    want = tmodel.forward(replaced, tcfg, toks)
    got = tmodel.forward(tparams, tcfg, toks,
                         layer_override=(1, {"mlp": {"up": new_up}}))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("ranges", [True, False], ids=["on", "off"])
def test_forward_profiler_ranges(tiny, ranges):
    """Under ``torch.profiler`` (CPU activity) with ``obs.enable_profiler``
    on, a forward shows ``model.attention`` and ``model.ffn`` once per layer
    and ``model.head`` once; with it off, none of them."""
    from repro_torch import obs
    _, tcfg, _, tparams, tokens = tiny
    toks = torch.from_numpy(tokens.astype(np.int64))
    obs.enable_profiler(ranges)
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            tmodel.forward(tparams, tcfg, toks)
    finally:
        obs.enable_profiler(False)
    names = [e.name for e in prof.events()]
    n = tcfg.n_layers if ranges else 0
    assert names.count("model.attention") == names.count("model.ffn") == n
    assert names.count("model.head") == (1 if ranges else 0)


def test_quantizable_paths_match_reference(tiny):
    jcfg, _, jparams, tparams, _ = tiny
    assert tmodel.quantizable_paths(tparams) == jmodel.quantizable_paths(jparams)


@pytest.fixture(scope="module")
def logits_pair():
    """(B, S, V=256) logits for a 250-token vocab: the padded columns must
    be masked by every loss."""
    rng = np.random.default_rng(11)
    lq = (rng.standard_normal((2, 16, 256)) * 3).astype(np.float32)
    lf = (lq + 0.3 * rng.standard_normal(lq.shape)).astype(np.float32)
    toks = rng.integers(0, 250, size=(2, 16))
    return lq, lf, toks


def test_lm_loss_and_calib_ce_match_reference(logits_pair):
    lq, _, toks = logits_pair
    labels = toks.copy()
    labels[0, :3] = -1                    # ignored positions
    np.testing.assert_allclose(
        float(tmodel.lm_loss(torch.from_numpy(lq), torch.from_numpy(labels),
                             250)),
        float(jmodel.lm_loss(jnp.asarray(lq), jnp.asarray(labels), 250)),
        rtol=1e-5)
    np.testing.assert_allclose(
        float(tobj.calib_ce(torch.from_numpy(lq), torch.from_numpy(toks), 250)),
        float(jobj.calib_ce(jnp.asarray(lq), jnp.asarray(toks), 250)),
        rtol=1e-5)


def test_calib_kl_matches_reference(logits_pair):
    lq, lf, _ = logits_pair
    for vocab in (250, 256):
        np.testing.assert_allclose(
            float(tobj.calib_kl(torch.from_numpy(lq), torch.from_numpy(lf),
                                vocab)),
            float(jobj.calib_kl(jnp.asarray(lq), jnp.asarray(lf), vocab)),
            rtol=1e-5)


@pytest.mark.parametrize("n_match", [0, 1, 3])
def test_activation_mse_and_alpha_match_reference(n_match):
    rng = np.random.default_rng(n_match)
    hq = rng.standard_normal((3, 2, 8, 16)).astype(np.float32)
    hf = (hq + 0.1 * rng.standard_normal(hq.shape)).astype(np.float32)
    got = float(tobj.activation_mse(torch.from_numpy(hq),
                                    torch.from_numpy(hf), n_match))
    want = float(jobj.activation_mse(jnp.asarray(hq), jnp.asarray(hf), n_match))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert tobj.resolve_alpha(2.5, got) == jobj.resolve_alpha(2.5, want) \
        or abs(tobj.resolve_alpha(2.5, got) / jobj.resolve_alpha(2.5, want)
               - 1) < 1e-5


def test_objective_registry():
    assert isinstance(tobj.get_objective(None), tobj.CEObjective)
    assert tobj.get_objective("kl").name == "kl"
    inst = tobj.KLObjective()
    assert tobj.get_objective(inst) is inst
    with pytest.raises(ValueError, match="unknown objective"):
        tobj.get_objective("nope")
    with pytest.raises(TypeError):
        tobj.get_objective(3)
    with pytest.raises(ValueError, match="already registered"):
        tobj.register_objective("ce", tobj.CEObjective)
    assert tobj.objective_name(inst) == "kl" and tobj.objective_name(None) == "ce"
