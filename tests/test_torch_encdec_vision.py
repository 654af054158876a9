"""Port parity on the encoder-decoder and vision families: configs, the stub
frontends, cross-attention, the param tree, the forward (``enc_embeds`` /
``vision_embeds``, ``collect_hidden``), prefill + decode over the cross
cache and after a vision prefix.

Configs: ``seamless-m4t-medium`` (enc-dec: learned positions, LayerNorm,
biases, ReLU) and ``internvl2-1b`` (vision: RoPE, qkv biases, tied
embeddings, GQA) at their ``reduced()`` sizes (2 + 2 layers, 8 frontend
positions). Weights are the reference's ``init_params`` carried across with
``params_from_numpy``, with norms and biases moved off their ones / zeros
init so that every leaf is read. Frames and patches are numpy draws fed to
both packages. Bars (measured worst case on the CPU beside each):

- ``forward`` logits and taps: rtol 1e-4, atol 1e-5 (``test_torch_model.py``;
  measured ≤ 4.7e-6);
- prefill + 3 decode steps, logits and caches (the cross K/V included):
  rtol = atol = 1e-4 (``test_torch_legacy_serve.py``; measured ≤ 2e-6), and
  the decode logits within the reference's 2e-2 of the port's own full
  forward (``tests/test_models.py``);
- ``cross_attention`` / ``cross_kv``: rtol 1e-5, atol 1e-6;
- the search's layer override: ``torch.equal`` to the forward over a copy
  of the stack holding the unit.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import one_torch_thread, to_np  # noqa: F401
from repro.configs import get_config as jget_config
from repro.models import frontends as jfront
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import search as tcs
from repro_torch.models import frontends as tfront
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.models.config import ModelConfig, check_supported

pytestmark = pytest.mark.usefixtures("one_torch_thread")
SEAMLESS, INTERNVL = "seamless-m4t-medium", "internvl2-1b"
ARCHS = (SEAMLESS, INTERNVL)
IDS = ["seamless", "internvl2"]
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
DEC_TOL = dict(rtol=1e-4, atol=1e-4)


def _perturb(tree, rng, path=()):
    """Norm and bias leaves moved off their ones / zeros init."""
    if isinstance(tree, dict):
        return {k: _perturb(v, rng, path + (k,)) for k, v in tree.items()}
    key = path[-1]
    if any("norm" in p or p.startswith("ln") for p in path) or \
            key.startswith("b"):
        return (tree + 0.1 * rng.standard_normal(tree.shape)).astype(
            tree.dtype)
    return tree


@functools.lru_cache(maxsize=None)
def pair(arch, seed=0):
    """Reduced configs and the reference's init_params (perturbed) carried
    across; cached per process (no test writes into them)."""
    jcfg, tcfg = jget_config(arch).reduced(), tget_config(arch).reduced()
    p = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(seed),
                                                    jcfg))
    p = _perturb(p, np.random.default_rng(seed))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, p), params_from_numpy(p, "cpu")


def frontend_inputs(cfg, batch, seed=1, n=None):
    """{"enc_embeds" | "vision_embeds": (B, n or frontend_len, D) numpy}:
    the stub frontends' shape and dtype, a larger scale so that the
    frontend moves the logits."""
    n = n or cfg.frontend_len
    x = (0.5 * np.random.default_rng(seed).standard_normal(
        (batch, n, cfg.d_model))).astype(np.float32)
    return {"enc_embeds" if cfg.is_enc_dec else "vision_embeds": x}


def jkw(kw):
    return {k: jnp.asarray(v) for k, v in kw.items()}


def tkw(kw):
    return {k: torch.from_numpy(v) for k, v in kw.items()}


@pytest.fixture(scope="module", params=ARCHS, ids=IDS)
def arch_pair(request):
    return pair(request.param)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _close(got, want, what, **tol):
    np.testing.assert_allclose(to_np(got), to_np(want), err_msg=what, **tol)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_configs_equal_reference_field_for_field(arch):
    jcfg, tcfg = jget_config(arch), tget_config(arch)
    for cfg_j, cfg_t in ((jcfg, tcfg), (jcfg.reduced(), tcfg.reduced())):
        for f in dataclasses.fields(cfg_t):
            assert getattr(cfg_t, f.name) == getattr(cfg_j, f.name), f.name
        for prop in ("is_enc_dec", "resolved_head_dim", "padded_vocab",
                     "attn_free"):
            assert getattr(cfg_t, prop) == getattr(cfg_j, prop), prop
        assert cfg_t.param_count() == cfg_j.param_count()
        assert cfg_t.active_param_count() == cfg_j.active_param_count()


def test_param_counts_and_shapes_at_full_size():
    s, v = tget_config(SEAMLESS), tget_config(INTERNVL)
    assert s.param_count() == jget_config(SEAMLESS).param_count() == 910_761_984
    assert v.param_count() == jget_config(INTERNVL).param_count() == 493_889_536
    assert (s.padded_vocab, v.padded_vocab) == (256256, 151808)
    assert (s.encoder_layers, s.frontend, s.frontend_len) == (12, "audio", 4096)
    assert (v.encoder_layers, v.frontend, v.frontend_len) == (0, "vision", 256)
    assert s.is_enc_dec and not v.is_enc_dec
    assert v.n_heads // v.n_kv_heads == 7 and v.tie_embeddings
    assert v.attn_qkv_bias and s.use_bias


def test_new_fields_keep_reference_defaults_and_order():
    names = [f.name for f in dataclasses.fields(ModelConfig)]
    i = names.index("encoder_layers")
    assert names[i:i + 3] == ["encoder_layers", "frontend", "frontend_len"]
    j = {f.name: f.default for f in dataclasses.fields(JModelConfig)}
    for name in names[i:i + 3]:
        assert getattr(ModelConfig(), name) == j[name]
    assert not ModelConfig().is_enc_dec
    assert ModelConfig(encoder_layers=3).reduced().encoder_layers == 2
    assert ModelConfig(frontend="vision", frontend_len=256).reduced() \
        .frontend_len == 8


def test_check_supported_admits_both_families_and_refuses_the_rest():
    for arch in ARCHS:
        check_supported(tget_config(arch))
        check_supported(tget_config(arch).reduced())
    with pytest.raises(ValueError, match="encoder-decoder stack is dense"):
        check_supported(ModelConfig(encoder_layers=2, block_pattern="moe"))
    with pytest.raises(ValueError, match="unknown frontend"):
        check_supported(ModelConfig(frontend="video"))


# ---------------------------------------------------------------------------
# stub frontends and cross-attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_stub_frontends_match_reference_shapes_dtype_and_scale(arch):
    """Same shapes and compute dtype as the reference's stubs, scale 0.02
    (the draws differ: the port does not re-derive ``jax.random``)."""
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(tget_config(arch), compute_dtype=dtype,
                                  d_model=64)
        jcfg = dataclasses.replace(jget_config(arch), compute_dtype=dtype,
                                   d_model=64)
        gen = torch.Generator().manual_seed(0)
        if cfg.frontend == "vision":
            got = tfront.stub_vision_embeds(gen, cfg, 3, device="cpu")
            want = jfront.stub_vision_embeds(jax.random.PRNGKey(0), jcfg, 3)
            assert tfront.stub_vision_embeds(
                gen, cfg, 2, n_patches=5, device="cpu").shape == (2, 5, 64)
        else:
            got = tfront.stub_audio_frames(gen, cfg, 3, 100, device="cpu")
            want = jfront.stub_audio_frames(jax.random.PRNGKey(0), jcfg, 3,
                                            100)
        assert tuple(got.shape) == tuple(want.shape)
        assert str(got.dtype).split(".")[1] == want.dtype.name == dtype
        np.testing.assert_allclose(float(got.float().std()),
                                   float(np.asarray(want, np.float32).std()),
                                   rtol=0.05)
    again = tfront.stub_vision_embeds(torch.Generator().manual_seed(0),
                                      tget_config(INTERNVL), 1, device="cpu")
    assert torch.equal(again, tfront.stub_vision_embeds(
        torch.Generator().manual_seed(0), tget_config(INTERNVL), 1,
        device="cpu"))


def test_stub_frontends_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tget_config(INTERNVL).reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfront.stub_vision_embeds(torch.Generator(), cfg, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfront.stub_audio_frames(torch.Generator(), cfg, 1, 4)


@pytest.mark.parametrize("heads", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_cross_attention_and_cross_kv_match_reference(heads):
    cfg = dataclasses.replace(tget_config(SEAMLESS).reduced(),
                              n_heads=heads[0], n_kv_heads=heads[1],
                              attn_chunk=4)
    jcfg = dataclasses.replace(jget_config(SEAMLESS).reduced(),
                               n_heads=heads[0], n_kv_heads=heads[1],
                               attn_chunk=4)
    rng = np.random.default_rng(3)
    hd, D = cfg.resolved_head_dim, cfg.d_model
    p = {"wq": rng.standard_normal((D, 4 * hd)), "wk": rng.standard_normal(
        (D, heads[1] * hd)), "wv": rng.standard_normal((D, heads[1] * hd)),
         "wo": rng.standard_normal((4 * hd, D)),
         "bq": rng.standard_normal(4 * hd), "bk": rng.standard_normal(
             heads[1] * hd), "bv": rng.standard_normal(heads[1] * hd),
         "bo": rng.standard_normal(D)}
    p = {k: (0.1 * v).astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 5, D)).astype(np.float32)
    enc = rng.standard_normal((2, 11, D)).astype(np.float32)  # 11: ragged chunks
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jkv = jlayers.cross_kv(jp, jcfg, jnp.asarray(enc))
    tkv = tlayers.cross_kv(tp, cfg, torch.from_numpy(enc))
    for a, b in zip(tkv, jkv):
        assert tuple(a.shape) == (2, 11, heads[1], hd)
        _close(a, b, "cross_kv", rtol=1e-5, atol=1e-6)
    _close(tlayers.cross_attention(tp, cfg, torch.from_numpy(x), tkv),
           jlayers.cross_attention(jp, jcfg, jnp.asarray(x), jkv),
           "cross_attention", rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the param tree
# ---------------------------------------------------------------------------

def test_init_params_tree_matches_reference(arch_pair):
    """The port's own init has the reference's leaves, shapes and dtypes:
    ``enc_blocks`` / ``enc_norm`` and each decoder block's ``ln_x`` /
    ``xattn`` for the enc-dec stack; no ``lm_head`` for the tied one."""
    jcfg, tcfg, jparams, tparams = arch_pair
    jflat = _flat(jax.tree.map(np.asarray, jparams))
    own = _flat(tmodel.init_params(tcfg, torch.Generator().manual_seed(0),
                                   device="cpu"))
    assert sorted(own) == sorted(jflat)
    for path, j in jflat.items():
        assert tuple(own[path].shape) == j.shape, path
        assert str(own[path].dtype).split(".")[1] == j.dtype.name, path
    if tcfg.is_enc_dec:
        assert ("enc_blocks", "mlp", "up") in own and ("enc_norm", "b") in own
        assert ("blocks", "xattn", "wq") in own and ("blocks", "ln_x", "w") \
            in own
        assert not any(p[:2] == ("enc_blocks", "xattn") for p in own)
        assert ("lm_head",) in own
    else:
        assert ("lm_head",) not in own and ("blocks", "attn", "bq") in own
        assert not any(p[0].startswith("enc") for p in own)
    # the converted tree holds the reference's values, leaf for leaf
    conv = _flat(tparams)
    assert sorted(conv) == sorted(jflat)
    for path, j in jflat.items():
        np.testing.assert_array_equal(to_np(conv[path]), j, err_msg=str(path))


def test_quantizable_paths_cover_the_encoder_and_cross_attention():
    jcfg, tcfg, jparams, tparams = pair(SEAMLESS)
    paths = sorted(tmodel.quantizable_paths(tparams))
    assert paths == sorted(jmodel.quantizable_paths(jparams))
    assert ("enc_blocks", "mlp", "up") in paths
    assert ("blocks", "xattn", "wk") in paths
    assert len(paths) == 6 + 6 + 4      # dec attn+mlp, enc attn+mlp, xattn


# ---------------------------------------------------------------------------
# forward, prefill + decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,frontend", [(SEAMLESS, True), (INTERNVL, True),
                                           (INTERNVL, False)],
                         ids=["seamless", "internvl2-vision", "internvl2-text"])
def test_forward_matches_reference(arch, frontend):
    jcfg, tcfg, jparams, tparams = pair(arch)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (2, 12))
    kw = frontend_inputs(jcfg, 2) if frontend else {}
    jl, jh = jmodel.forward(jparams, jcfg, jnp.asarray(toks),
                            collect_hidden=True, **jkw(kw))
    tl, th = tmodel.forward(tparams, tcfg, torch.from_numpy(toks),
                            collect_hidden=True, **tkw(kw))
    P = 8 if "vision_embeds" in kw else 0
    assert tuple(tl.shape) == (2, P + 12, tcfg.padded_vocab)
    assert tuple(th.shape) == (tcfg.n_layers, 2, P + 12, tcfg.d_model)
    _close(tl, jl, "logits", **FWD_TOL)
    _close(th, jh, "taps", **FWD_TOL)
    if frontend:     # the frontend input moves the logits
        assert not np.allclose(to_np(tl[:, P:]), to_np(tmodel.forward(
            tparams, tcfg, torch.from_numpy(toks),
            **tkw(frontend_inputs(jcfg, 2, seed=9)))[:, P:]), atol=1e-3)


def test_encdec_forward_needs_enc_embeds():
    _, tcfg, _, tparams = pair(SEAMLESS)
    with pytest.raises(ValueError, match="enc_embeds"):
        tmodel.forward(tparams, tcfg, torch.zeros((1, 4), dtype=torch.long))


def test_layer_override_on_the_decoder_equals_a_copied_stack():
    """The search's candidate reaches decoder layer 1 of the enc-dec stack
    through ``layer_override`` exactly as a stack holding it would."""
    _, tcfg, _, tparams = pair(SEAMLESS)
    adapter = tcs.make_adapter(tcfg)
    assert isinstance(adapter, tcs.DenseFFNAdapter)
    assert adapter.n_units == tcfg.n_layers
    base = adapter.base_stack(tparams)
    assert sorted(base) == ["b_up", "down", "up"]
    unit = {k: v[1] * 1.5 for k, v in base.items()}
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, 512, (2, 9)))
    kw = tkw(frontend_inputs(tcfg, 2))
    via = tmodel.forward(tparams, tcfg, toks, collect_hidden=True,
                         layer_override=adapter.unit_override(1, unit), **kw)
    stack = adapter.install(tparams, adapter.install_unit(base, 1, unit))
    want = tmodel.forward(stack, tcfg, toks, collect_hidden=True, **kw)
    assert torch.equal(via[0], want[0]) and torch.equal(via[1], want[1])


@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_prefill_and_decode_match_reference(arch):
    """Prefill 9 tokens (after 8 patches, or over 8 encoder frames), then 3
    decode steps at positions P+9.. : logits and caches (the cross K/V of
    the enc-dec cache included) against the reference's, and the decode
    logits against the port's own full forward."""
    jcfg, tcfg, jparams, tparams = pair(arch)
    toks = np.random.default_rng(4).integers(0, jcfg.vocab_size, (3, 12))
    kw = frontend_inputs(jcfg, 3)
    P = 8 if "vision_embeds" in kw else 0
    jl, jc = jmodel.prefill(jparams, jcfg, jnp.asarray(toks[:, :9]), 32,
                            **jkw(kw))
    tl, tc = tmodel.prefill(tparams, tcfg, torch.from_numpy(toks[:, :9]), 32,
                            **tkw(kw))
    assert tuple(tl.shape) == (3, P + 9, tcfg.padded_vocab)
    _close(tl, jl, "prefill logits", **DEC_TOL)
    full = tmodel.forward(tparams, tcfg, torch.from_numpy(toks), **tkw(kw))
    for t in range(9, 12):
        jl, jc = jmodel.decode_step(jparams, jcfg, jnp.asarray(toks[:, t:t + 1]),
                                    jc, P + t)
        tl, tc = tmodel.decode_step(tparams, tcfg,
                                    torch.from_numpy(toks[:, t:t + 1]), tc,
                                    P + t)
        _close(tl, jl, f"decode {t}", **DEC_TOL)
        _close(tl[:, 0], full[:, P + t], f"decode {t} vs forward",
               rtol=2e-2, atol=2e-2)
    assert sorted(tc) == sorted(jc)
    for key in ("k", "v"):
        _close(tc[key], jc[key], key, **DEC_TOL)
    if tcfg.is_enc_dec:
        assert tuple(tc["cross"][0].shape) == (
            tcfg.n_layers, 3, 8, tcfg.n_kv_heads, tcfg.resolved_head_dim)
        for a, b in zip(tc["cross"], jc["cross"]):
            _close(a, b, "cross K/V", **DEC_TOL)
    else:
        # the cache holds the patches' K/V at rows 0..P-1
        assert float(tc["k"][:, :, :P].abs().sum()) > 0
        assert float(tc["k"][:, :, P + 12:].abs().sum()) == 0


def test_encdec_cache_starts_without_cross_kv():
    cfg = tget_config(SEAMLESS).reduced()
    cache = tmodel.init_cache(cfg, 2, 16, device="cpu")
    assert cache["cross"] is None
    assert "cross" not in tmodel.init_cache(tget_config(INTERNVL).reduced(),
                                            2, 16, device="cpu")
