"""Port parity: the MoE family (``models/config.py::MoEConfig``,
``models/layers.py::moe_ffn`` / ``moe_aux_loss``, the MoE blocks of
``models/model.py``, RTN and packing of (L, E, K, N) expert leaves, the
train step) against the JAX reference, from the same numpy inputs.

Two configs: phi3.5-moe reduced (E 4, top-2) and moonshot reduced with
``moe`` overridden to E 64, top-6, so that fine-grained routing runs here.
Bars (each stated where it is used):

- routing (top-k indices, slot positions, ``keep``) equal, except where the
  reference's K-th and (K+1)-th router logits lie within 1e-6 relative
  (:func:`assert_routing_equal`): there an ulp of the logits decides;
- ``moe_ffn`` and ``moe_aux_loss``: rtol 1e-5, atol 1e-6 (plain f32
  arithmetic in another order);
- the forward's logits and hidden states: rtol 1e-4, atol 1e-5
  (``tests/test_torch_dense_archs.py``); prefill and decode: 1e-4;
- RTN weights: within one quantization step on < 0.1 % of elements and
  within 1e-3 elsewhere (``test_torch_baselines.py::assert_gptq_close``);
  packed words, scales and zeros bit for bit;
- one train step: loss, grad norm and lr at rtol 1e-5; params within
  ``tests/test_substrate.py``'s train-step bar, rtol 2e-3 / atol 2e-4
  (Adam's first step divides each gradient by its own magnitude, so an
  element whose gradient is near 0 carries the gradient's relative noise
  into its update).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import one_torch_thread, to_np  # noqa: F401
from repro.configs import get_config as jget_config
from repro.core import quant as jq
from repro.core import rtn as jrtn
from repro.core.pipeline import quantize_model as jquantize_model
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import layers as JL
from repro.models import model as jmodel
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import MoEConfig as JMoEConfig
from repro.optim import adamw as ja
from repro.quantized.qmodel import pack_model as jpack_model
from repro_torch.configs import get_config as tget_config
from repro_torch.configs import list_archs as tlist_archs
from repro_torch.convert import params_from_numpy
from repro_torch.core import quant as tq
from repro_torch.core import rtn as trtn
from repro_torch.core.pipeline import quantize_model as tquantize_model
from repro_torch.data.calib import calibration_tokens
from repro_torch.launch import steps as tsteps
from repro_torch.models import layers as TL
from repro_torch.models import model as tmodel
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.models.config import MoEConfig as TMoEConfig
from repro_torch.models.config import check_supported
from repro_torch.optim import adamw as ta
from repro_torch.quantized.qmodel import pack_model as tpack_model
from test_torch_baselines import _grid_position, assert_gptq_close

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PHI = "phi3.5-moe-42b-a6.6b"
MOON = "moonshot-v1-16b-a3b"
MOE_ARCHS = (PHI, MOON)
# moonshot's reduced() keeps E 4 / top-2 as the reference's does; the tests
# override it to its own fine-grained E 64 / top-6
MOON_MOE = dict(num_experts=64, top_k=6, capacity_factor=1.25)
NEAR_TIE = 1e-6      # router-logit gap (relative) under which routing may part


def configs(arch, **moe_over):
    """(reference, port) reduced configs of ``arch``; ``moe_over`` replaces
    fields of its MoEConfig on both sides (moonshot: E 64, top-6 first)."""
    jcfg, tcfg = jget_config(arch).reduced(), tget_config(arch).reduced()
    over = dict(MOON_MOE if arch == MOON else {}, **moe_over)
    if over:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, **over))
        tcfg = dataclasses.replace(
            tcfg, moe=dataclasses.replace(tcfg.moe, **over))
    return jcfg, tcfg


def pair(arch, seed=0, **moe_over):
    """Reduced configs and the reference's init_params carried across."""
    jcfg, tcfg = configs(arch, **moe_over)
    p = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(seed),
                                                    jcfg))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, p), params_from_numpy(p, "cpu")


@pytest.fixture(scope="module", params=MOE_ARCHS, ids=["phi", "moon"])
def moe_pair(request):
    return pair(request.param)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_config_equals_reference_field_for_field(arch):
    jcfg, tcfg = jget_config(arch), tget_config(arch)
    jdefaults = {f.name: f.default for f in dataclasses.fields(JModelConfig)}
    tnames = {f.name for f in dataclasses.fields(TModelConfig)}
    for name, default in jdefaults.items():
        if name == "moe":
            assert dataclasses.asdict(tcfg.moe) == dataclasses.asdict(jcfg.moe)
        elif name in tnames:
            assert getattr(tcfg, name) == getattr(jcfg, name), name
        else:   # a field the port does not carry is at its default there
            assert getattr(jcfg, name) == default, name
    tr, jr = tcfg.reduced(), jcfg.reduced()
    for name in tnames - {"moe"}:
        assert getattr(tr, name) == getattr(jr, name), name
    assert dataclasses.asdict(tr.moe) == dataclasses.asdict(jr.moe) == dict(
        num_experts=4, top_k=2, capacity_factor=1.25)


def test_moe_config_defaults_equal_reference():
    assert [(f.name, f.default) for f in dataclasses.fields(TMoEConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(JMoEConfig)]


@pytest.mark.parametrize("E,K,cf", [(4, 2, 1.25), (16, 2, 1.25), (64, 6, 1.25),
                                    (4, 2, 0.5), (4, 1, 4.0), (8, 3, 1.1)])
def test_capacity_matches_reference(E, K, cf):
    j, t = JMoEConfig(E, K, cf), TMoEConfig(E, K, cf)
    for s in (1, 2, 3, 7, 8, 16, 31, 64, 512, 2048):
        assert t.capacity(s) == j.capacity(s), s


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", sorted(tlist_archs(assigned_only=False)))
def test_param_counts_match_reference(arch, reduced):
    jcfg, tcfg = jget_config(arch), tget_config(arch)
    if reduced:
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()


def test_phi_depth_cut_param_count():
    """phase 11's model: Phi-3.5-MoE at full width, 3 of its 32 layers."""
    cfg = dataclasses.replace(tget_config(PHI), n_layers=3)
    assert cfg.param_count() == 4_165_165_056
    assert cfg.padded_vocab == 32256


def test_check_supported_admits_moe_only_among_the_families():
    """Each family needs its own sub-config; a pattern outside the
    reference's four raises (an encoder-decoder stack is dense with
    encoder layers)."""
    check_supported(tget_config(PHI))
    for pattern in ("ssm", "hybrid"):
        with pytest.raises(ValueError, match="SSMConfig"):
            check_supported(TModelConfig(block_pattern=pattern))
    with pytest.raises(ValueError, match="unknown block_pattern"):
        check_supported(TModelConfig(block_pattern="encoder_decoder"))
    with pytest.raises(ValueError, match="MoEConfig"):
        check_supported(TModelConfig(block_pattern="moe"))


# ---------------------------------------------------------------------------
# moe_ffn, routing, the aux loss
# ---------------------------------------------------------------------------

def _moe_case(arch, seed=0, S=24, B=3, **moe_over):
    """One MoE layer's params (the reference's init_moe) and inputs."""
    jcfg, tcfg = configs(arch, **moe_over)
    jp = JL.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    x = np.random.default_rng(seed).standard_normal(
        (B, S, jcfg.d_model)).astype(np.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, tcfg, jp, tp, x


def _reference_routing(jp, jcfg, x):
    """The reference's routing decisions (``layers.py::moe_ffn``'s first
    lines, verbatim): top-k indices, slot positions, keep, logits."""
    B, S, _ = x.shape
    E, K = jcfg.moe.num_experts, jcfg.moe.top_k
    C = jcfg.moe.capacity(S)
    logits = jnp.asarray(x) @ jp["router"]
    _, gate_idx = jax.lax.top_k(logits, K)
    e_idx = gate_idx.reshape(B, S * K)
    onehot = jax.nn.one_hot(e_idx, E, dtype=jnp.int32)
    pos_all = jnp.cumsum(onehot, axis=1) - 1
    pos = jnp.take_along_axis(pos_all, e_idx[..., None], axis=2)[..., 0]
    return (np.asarray(e_idx), np.asarray(pos), np.asarray(pos < C),
            np.asarray(logits))


def assert_routing_equal(got, want, K, what=""):
    """Routing equal token for token, or parting only at a token whose
    reference K-th / (K+1)-th logits lie within NEAR_TIE relative (an ulp
    decides there; every later slot of that row may then move)."""
    (ge, gp, gk), (we, wp, wk, logits) = got, want
    B = we.shape[0]
    srt = -np.sort(-logits, axis=-1)
    for b in range(B):
        diff = np.flatnonzero((ge[b] != we[b]) | (gp[b] != wp[b])
                              | (gk[b] != wk[b]))
        if len(diff) == 0:
            continue
        s = diff[0] // K
        gap = (srt[b, s, K - 1] - srt[b, s, K]) / abs(srt[b, s, K - 1])
        assert gap < NEAR_TIE, (f"{what}: row {b} token {s} routes "
                                f"differently at a gap of {gap:.3g}")


@pytest.mark.parametrize("arch,cf", [
    (PHI, 4.0), (MOON, 64.0 / 6), (PHI, 0.5), (MOON, 0.5)],
    ids=["phi-nodrop", "moon-nodrop", "phi-drops", "moon-drops"])
def test_moe_ffn_matches_reference(arch, cf):
    """``moe_ffn`` at a capacity that drops nothing (C ≥ S: every token
    fits however it routes; E 4 top-2 at the reference test's factor 4) and
    at factor 0.5, where slots are dropped: routing equal, outputs within
    rtol 1e-5 / atol 1e-6."""
    jcfg, tcfg, jp, tp, x = _moe_case(arch, capacity_factor=cf)
    want = JL.moe_ffn(jp, jcfg, jnp.asarray(x))
    got = TL.moe_ffn(tp, tcfg, torch.from_numpy(x))
    _, e_idx, pos, keep, C = TL.moe_route(tp, tcfg, torch.from_numpy(x))
    assert C == jcfg.moe.capacity(x.shape[1])
    routing = _reference_routing(jp, jcfg, x)
    assert_routing_equal((e_idx.numpy(), pos.numpy(), keep.numpy()), routing,
                         tcfg.moe.top_k, f"{arch} cf {cf}")
    if cf > 1.25:
        assert routing[2].all() and bool(keep.all()), "expected no drops"
    else:
        assert not routing[2].all(), "expected dropped slots"
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_moe_ffn_no_drops_matches_a_per_token_loop():
    """``tests/test_models.py:60-70`` on the port: capacity factor 4 drops
    nothing, so the dispatch equals each token's gate-weighted sum over its
    K experts."""
    jcfg, tcfg, _, tp, x = _moe_case(PHI, capacity_factor=4.0)
    xt = torch.from_numpy(x)
    w, idx = TL.moe_top_k(xt @ tp["router"], tcfg.moe.top_k)
    w = torch.softmax(w, dim=-1)
    act = TL.activation_fn(tcfg.activation)
    want = torch.zeros_like(xt)
    for e in range(tcfg.moe.num_experts):
        y = (act(xt @ tp["gate"][e]) * (xt @ tp["up"][e])) @ tp["down"][e]
        for j in range(tcfg.moe.top_k):
            want += torch.where((idx[..., j] == e)[..., None],
                                w[..., j:j + 1] * y, 0.0)
    np.testing.assert_allclose(to_np(TL.moe_ffn(tp, tcfg, xt)), to_np(want),
                               rtol=2e-4, atol=2e-4)


def test_dropped_tokens_get_zero_and_nothing_is_nan():
    """``tests/test_models.py:73-81`` on the port (top-1, factor 0.5,
    ungated): a token whose only slot is dropped gets exactly 0."""
    cfg = TModelConfig(d_model=16, d_ff=32, vocab_size=64, block_pattern="moe",
                       gated_mlp=False,
                       moe=TMoEConfig(num_experts=4, top_k=1,
                                      capacity_factor=0.5))
    jcfg = JModelConfig(d_model=16, d_ff=32, vocab_size=64,
                        block_pattern="moe", gated_mlp=False,
                        moe=JMoEConfig(num_experts=4, top_k=1,
                                       capacity_factor=0.5))
    jp = JL.init_moe(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(1), (1, 16, 16))))
    out = TL.moe_ffn(tp, cfg, x)
    _, _, _, keep, _ = TL.moe_route(tp, cfg, x)
    assert out.shape == x.shape and not bool(torch.isnan(out).any())
    assert not bool(keep.all())
    assert bool((out[0][~keep[0]] == 0).all())
    np.testing.assert_allclose(to_np(out), np.asarray(JL.moe_ffn(
        jp, jcfg, jnp.asarray(x.numpy()))), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 6])
def test_moe_top_k_orders_ties_like_jax(k):
    """Equal logits come out in ascending index order, as ``jax.lax.top_k``
    gives them (``torch.topk`` promises no order for ties)."""
    rng = np.random.default_rng(k)
    logits = rng.integers(0, 3, size=(5, 7, 16)).astype(np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(logits), k)
    tv, ti = TL.moe_top_k(torch.from_numpy(logits), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("arch", MOE_ARCHS, ids=["phi", "moon"])
def test_moe_aux_loss_matches_reference(arch):
    jcfg, tcfg, jp, tp, x = _moe_case(arch, seed=2)
    want = float(JL.moe_aux_loss(jp, jcfg, jnp.asarray(x)))
    got = float(TL.moe_aux_loss(tp, tcfg, torch.from_numpy(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("arch,cf", [(PHI, 1.25), (MOON, 0.5)],
                         ids=["phi", "moon-drops"])
def test_expert_override_equals_the_stack_that_holds_it(arch, cf):
    """A candidate for expert e given through ``EXPERT_OVERRIDE`` computes
    exactly (``torch.equal``) what a copy of the stacks with expert e
    replaced computes: the search's unit override copies no stack."""
    _, tcfg, _, tp, x = _moe_case(arch, seed=3, capacity_factor=cf)
    rng = np.random.default_rng(5)
    e = tcfg.moe.num_experts - 2
    unit = {k: torch.from_numpy(rng.standard_normal(
        tuple(tp[k].shape[1:])).astype(np.float32)) for k in ("up", "gate",
                                                              "down")}
    stacked = dict(tp)
    for k, v in unit.items():
        stacked[k] = tp[k].clone()
        stacked[k][e] = v
    xt = torch.from_numpy(x)
    want = TL.moe_ffn(stacked, tcfg, xt)
    got = TL.moe_ffn({**tp, TL.EXPERT_OVERRIDE: (e, unit)}, tcfg, xt)
    assert torch.equal(got, want)
    assert not torch.equal(got, TL.moe_ffn(tp, tcfg, xt))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_init_params_tree_matches_reference(moe_pair):
    jcfg, tcfg, jparams, _ = moe_pair
    jflat = _flat(jax.tree.map(np.asarray, jparams))
    tflat = _flat(tmodel.init_params(tcfg, torch.Generator().manual_seed(0),
                                     device="cpu"))
    assert sorted(tflat) == sorted(jflat)
    for path, j in jflat.items():
        assert tuple(tflat[path].shape) == j.shape, path
    assert ("blocks", "mlp", "up") not in tflat
    E = tcfg.moe.num_experts
    assert tflat[("blocks", "moe", "router")].shape == (
        tcfg.n_layers, tcfg.d_model, E)


def test_forward_logits_and_hidden_match_reference(moe_pair):
    jcfg, tcfg, jparams, tparams = moe_pair
    tokens = calibration_tokens(jcfg.vocab_size, n_seqs=2, seq_len=64)
    jl, jh = jmodel.forward(jparams, jcfg, jnp.asarray(tokens),
                            collect_hidden=True)
    tl, th = tmodel.forward(tparams, tcfg, torch.from_numpy(
        tokens.astype(np.int64)), collect_hidden=True)
    assert tuple(tl.shape) == jl.shape and tuple(th.shape) == jh.shape
    np.testing.assert_allclose(to_np(tl), to_np(jl), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to_np(th), to_np(jh), rtol=1e-4, atol=1e-5)


def test_prefill_and_decode_match_reference(moe_pair):
    """The contiguous cache: prefill (S 9, capacity(9) per row) then three
    one-token decode steps (capacity(1) = 1: nothing drops)."""
    jcfg, tcfg, jparams, tparams = moe_pair
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab_size, (3, 9)).astype(np.int32)
    jl, jc = jmodel.prefill(jparams, jcfg, jnp.asarray(toks), 32)
    tl, tc = tmodel.prefill(tparams, tcfg,
                            torch.from_numpy(toks.astype(np.int64)), 32)

    def close(got, want):
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)

    close(tl, jl)
    for key in jc:
        close(tc[key], jc[key])
    for step, tok in enumerate(rng.integers(0, jcfg.vocab_size, (3, 3, 1))):
        tok = tok.astype(np.int32)
        jl, jc = jmodel.decode_step(jparams, jcfg, jnp.asarray(tok), jc,
                                    9 + step)
        tl, tc = tmodel.decode_step(tparams, tcfg,
                                    torch.from_numpy(tok.astype(np.int64)),
                                    tc, 9 + step)
        close(tl, jl)
        for key in jc:
            close(tc[key], jc[key])


# ---------------------------------------------------------------------------
# RTN and packing on (L, E, K, N) expert leaves
# ---------------------------------------------------------------------------

def test_quantizable_paths_take_the_experts_and_skip_the_router(moe_pair):
    _, _, jparams, tparams = moe_pair
    want = jmodel.quantizable_paths(jparams)
    assert tmodel.quantizable_paths(tparams) == want
    assert ("blocks", "moe", "router") not in want
    assert {p[-1] for p in want if p[1] == "moe"} == {"up", "gate", "down"}


def test_rtn_quantize_model_matches_reference(moe_pair):
    """RTN 2-bit g32 through ``quantize_model``: every quantizable leaf
    within the pipeline bar (``assert_gptq_close``), the router and norms
    untouched."""
    jcfg, tcfg, jparams, tparams = moe_pair
    jr = jquantize_model(jparams, jcfg, jq.QuantConfig(2, 32), method="rtn")
    tr = tquantize_model(tparams, tcfg, tq.QuantConfig(2, 32), "rtn",
                         device="cpu")
    assert tr.method == jr.method == "rtn"
    for path in jmodel.quantizable_paths(jparams):
        got = to_np(trtn.get_by_path(tr.params_q, path))
        want = to_np(jrtn.get_by_path(jr.params_q, path))
        assert got.shape == want.shape, path
        flat = (-1,) + want.shape[-2:]
        _, scale = _grid_position(want.reshape(flat), 2, 32)
        assert_gptq_close(got.reshape(flat), want.reshape(flat), scale,
                          f"rtn {path}")
    np.testing.assert_array_equal(
        to_np(tr.params_q["blocks"]["moe"]["router"]),
        np.asarray(jr.params_q["blocks"]["moe"]["router"]))


def test_fake_quant_of_stacked_experts_is_per_expert():
    """``fake_quant`` of an (L, E, K, N) leaf (one flattened call) equals
    the fake-quant of each (K, N) expert on its own."""
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 3, 64, 48)).astype(np.float32))
    qc = tq.QuantConfig(2, 32)
    got = tq.fake_quant(w, qc)
    for i in range(2):
        for e in range(3):
            assert torch.equal(got[i, e], tq.fake_quant(w[i, e], qc))


def test_pack_model_and_dequantize_match_reference(moe_pair):
    """``pack_model`` on the expert leaves: words (the reference's uint32
    bits), scales and zeros equal, metadata equal, and a layer's slice
    dequantises to the reference's (E, K, N)."""
    jcfg, tcfg, jparams, tparams = moe_pair
    jpq = jpack_model(jparams, jq.QuantConfig(2, 32))
    tpq = tpack_model(tparams, tq.QuantConfig(2, 32))
    for k in ("up", "gate", "down"):
        jt, tt = jpq["blocks"]["moe"][k], tpq["blocks"]["moe"][k]
        assert tt.shape == tuple(jt.shape) and tt.bits == jt.bits
        assert tt.group_size == jt.group_size
        np.testing.assert_array_equal(
            tt.packed.numpy(), np.asarray(jt.packed).view(np.int32))
        np.testing.assert_array_equal(tt.scale.numpy(), np.asarray(jt.scale))
        np.testing.assert_array_equal(tt.zero.numpy(), np.asarray(jt.zero))
        layer = tmodel.layer_slice(tpq["blocks"], 1)["moe"][k]
        want = np.asarray(jt.dequantize())[1]
        got = to_np(layer.dequantize())
        assert got.shape == (tcfg.moe.num_experts,) + tuple(jt.shape)
        np.testing.assert_array_equal(got, want)
    # the packed model serves the same logits as its dequantised weights
    tokens = torch.from_numpy(calibration_tokens(
        jcfg.vocab_size, n_seqs=1, seq_len=16).astype(np.int64))
    np.testing.assert_allclose(
        to_np(tmodel.forward(tpq, tcfg, tokens)),
        to_np(tmodel.forward(tmodel.dequant_tree(tpq), tcfg, tokens)),
        rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# one train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE_ARCHS, ids=["phi", "moon"])
def test_train_step_matches_reference(arch):
    """One ``make_train_step`` step on the reduced MoE config (the
    reference's generic step: LM loss only, no aux loss): loss, grad norm
    and lr at rtol 1e-5, every new param within rtol 2e-3 / atol 2e-4."""
    jcfg, tcfg, jp, tp = pair(arch)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                               (4, 32)).astype(np.int32)
    jo = dict(lr=1e-3, total_steps=10, warmup_steps=2)
    jnew, _, jm = jax.jit(jmake_train_step(jcfg, ja.AdamWConfig(**jo)))(
        jp, ja.adamw_init(jp), {"tokens": jnp.asarray(tokens)})
    tnew, tst, tm = tsteps.make_train_step(tcfg, ta.AdamWConfig(**jo))(
        tp, ta.adamw_init(tp), {"tokens": torch.from_numpy(tokens)})
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    jflat = _flat(jax.tree.map(np.asarray, jnew))
    tflat = _flat(tnew)
    assert sorted(tflat) == sorted(jflat)
    for path, j in jflat.items():
        np.testing.assert_allclose(to_np(tflat[path]), j, rtol=2e-3,
                                   atol=2e-4, err_msg="/".join(path))
    assert int(tst["step"]) == 1
