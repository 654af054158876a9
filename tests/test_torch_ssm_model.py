"""Port parity of the SSM and hybrid model families: configs, the param
tree, the forward, prefill + decode and the search's layer override.

Configs: ``mamba2-2.7b`` and ``zamba2-7b`` (their ``reduced()`` sizes: 2
SSM blocks; 6 Mamba blocks around one application of the shared block).
Weights are the reference's ``init_params`` carried across with
``params_from_numpy``. Bars (measured worst case on the CPU beside each):

- ``forward`` logits and ``collect_hidden`` taps: 1e-4 abs + rel
  (measured ≤ 5.3e-6 for the logits, ≤ 1.2e-5 for the taps);
- prefill + 3 decode steps: logits and caches within 1e-4 of the
  reference's own prefill + decode (measured ≤ 4.6e-6), and the decode
  logits within the reference's 2e-2 of the port's own full forward
  (``tests/test_models.py``; measured ≤ 2.4e-6);
- the search's layer override: ``torch.equal`` to the forward over a copy
  of the stack holding the unit;
- the fp32 train step (AdamW at lr 1e-3 after 2 warm-up steps, as the
  other train-step tests run it), 3 steps on 4 x 32 tokens: loss and grad
  norm of each step within rtol 1e-5, every leaf after the third step
  within ``tests/test_substrate.py``'s rtol 2e-3 / atol 2e-4 (measured ≤
  0.07 of it).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import one_torch_thread, to_np  # noqa: F401
from repro.configs import get_config as jget_config
from repro.launch import steps as jsteps
from repro.models import model as jmodel
from repro.optim import adamw as ja
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import search as tcs
from repro_torch.launch import steps as tsteps
from repro_torch.models import model as tmodel
from repro_torch.models.config import (ModelConfig, SSMConfig,
                                       check_supported)
from repro_torch.optim import adamw as ta

pytestmark = pytest.mark.usefixtures("one_torch_thread")
ARCHS = ("mamba2-2.7b", "zamba2-7b")
IDS = ["mamba2", "zamba2"]
TOL = dict(rtol=1e-4, atol=1e-4)


def pair(arch, seed=0):
    """Reduced configs and the reference's init_params carried across."""
    jcfg, tcfg = jget_config(arch).reduced(), tget_config(arch).reduced()
    p = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(seed),
                                                    jcfg))
    return jcfg, tcfg, jax.tree.map(jnp.asarray, p), params_from_numpy(p, "cpu")


@pytest.fixture(scope="module", params=ARCHS, ids=IDS)
def ssm_pair(request):
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

@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_configs_equal_reference_field_for_field(arch):
    jcfg, tcfg = jget_config(arch), tget_config(arch)
    for cfg_j, cfg_t in ((jcfg, tcfg), (jcfg.reduced(), tcfg.reduced())):
        for f in dataclasses.fields(cfg_t):
            if f.name == "ssm":
                assert dataclasses.asdict(cfg_t.ssm) == \
                    dataclasses.asdict(cfg_j.ssm)
            else:
                assert getattr(cfg_t, f.name) == getattr(cfg_j, f.name), \
                    f.name
        assert cfg_t.param_count() == cfg_j.param_count()
        assert cfg_t.active_param_count() == cfg_j.active_param_count()
        assert cfg_t.attn_free == cfg_j.attn_free
        assert cfg_t.hybrid_layout() == cfg_j.hybrid_layout()


def test_ssm_config_defaults_equal_reference():
    from repro.models.config import SSMConfig as JSSMConfig
    assert [(f.name, f.default) for f in dataclasses.fields(SSMConfig)] == [
        (f.name, f.default) for f in dataclasses.fields(JSSMConfig)]
    for d in (64, 2560, 3584):
        assert SSMConfig().d_inner(d) == JSSMConfig().d_inner(d)
        assert SSMConfig().n_heads(d) == JSSMConfig().n_heads(d)


def test_hybrid_layout_counts_at_full_size():
    cfg = tget_config("zamba2-7b")
    assert cfg.hybrid_layout() == (68, 13)
    assert tget_config("zamba2-7b").reduced().hybrid_layout() == (6, 1)
    cut = dataclasses.replace(cfg, n_layers=13)     # chip smoke phase 12c
    assert cut.hybrid_layout() == (11, 2)
    assert cut.param_count() == dataclasses.replace(
        jget_config("zamba2-7b"), n_layers=13).param_count() == 1_292_582_512
    assert tget_config("mamba2-2.7b").attn_free
    assert not cfg.attn_free


def test_param_counts_at_full_size():
    """The reference's analytic counts (its parameter tree, minus the final
    norm, which it does not count)."""
    assert tget_config("mamba2-2.7b").param_count() == \
        jget_config("mamba2-2.7b").param_count() == 2_831_727_616
    assert tget_config("zamba2-7b").param_count() == \
        jget_config("zamba2-7b").param_count() == 5_736_916_288


def test_check_supported_admits_ssm_and_hybrid():
    for arch in ARCHS:
        check_supported(tget_config(arch))
    for pattern in ("ssm", "hybrid"):
        with pytest.raises(ValueError, match="SSMConfig"):
            check_supported(ModelConfig(block_pattern=pattern))
    with pytest.raises(ValueError, match="unknown block_pattern"):
        check_supported(ModelConfig(block_pattern="encoder_decoder"))


# ---------------------------------------------------------------------------
# init, forward, decode
# ---------------------------------------------------------------------------

def test_init_params_tree_matches_reference(ssm_pair):
    """The port's own init has the reference's leaves, shapes and dtypes
    (the shared block of a hybrid stack unstacked)."""
    jcfg, tcfg, jparams, _ = ssm_pair
    own = tmodel.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    jflat, tflat = _flat(jparams), _flat(own)
    assert sorted(tflat) == sorted(jflat)
    for k, v in tflat.items():
        assert tuple(v.shape) == jflat[k].shape, k
        assert str(v.dtype).split(".")[1] == jflat[k].dtype.name, k
    if tcfg.block_pattern == "hybrid":
        assert own["shared"]["mlp"]["up"].ndim == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_own_init_runs_forward_and_decode(dtype):
    """The port's own init, in the config's dtype: forward finite, and
    A_log / D / dt_bias stay f32 in a bf16 tree."""
    for arch in ARCHS:
        cfg = dataclasses.replace(tget_config(arch).reduced(),
                                  param_dtype=dtype, compute_dtype=dtype)
        p = tmodel.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
        ssm = p["blocks"]["ssm"]
        assert ssm["A_log"].dtype == ssm["D"].dtype == \
            ssm["dt_bias"].dtype == torch.float32
        assert ssm["w_x"].dtype == getattr(torch, dtype)
        toks = torch.randint(0, cfg.vocab_size, (2, 12),
                             generator=torch.Generator().manual_seed(2))
        logits = tmodel.forward(p, cfg, toks)
        assert bool(torch.isfinite(logits.float()).all())
        lg, cache = tmodel.prefill(p, cfg, toks[:, :8], 16)
        lg, cache = tmodel.decode_step(p, cfg, toks[:, 8:9], cache, 8)
        assert bool(torch.isfinite(lg.float()).all())


def test_forward_and_taps_match_reference(ssm_pair):
    jcfg, tcfg, jparams, tparams = ssm_pair
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 40))
    jl, jh = jmodel.forward(jparams, jcfg, jnp.asarray(toks),
                            collect_hidden=True)
    tl, th = tmodel.forward(tparams, tcfg, torch.from_numpy(toks),
                            collect_hidden=True)
    n_taps = tcfg.n_layers if tcfg.block_pattern == "ssm" \
        else tcfg.hybrid_layout()[1]
    assert tuple(th.shape) == jh.shape == (n_taps, 2, 40, tcfg.d_model)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


def test_prefill_decode_match_reference(ssm_pair):
    jcfg, tcfg, jparams, tparams = ssm_pair
    B, T, K = 2, 16, 3
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (B, T + K))
    full = tmodel.forward(tparams, tcfg, torch.from_numpy(toks))
    jlg, jcache = jmodel.prefill(jparams, jcfg, jnp.asarray(toks[:, :T]),
                                 T + K + 1)
    tlg, tcache = tmodel.prefill(tparams, tcfg, torch.from_numpy(toks[:, :T]),
                                 T + K + 1)
    np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL)
    np.testing.assert_allclose(tlg[:, -1].numpy(), full[:, T - 1].numpy(),
                               rtol=2e-2, atol=2e-2)
    for i in range(K):
        step = toks[:, T + i:T + i + 1]
        jlg, jcache = jmodel.decode_step(jparams, jcfg, jnp.asarray(step),
                                         jcache, jnp.int32(T + i))
        tlg, tcache2 = tmodel.decode_step(tparams, tcfg,
                                          torch.from_numpy(step), tcache,
                                          T + i)
        assert tcache2 is tcache                  # written in place
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **TOL)
        np.testing.assert_allclose(tlg[:, 0].numpy(), full[:, T + i].numpy(),
                                   rtol=2e-2, atol=2e-2)
    jflat, tflat = _flat(jcache), _flat(tcache)
    assert sorted(tflat) == sorted(jflat)
    for k, v in tflat.items():
        assert tuple(v.shape) == jflat[k].shape, k
        np.testing.assert_allclose(to_np(v), np.asarray(jflat[k]), **TOL)


def test_init_cache_matches_reference_layout(ssm_pair):
    jcfg, tcfg, _, _ = ssm_pair
    jc = _flat(jmodel.init_cache(jcfg, 3, 24))
    tc = _flat(tmodel.init_cache(tcfg, 3, 24, device="cpu"))
    assert sorted(tc) == sorted(jc)
    for k, v in tc.items():
        assert tuple(v.shape) == jc[k].shape and not v.any(), k
        assert str(v.dtype).split(".")[1] == jc[k].dtype.name, k


def test_block_order_runs_groups_then_the_tail():
    cfg = dataclasses.replace(tget_config("zamba2-7b").reduced(), n_layers=13)
    order = tmodel.block_order(cfg)
    assert order[:6] == [("ssm", u) for u in range(5)] + [("shared", 0)]
    assert order[6:] == [("ssm", u) for u in range(5, 10)] + \
        [("shared", 1), ("ssm", 10)]
    assert tmodel.block_order(tget_config("mamba2-2.7b").reduced()) == [
        ("ssm", 0), ("ssm", 1)]


@pytest.mark.parametrize("unit", ["mamba-tail", "mamba-0", "shared"])
def test_layer_override_equals_installing_the_unit(unit):
    """The override keyed by a Mamba unit (the u-th SSM block of the stack:
    in the hybrid stack block 5 runs after the shared block) and by the
    shared unit (every application) gives the logits and taps of a forward
    over a copy of the stack holding the unit, bit for bit."""
    jcfg, tcfg, _, tparams = pair("zamba2-7b")
    shared = unit == "shared"
    ad = tcs.make_adapter(tcfg, phase="shared" if shared else None)
    u = {"mamba-tail": ad.n_units - 1, "mamba-0": 0, "shared": 0}[unit]
    base = ad.base_stack(tparams)
    g = torch.Generator().manual_seed(3)
    cand = {k: v[u] + 0.05 * torch.randn(v[u].shape, generator=g)
            for k, v in base.items()}
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (2, 24)))
    got = tmodel.forward(ad.install(tparams, base), tcfg, toks,
                         collect_hidden=True,
                         layer_override=ad.unit_override(u, cand))
    want = tmodel.forward(ad.install(tparams, ad.install_unit(base, u, cand)),
                          tcfg, toks, collect_hidden=True)
    plain = tmodel.forward(tparams, tcfg, toks, collect_hidden=True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not torch.equal(got[0], plain[0])
    # the tail block runs after the only tap
    assert torch.equal(got[1], plain[1]) == (unit == "mamba-tail")


def test_layer_override_on_a_mamba_stack():
    _, tcfg, _, tparams = pair("mamba2-2.7b")
    ad = tcs.make_adapter(tcfg)
    base = ad.base_stack(tparams)
    cand = {k: v[1] * 1.5 for k, v in base.items()}
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, tcfg.vocab_size, (1, 20)))
    got = tmodel.forward(tparams, tcfg, toks,
                         layer_override=ad.unit_override(1, cand))
    want = tmodel.forward(ad.install(tparams, ad.install_unit(base, 1, cand)),
                          tcfg, toks)
    assert torch.equal(got, want)


@pytest.mark.parametrize("arch", ARCHS, ids=IDS)
def test_train_steps_match_reference(arch):
    """Three fp32 train steps through ``models/ssm.py``'s autograd path
    (the conv, the chunked scan, the gated RMSNorm; the hybrid's shared
    block too), each on the previous step's parameters and optimizer
    state, against the reference's jitted step."""
    jcfg, tcfg, jp, tp = pair(arch)
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                               (3, 4, 32)).astype(np.int32)
    opt = dict(lr=1e-3, total_steps=10, warmup_steps=2)
    jstep = jax.jit(jsteps.make_train_step(jcfg, ja.AdamWConfig(**opt)))
    tstep = tsteps.make_train_step(tcfg, ta.AdamWConfig(**opt))
    js, ts = ja.adamw_init(jp), ta.adamw_init(tp)
    for i, toks in enumerate(tokens):
        jp, js, jm = jstep(jp, js, {"tokens": jnp.asarray(toks)})
        tp, ts, tm = tstep(tp, ts, {"tokens": torch.from_numpy(toks)})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       err_msg=f"{k} at step {i}")
    jflat, tflat = _flat(jax.tree.map(np.asarray, jp)), _flat(tp)
    assert sorted(tflat) == sorted(jflat)
    for path, j in jflat.items():
        np.testing.assert_allclose(to_np(tflat[path]), j, rtol=2e-3,
                                   atol=2e-4, err_msg="/".join(path))
