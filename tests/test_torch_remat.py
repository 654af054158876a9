"""Port parity: activation remat (``ModelConfig.remat`` / ``remat_policy``,
``models/model.py::_maybe_remat``) and the reference's dry-run-only config
fields.

Bars:
- one train step's loss and gradients with remat on ("full", "dots",
  "dots_all") against remat off, in every family's reduced config, f32 and
  its own bf16: equal bit for bit (``torch.equal``) — the recompute draws
  no random numbers and runs the same ops on the same values;
- the port's remat train step against the reference's ``remat=True``
  train step, from the same weights and batch: loss, ``grad_norm`` and
  ``lr`` at rtol 1e-5 (``tests/test_torch_train.py``'s train-step bar);
  the first moment m = (1 - β1)·g, the step's gradients, within 1e-5 of
  each leaf's scale (max |m|) — the packages sum in other orders, 4e-6 of
  the scale seen; a key bias whose exact gradient is 0 (``xattn/bk``, and
  ``attn/bk`` without RoPE: softmax is shift-invariant per query, while
  RoPE rotates the bias by position), within 1e-5 of the tree's largest
  |m| on both sides
  (the updated params are not held element-wise: Adam's first step moves
  each element by ≈ lr·sign(g), so a gradient at rounding noise moves a
  whole step either way);
- ``unroll_layers`` / ``unroll_inner``: the same logits, bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import one_torch_thread  # noqa: F401
from repro.configs import get_config as jget_config
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models.model import init_params as jinit_params
from repro.optim import adamw as ja
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.launch.steps import _loss_fn, _value_and_grad, make_train_step
from repro_torch.models import model as M
from repro_torch.optim import adamw as ta
from repro_torch.optim.adamw import tree_leaves

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FAMILIES = ("opt-tiny", "qwen3-4b", "phi3.5-moe-42b-a6.6b", "mamba2-2.7b",
            "zamba2-7b", "seamless-m4t-medium", "internvl2-1b")
POLICIES = ("full", "dots", "dots_all")
OPT = dict(lr=1e-3, total_steps=10, warmup_steps=2)
ZERO_GRAD = ("xattn/bk", "attn/bk")   # the second only without RoPE
B, S = 2, 16


def _batch_np(cfg, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        out["vision_embeds"] = (0.5 * rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model))).astype(np.float32)
    if cfg.is_enc_dec:
        out["enc_embeds"] = (0.5 * rng.standard_normal(
            (B, 12, cfg.d_model))).astype(np.float32)
    return out


def _port_batch(batch_np, dtype=torch.float32):
    return {k: (torch.from_numpy(v) if k == "tokens"
                else torch.from_numpy(v).to(dtype))
            for k, v in batch_np.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_grads_equal_remat_off_bit_for_bit(arch, dtype):
    cfg = tget_config(arch).reduced(param_dtype=dtype, compute_dtype=dtype)
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    batch = _port_batch(_batch_np(cfg), getattr(torch, dtype))
    loss0, g0 = _value_and_grad(_loss_fn(cfg), params, batch)
    g0 = tree_leaves(g0)
    for pol in POLICIES:
        c = dataclasses.replace(cfg, remat=True, remat_policy=pol)
        loss, g = _value_and_grad(_loss_fn(c), params, batch)
        assert torch.equal(loss, loss0), (pol, float(loss), float(loss0))
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g), g0)), pol
    off = dataclasses.replace(cfg, remat=True, remat_policy="none")
    assert M._maybe_remat(len, off) is len
    assert M._maybe_remat(len, cfg) is len


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (str(k),))
    else:
        yield "/".join(path), tree


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_train_step_equals_reference(arch):
    jcfg = dataclasses.replace(jget_config(arch).reduced(), remat=True)
    tcfg = dataclasses.replace(tget_config(arch).reduced(), remat=True)
    jp = jinit_params(jax.random.PRNGKey(0), jcfg)
    batch = _batch_np(tcfg)
    _, jst, jm = jax.jit(jmake_train_step(jcfg, ja.AdamWConfig(**OPT)))(
        jp, ja.adamw_init(jp), {k: jnp.asarray(v) for k, v in batch.items()})
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    _, tst, tm = make_train_step(tcfg, ta.AdamWConfig(**OPT))(
        tp, ta.adamw_init(tp), _port_batch(batch))
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    jmom = dict(_flat(jax.tree.map(np.asarray, jst["m"])))
    tmom = {k: v.numpy() for k, v in _flat(tst["m"])}
    assert tmom.keys() == jmom.keys()
    top = max(np.abs(v).max() for v in jmom.values())
    zero = ZERO_GRAD if tcfg.pos_emb != "rope" else ZERO_GRAD[:1]
    for k, want in jmom.items():
        got = tmom[k]
        if k.endswith(zero):
            assert np.abs(got).max() <= 1e-5 * top, k
            assert np.abs(want).max() <= 1e-5 * top, k
        else:
            scale = np.abs(want).max()
            assert np.abs(got - want).max() <= 1e-5 * scale, (
                k, np.abs(got - want).max() / scale)


def test_remat_units_follow_the_reference_scan_bodies():
    """A block a unit, except the hybrid stack's groups (its Mamba blocks
    with the shared block after them) and its tail blocks one by one."""
    for arch in ("opt-tiny", "phi3.5-moe-42b-a6.6b", "mamba2-2.7b"):
        cfg = tget_config(arch).reduced()
        assert M.remat_units(cfg) == [[b] for b in M.block_order(cfg)]
    cfg = tget_config("zamba2-7b").reduced(n_layers=14)   # period 6
    units = M.remat_units(cfg)
    assert [len(u) for u in units] == [6, 6, 1, 1]
    assert [u[-1][0] for u in units] == ["shared", "shared", "ssm", "ssm"]
    assert sum(units, []) == M.block_order(cfg)


@pytest.mark.parametrize("arch", ["qwen3-4b", "zamba2-7b"])
def test_unroll_flags_change_nothing(arch):
    cfg = tget_config(arch).reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    tokens = torch.from_numpy(_batch_np(cfg)["tokens"])
    want = M.forward(params, cfg, tokens)
    got = M.forward(params, dataclasses.replace(
        cfg, unroll_layers=True, unroll_inner=True), tokens)
    assert torch.equal(got, want)


def test_remat_forward_without_grad_runs_the_plain_body():
    """No autograd, no checkpoint: the forward's values are the same."""
    cfg = tget_config("opt-tiny").reduced()
    params = M.init_params(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    tokens = torch.from_numpy(_batch_np(cfg)["tokens"])
    with torch.no_grad():
        want = M.forward(params, cfg, tokens)
        got = M.forward(params, dataclasses.replace(cfg, remat=True),
                        tokens)
    assert torch.equal(got, want)
