"""bf16 parity of the port on the dense zoo configs in their own dtype: the
reduced configs with ``param_dtype = compute_dtype = "bfloat16"``, the same
numpy weights (drawn by the reference in bf16) and inputs on both sides.

The reference runs as it compiles on the CPU: each bf16 operation rounds
to bf16, except where XLA keeps an intermediate in f32 (a residual sum
feeding the next norm's upcast, the MoE combine's products inside their
sum); the port rounds at the same points (``models/layers.py``). What
remains is XLA's and PyTorch's f32 ``exp`` parting by an ulp, which moves a
bf16 rounding on ~0.2 % of the first block's outputs; later blocks carry
that on.

Bars (the unit is a bf16 ulp of a tensor's scale, ``2 ** (floor(log2
max|ref|) - 7)``):
- the kernels' plain versions: ``fake_quant`` (``group_quant(round_range=
  True)``: the range and scale rounded to bf16 as the reference's
  ``compute_qparams`` does on a bf16 w) bit for bit equal to the
  reference's ``fake_quant``; ``transform_quant_ref`` on a bf16 w returns
  bf16 fq (the Pallas kernel's ``out_shape``) and is held to the Pallas
  kernel in interpret mode as the f32 case is (``test_torch_kernels.py``):
  within one quantisation step, and off by a step on < 0.1 % of the
  elements;
- forward logits and per-block outputs: every element within 2 ulps of the
  tensor's scale of the reference's bf16 forward, and the port no farther
  from the reference's fp32 forward (the same weights widened) than 1.25 x
  the reference's bf16 forward is, by max abs and by RMS; the same for
  ``attn_softmax_dtype="bfloat16"`` / ``gqa_repeat_kv=True``, with prefill
  and 3 decode steps (logits at the forward's bar);
- Phi-3.5-MoE reduced (the third fault: the port summed the gate-weighted
  expert outputs in bf16, the reference's compiled sum keeps the products
  in f32): the forward bars, which held it off by 0.28 at a logit scale of
  4.7 before the repair;
The base methods and the search are held in ``test_torch_bf16_search.py``,
the servers in ``test_torch_bf16_serve.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import assert_within_one_step, one_torch_thread, to_np  # noqa: F401
from repro.configs import get_config as jget_config
from repro.core import quant as jq
from repro.kernels.transform_quant import transform_quant_pallas
from repro.models import model as jmodel
from repro_torch import kernels as tk
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import quant as tq
from repro_torch.data.calib import calibration_tokens
from repro_torch.kernels import ref as tref
from repro_torch.models import model as tmodel
from test_torch_dense_archs import _perturb_norms

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
DENSE = ("qwen3-4b", "yi-6b", "internlm2-1.8b", "command-r-35b")
MOE = "phi3.5-moe-42b-a6.6b"
ULPS = 2              # elementwise bar, in bf16 ulps of the tensor's scale
FARTHER = 1.25        # port vs fp32 against reference bf16 vs fp32


def _pair(arch, seed=0, **over):
    """(jcfg, tcfg, jparams bf16, tparams bf16, jparams widened to f32,
    jcfg in f32) at the reduced size in bf16."""
    jcfg = jget_config(arch).reduced(**BF16, **over)
    tcfg = tget_config(arch).reduced(**BF16, **over)
    p = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(seed),
                                                    jcfg))
    p = _perturb_norms(p, np.random.default_rng(seed))
    p32 = jax.tree.map(lambda a: jnp.asarray(a.astype(np.float32)), p)
    jcfg32 = dataclasses.replace(jcfg, param_dtype="float32",
                                 compute_dtype="float32")
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, p), params_from_numpy(p, "cpu"),
            p32, jcfg32)


def _ulp_of_scale(ref):
    return 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)


def assert_bf16_close(got, want, want32, what, ulps=ULPS):
    """The forward bars of the module docstring on one tensor (``ulps``
    elementwise)."""
    got, want, want32 = (to_np(x).astype(np.float64)
                         for x in (got, want, want32))
    bar = ulps * _ulp_of_scale(want)
    err = np.abs(got - want)
    assert err.max() <= bar, (f"{what}: {err.max():.4g} > {ulps} ulps of the "
                              f"scale ({bar:.4g}); equal on "
                              f"{np.mean(err == 0):.2%}")
    ours, theirs = got - want32, want - want32
    for name, f in (("max", lambda d: np.abs(d).max()),
                    ("rms", lambda d: np.sqrt(np.mean(d * d)))):
        assert f(ours) <= FARTHER * f(theirs), (
            f"{what}: {name} off fp32 {f(ours):.4g} > {FARTHER} x the "
            f"reference bf16's {f(theirs):.4g}")


# ---------------------------------------------------------------------------
# the kernels' plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 128), (128, 32), (3, 64, 96)])
def test_fake_quant_bf16_equals_reference(shape):
    w = (0.1 * np.random.default_rng(0).standard_normal(shape)).astype(
        jnp.bfloat16)
    want = jq.fake_quant(jnp.asarray(w), jq.QuantConfig(2, 32))
    got = tq.fake_quant(params_from_numpy(w, "cpu"), tq.QuantConfig(2, 32))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_np(got), to_np(want))
    # the TPU kernel's f32 range parts from it on a bf16 w: the flag matters
    fq32 = tref.group_quant_ref(params_from_numpy(w, "cpu").reshape(
        -1, shape[-1]), 2, 32)[0].reshape(shape)
    assert not torch.equal(fq32, got)


@pytest.mark.parametrize("mode", ["up", "down"])
def test_transform_quant_plain_bf16_matches_pallas(mode):
    rng = np.random.default_rng(3)
    D, F, group = 64, 128, 32
    shape = (D, F) if mode == "up" else (F, D)
    w = rng.standard_normal(shape).astype(jnp.bfloat16)
    pi = rng.permutation(F)
    s = (1 + 0.1 * rng.standard_normal(F)).astype(np.float32)
    phi = (0.3 * rng.standard_normal(F // 2)).astype(np.float32)
    fq, scale, zero = tk.transform_quant(      # the wrapper: plain on the CPU
        params_from_numpy(w, "cpu"), torch.from_numpy(pi.astype(np.int64)),
        torch.from_numpy(s), torch.from_numpy(phi), bits=2, group=group,
        mode=mode)
    jfq, jscale, jzero = transform_quant_pallas(
        jnp.asarray(w), jnp.asarray(pi.astype(np.int32)), jnp.asarray(s),
        jnp.asarray(phi), bits=2, group=group, mode=mode, interpret=True)
    assert fq.dtype == torch.bfloat16 and jfq.dtype == jnp.bfloat16
    assert scale.dtype == zero.dtype == torch.float32
    assert_within_one_step(fq, jfq, jscale, group)
    np.testing.assert_allclose(to_np(scale), to_np(jscale), rtol=1e-6)


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

def _forwards(pair, tokens):
    jcfg, tcfg, jp, tp, jp32, jcfg32 = pair
    jl, jh = jmodel.forward(jp, jcfg, jnp.asarray(tokens), collect_hidden=True)
    l32, h32 = jmodel.forward(jp32, jcfg32, jnp.asarray(tokens),
                              collect_hidden=True)
    tl, th = tmodel.forward(tp, tcfg, torch.from_numpy(
        tokens.astype(np.int64)), collect_hidden=True)
    assert tl.dtype == th.dtype == torch.bfloat16
    return (tl, jl, l32), (th, jh, h32)


@pytest.mark.parametrize("arch", DENSE + (MOE,))
def test_forward_bf16_within_the_dtype_bar(arch):
    pair = _pair(arch)
    tokens = calibration_tokens(pair[0].vocab_size, n_seqs=2, seq_len=64)
    (tl, jl, l32), (th, jh, h32) = _forwards(pair, tokens)
    assert_bf16_close(tl, jl, l32, f"{arch} logits")
    for i in range(th.shape[0]):
        assert_bf16_close(th[i], jh[i], h32[i], f"{arch} block {i}")


@pytest.mark.parametrize("sdt,repeat", [("bfloat16", False), ("float32", True),
                                        ("bfloat16", True)],
                         ids=["bf16-scores", "repeat-kv", "both"])
def test_attention_options_match_reference(sdt, repeat):
    pair = _pair("qwen3-4b", attn_softmax_dtype=sdt, gqa_repeat_kv=repeat)
    jcfg, tcfg, jp, tp, jp32, jcfg32 = pair
    tokens = calibration_tokens(jcfg.vocab_size, n_seqs=2, seq_len=64)
    (tl, jl, l32), (th, jh, h32) = _forwards(pair, tokens)
    assert_bf16_close(tl, jl, l32, "logits")
    assert_bf16_close(th[-1], jh[-1], h32[-1], "last block")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jcfg.vocab_size, (3, 9)).astype(np.int32)
    jl, jc = jmodel.prefill(jp, jcfg, jnp.asarray(toks), 32)
    l32, c32 = jmodel.prefill(jp32, jcfg32, jnp.asarray(toks), 32)
    tl, tc = tmodel.prefill(tp, tcfg, torch.from_numpy(toks.astype(np.int64)),
                            32)
    assert tc["k"].dtype == torch.bfloat16
    assert_bf16_close(tl, jl, l32, "prefill logits")
    for step, tok in enumerate(rng.integers(0, jcfg.vocab_size, (3, 3, 1))):
        tok = tok.astype(np.int32)
        jl, jc = jmodel.decode_step(jp, jcfg, jnp.asarray(tok), jc, 9 + step)
        l32, c32 = jmodel.decode_step(jp32, jcfg32, jnp.asarray(tok), c32,
                                      9 + step)
        tl, tc = tmodel.decode_step(tp, tcfg,
                                    torch.from_numpy(tok.astype(np.int64)),
                                    tc, 9 + step)
        assert_bf16_close(tl, jl, l32, f"decode step {step}")
