"""Port parity: ``repro_torch.core.quant`` vs ``repro.core.quant``.

The same numpy inputs go through both packages. Codes and scales must be
exact (including exact .5 ties, which both round half to even); fake-quant
weights within one quantization step (the reference kernel bar, at most a
step on < 0.1 % of elements — in practice they are equal).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import assert_within_one_step, to_np
from repro.core import quant as jq
from repro_torch.core import quant as tq

BITS = [1, 2, 3, 4, 5, 6, 7, 8]


def _tie_weights(bits, group, n_groups, n_cols, seed):
    """(n_groups*group, n_cols) weights whose every group spans exactly
    [lo, lo + q_max] on a 0.5 grid: scale == 1 exactly, so w / scale lands
    on exact .5 ties, and -min / scale is itself a tie when lo is a half."""
    rng = np.random.default_rng(seed)
    q_max = (1 << bits) - 1
    lo = rng.choice([0.0, -0.5, -1.5, -2.5, -1.0], size=(n_groups, 1, n_cols))
    steps = rng.integers(0, 2 * q_max + 1, size=(n_groups, group, n_cols))
    w = lo + 0.5 * steps
    w[:, 0] = lo[:, 0]                 # pin the group minimum
    w[:, 1] = lo[:, 0] + q_max         # and maximum
    return w.reshape(n_groups * group, n_cols).astype(np.float32)


@pytest.mark.parametrize("bits", BITS)
def test_qparams_and_codes_exact_on_ties(bits):
    group = 8
    w = _tie_weights(bits, group, n_groups=6, n_cols=16, seed=bits)
    jc = jq.QuantConfig(bits=bits, group_size=group)
    tc = tq.QuantConfig(bits=bits, group_size=group)
    js, jz = jq.compute_qparams(jnp.asarray(w), jc)
    ts, tz = tq.compute_qparams(torch.from_numpy(w), tc)
    np.testing.assert_array_equal(to_np(ts), to_np(js))
    np.testing.assert_array_equal(to_np(tz), to_np(jz))
    assert np.all(to_np(ts) == 1.0)           # the tie construction held
    jcodes = jq.quantize_codes(jnp.asarray(w), js, jz, jc)
    tcodes = tq.quantize_codes(torch.from_numpy(w), ts, tz, tc)
    np.testing.assert_array_equal(to_np(tcodes), to_np(jcodes))
    assert tcodes.dtype == torch.int32
    np.testing.assert_array_equal(
        to_np(tq.dequantize_codes(tcodes, ts, tz, tc)),
        to_np(jq.dequantize_codes(jcodes, js, jz, jc)))


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("group", [16, 32])
def test_fake_quant_matches_reference(bits, group):
    rng = np.random.default_rng(100 * bits + group)
    w = (rng.standard_normal((128, 24)) * 2.5).astype(np.float32)
    jc = jq.QuantConfig(bits=bits, group_size=group)
    tc = tq.QuantConfig(bits=bits, group_size=group)
    js, jz = jq.compute_qparams(jnp.asarray(w), jc)
    ts, tz = tq.compute_qparams(torch.from_numpy(w), tc)
    np.testing.assert_array_equal(to_np(ts), to_np(js))
    np.testing.assert_array_equal(to_np(tz), to_np(jz))
    np.testing.assert_array_equal(
        to_np(tq.quantize_codes(torch.from_numpy(w), ts, tz, tc)),
        to_np(jq.quantize_codes(jnp.asarray(w), js, jz, jc)))
    got = tq.fake_quant(torch.from_numpy(w), tc)
    want = jq.fake_quant(jnp.asarray(w), jc)
    assert got.dtype == torch.float32 and got.shape == w.shape
    assert_within_one_step(got, want, js, group)


@pytest.mark.parametrize("bits", [2, 4])
def test_fake_quant_ties_match_reference(bits):
    w = _tie_weights(bits, 8, n_groups=4, n_cols=8, seed=7 + bits)
    jc = jq.QuantConfig(bits=bits, group_size=8)
    got = tq.fake_quant(torch.from_numpy(w),
                        tq.QuantConfig(bits=bits, group_size=8))
    np.testing.assert_array_equal(to_np(got),
                                  to_np(jq.fake_quant(jnp.asarray(w), jc)))


def test_fake_quant_stacked_and_vector_shapes():
    """(L, K, N) stacks quantize per matrix; (K,) vectors along their axis;
    group_size=-1 is one group over K."""
    rng = np.random.default_rng(3)
    stack = rng.standard_normal((3, 64, 16)).astype(np.float32)
    vec = rng.standard_normal((64,)).astype(np.float32)
    for group in (32, -1):
        jc = jq.QuantConfig(bits=3, group_size=group)
        tc = tq.QuantConfig(bits=3, group_size=group)
        g = 64 if group == -1 else group
        got = tq.fake_quant(torch.from_numpy(stack), tc)
        want = jq.fake_quant(jnp.asarray(stack), jc)
        for i in range(3):
            s, _ = jq.compute_qparams(jnp.asarray(stack[i]), jc)
            assert_within_one_step(got[i], want[i], s, g)
        got_v = tq.fake_quant(torch.from_numpy(vec), tc)
        want_v = jq.fake_quant(jnp.asarray(vec), jc)
        np.testing.assert_allclose(to_np(got_v), to_np(want_v), rtol=0,
                                   atol=1e-6)


def test_quant_config_validation():
    with pytest.raises(ValueError):
        tq.QuantConfig(bits=0)
    with pytest.raises(ValueError):
        tq.QuantConfig(bits=2, group_size=24).resolve_group(64)
    assert tq.QuantConfig(bits=3).q_max == 7
