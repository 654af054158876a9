"""Port parity: RoPE and qk-norm (``repro_torch.models.layers``) vs the JAX
reference, on the same numpy inputs.

Bars:
- the inverse frequencies ``1 / theta ** (arange(0, hd, 2) / hd)``: bit for
  bit at every theta of the config zoo (the port takes the power in float64
  and rounds it to f32, which is what XLA's f32 ``pow`` returns there);
- cos / sin over positions 0..4095: atol 2.5e-7 (2 ulp near 1): with the
  same angles, ``torch.cos`` / ``torch.sin`` part from XLA's by one ulp on
  a few % of the entries;
- ``apply_rope`` and ``attn_qkv`` (projection, qk-norm, RoPE): 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import one_torch_thread, to_np  # noqa: F401
from repro.configs import get_config as jget_config
from repro.models import layers as jL
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers as tL

pytestmark = pytest.mark.usefixtures("one_torch_thread")

THETAS = (1e4, 1e6, 5e6, 8e6)     # internlm2 (default), qwen3, yi, command-r


@pytest.mark.parametrize("head_dim", [16, 64, 128])
@pytest.mark.parametrize("theta", THETAS)
def test_inverse_frequencies_are_the_reference_bits(theta, head_dim):
    want = np.asarray(1.0 / (theta ** (
        jnp.arange(0, head_dim, 2, dtype=jnp.float32) / head_dim)))
    got = tL._rope_inv_freq(head_dim, theta, torch.device("cpu")).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("theta", THETAS)
def test_rope_cos_sin_matches_reference(theta):
    pos = np.arange(4096)
    jc, js = jL.rope_cos_sin(jnp.asarray(pos), 128, theta)
    tc, ts = tL.rope_cos_sin(torch.from_numpy(pos), 128, theta)
    assert tuple(tc.shape) == jc.shape == (4096, 64) and tc.dtype == torch.float32
    np.testing.assert_allclose(to_np(tc), np.asarray(jc), rtol=0, atol=2.5e-7)
    np.testing.assert_allclose(to_np(ts), np.asarray(js), rtol=0, atol=2.5e-7)
    # per-sequence positions (B, S), as the paged decode step passes them
    bpos = np.array([[0], [17], [4095]])
    jc2, _ = jL.rope_cos_sin(jnp.asarray(bpos), 128, theta)
    tc2, _ = tL.rope_cos_sin(torch.from_numpy(bpos), 128, theta)
    assert tuple(tc2.shape) == jc2.shape == (3, 1, 64)
    np.testing.assert_allclose(to_np(tc2), np.asarray(jc2), rtol=0, atol=2.5e-7)


@pytest.mark.parametrize("per_seq", [False, True], ids=["shared", "per-seq"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_rope_matches_reference(per_seq, dtype):
    rng = np.random.default_rng(3)
    B, S, H, Dh = 3, 5, 4, 16
    x = rng.standard_normal((B, S, H, Dh)).astype(np.float32)
    pos = (rng.integers(0, 300, (B, S)) if per_seq else np.arange(7, 7 + S))
    jc, js = jL.rope_cos_sin(jnp.asarray(pos), Dh, 1e6)
    tc, ts = tL.rope_cos_sin(torch.from_numpy(pos), Dh, 1e6)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = jL.apply_rope(jx, jc, js)
    got = tL.apply_rope(tx, tc, ts)
    assert got.dtype == tx.dtype and str(want.dtype) == dtype
    # bf16 results carry 8 bits: 1e-6 is the f32 bar, one bf16 ulp the other
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=tol, atol=tol)
    # the rotation keeps each (x1_i, x2_i) pair's norm
    if dtype == "float32":
        n0 = x[..., :8] ** 2 + x[..., 8:] ** 2
        g = to_np(got)
        np.testing.assert_allclose(g[..., :8] ** 2 + g[..., 8:] ** 2, n0,
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("qk_norm", [True, False], ids=["qk-norm", "rope-only"])
@pytest.mark.parametrize("positions", ["arange", "per-seq"])
def test_attn_qkv_matches_reference(qk_norm, positions):
    jcfg = dataclasses.replace(jget_config("qwen3-4b").reduced(), qk_norm=qk_norm)
    tcfg = dataclasses.replace(tget_config("qwen3-4b").reduced(), qk_norm=qk_norm)
    jp = jL.init_attn(jax.random.PRNGKey(1), jcfg, jnp.float32)
    if qk_norm:   # non-trivial norm weights
        rng = np.random.default_rng(0)
        jp = dict(jp, q_norm=jnp.asarray(1 + 0.1 * rng.standard_normal(16),
                                         jnp.float32),
                  k_norm=jnp.asarray(1 + 0.1 * rng.standard_normal(16),
                                     jnp.float32))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert ("q_norm" in tp) == qk_norm
    rng = np.random.default_rng(5)
    B, S = 2, 6
    x = rng.standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    pos = (np.arange(S) if positions == "arange"
           else rng.integers(0, 200, (B, S)))
    want = jL.attn_qkv(jp, jcfg, jnp.asarray(x), jnp.asarray(pos))
    got = tL.attn_qkv(tp, tcfg, torch.from_numpy(x), torch.from_numpy(pos))
    for name, g, w in zip("qkv", got, want):
        assert tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
