"""Port parity of the Mamba2 / SSD block (``repro_torch/models/ssm.py``)
against the reference's ``repro/models/ssm.py``.

Inputs are numpy from a seed; block weights are the reference's
``init_ssm`` carried across with ``params_from_numpy``. Bars (upper bounds;
the measured worst case on the CPU beside each):

- ``_ssd_chunked`` y and final state against the reference's: 1e-5 abs +
  1e-5 rel (measured ≤ 6.0e-7 abs);
- ``_ssd_chunked`` against the float64 sequential recurrence: the
  reference's own 2e-3 (``tests/test_models.py``; measured ≤ 3.1e-7);
- ``_causal_conv``, ``ssm_forward`` (with its state) and
  ``ssm_decode_step``: 1e-5 abs + rel (measured: the conv equal to the
  bit, the block's output and state ≤ 1.7e-6).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import one_torch_thread, to_np  # noqa: F401
from repro.configs import get_config as jget_config
from repro.models import ssm as jssm
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import ssm as tssm

pytestmark = pytest.mark.usefixtures("one_torch_thread")
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _ssd_inputs(L, G, H=4, P=4, N=8, B=2, seed=0):
    rng = np.random.default_rng(seed)
    xh = (rng.standard_normal((B, L, H, P)) * 0.5).astype(np.float32)
    a = (-np.abs(rng.standard_normal((B, L, H))) * 0.3).astype(np.float32)
    Bm = (rng.standard_normal((B, L, G, N)) * 0.5).astype(np.float32)
    Cm = (rng.standard_normal((B, L, G, N)) * 0.5).astype(np.float32)
    return xh, a, Bm, Cm


@pytest.mark.parametrize("G", [1, 2])
@pytest.mark.parametrize("L", [24, 40], ids=["L24", "L40-padded"])
def test_ssd_chunked_matches_reference(L, G):
    xh, a, Bm, Cm = _ssd_inputs(L, G)
    jy, jh = jssm._ssd_chunked(*map(jnp.asarray, (xh, a, Bm, Cm)), chunk=8)
    ty, th = tssm._ssd_chunked(*map(_t, (xh, a, Bm, Cm)), chunk=8)
    assert tuple(ty.shape) == jy.shape and tuple(th.shape) == jh.shape
    assert ty.dtype == th.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)


@pytest.mark.parametrize("L", [24, 40], ids=["L24", "L40-padded"])
def test_ssd_chunked_matches_sequential_recurrence(L):
    """The reference's recurrence test (``tests/test_models.py``) on the
    port: h_t = exp(a_t) h_{t-1} + B_t ⊗ x_t, y_t = C_t · h_t, in float64,
    at the reference's 2e-3."""
    B, H, P, N = 1, 2, 4, 8
    xh, a, Bm, Cm = _ssd_inputs(L, 1, H=H, P=P, N=N, B=B, seed=3)
    y, hT = tssm._ssd_chunked(*map(_t, (xh, a, Bm, Cm)), chunk=8)
    h = np.zeros((B, H, P, N))
    ys = []
    for t in range(L):
        dA = np.exp(a[:, t].astype(np.float64))
        Bt = np.repeat(Bm[:, t], H, axis=1).astype(np.float64)
        Ct = np.repeat(Cm[:, t], H, axis=1).astype(np.float64)
        h = h * dA[:, :, None, None] + np.einsum("bhn,bhp->bhpn", Bt,
                                                 xh[:, t].astype(np.float64))
        ys.append(np.einsum("bhn,bhpn->bhp", Ct, h))
    np.testing.assert_allclose(y.numpy(), np.stack(ys, axis=1), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(hT.numpy(), h, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("W,L", [(4, 12), (4, 2), (2, 5)])
def test_causal_conv_matches_reference(W, L):
    rng = np.random.default_rng(W * L)
    x = rng.standard_normal((2, L, 6)).astype(np.float32)
    w = rng.standard_normal((W, 6)).astype(np.float32)
    b = rng.standard_normal((6,)).astype(np.float32)
    got = tssm._causal_conv(_t(x), _t(w), _t(b))
    want = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _block(arch, seed=0, **over):
    """One reduced SSM block's params (the reference's init_ssm) on both
    sides, and the configs."""
    jcfg = jget_config(arch).reduced(**over)
    tcfg = tget_config(arch).reduced(**over)
    jp = jssm.init_ssm(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    return jcfg, tcfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp),
                                             "cpu")


@pytest.mark.parametrize("arch,L", [("mamba2-2.7b", 40), ("mamba2-2.7b", 70),
                                    ("zamba2-7b", 24)])
def test_ssm_forward_with_state_matches_reference(arch, L):
    """The block body over a sequence (70: three chunks of 32, the last
    padded), its output and its decode state within 1e-5."""
    jcfg, tcfg, jp, tp = _block(arch)
    x = np.random.default_rng(L).standard_normal(
        (2, L, jcfg.d_model)).astype(np.float32)
    jout, jst = jssm.ssm_forward(jp, jcfg, jnp.asarray(x), return_state=True)
    tout, tst = tssm.ssm_forward(tp, tcfg, _t(x), return_state=True)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    np.testing.assert_allclose(tst["state"].numpy(), np.asarray(jst["state"]),
                               **TOL)
    for k in ("x", "B", "C"):
        np.testing.assert_allclose(tst["conv"][k].numpy(),
                                   np.asarray(jst["conv"][k]), **TOL)
    np.testing.assert_allclose(
        tssm.ssm_forward(tp, tcfg, _t(x)).numpy(), tout.numpy(), rtol=0,
        atol=0)


def test_ssm_decode_steps_match_reference():
    """Four decode steps from a prefilled state, each output and state
    within 1e-5 of the reference's; the port's steps then agree with its
    own full-sequence forward at the reference's 2e-2 prefill bar."""
    jcfg, tcfg, jp, tp = _block("mamba2-2.7b", seed=2)
    x = np.random.default_rng(9).standard_normal(
        (2, 20, jcfg.d_model)).astype(np.float32)
    _, jst = jssm.ssm_forward(jp, jcfg, jnp.asarray(x[:, :16]),
                              return_state=True)
    _, tst = tssm.ssm_forward(tp, tcfg, _t(x[:, :16]), return_state=True)
    full = tssm.ssm_forward(tp, tcfg, _t(x))
    for t in range(16, 20):
        jo, jst = jssm.ssm_decode_step(jp, jcfg, jnp.asarray(x[:, t:t + 1]),
                                       jst)
        to, tst = tssm.ssm_decode_step(tp, tcfg, _t(x[:, t:t + 1]), tst)
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        np.testing.assert_allclose(tst["state"].numpy(),
                                   np.asarray(jst["state"]), **TOL)
        for k in ("x", "B", "C"):
            np.testing.assert_allclose(tst["conv"][k].numpy(),
                                       np.asarray(jst["conv"][k]), **TOL)
        np.testing.assert_allclose(to[:, 0].numpy(), full[:, t].numpy(),
                                   rtol=2e-2, atol=2e-2)


def test_decode_from_zero_state_matches_reference():
    jcfg, tcfg, jp, tp = _block("zamba2-7b", seed=1)
    x = np.random.default_rng(1).standard_normal(
        (3, 1, jcfg.d_model)).astype(np.float32)
    jo, jst = jssm.ssm_decode_step(jp, jcfg, jnp.asarray(x),
                                   jssm.init_ssm_state(jcfg, 3))
    to, tst = tssm.ssm_decode_step(tp, tcfg, _t(x),
                                   tssm.init_ssm_state(tcfg, 3, device="cpu"))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    np.testing.assert_allclose(tst["state"].numpy(), np.asarray(jst["state"]),
                               **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_state_shapes_match_reference(dtype):
    jcfg = jget_config("mamba2-2.7b").reduced()
    tcfg = tget_config("mamba2-2.7b").reduced()
    jst = jssm.init_ssm_state(jcfg, 3, jnp.dtype(str(dtype).split(".")[1]))
    tst = tssm.init_ssm_state(tcfg, 3, dtype, device="cpu", lead=(2,))
    assert tuple(tst["state"].shape) == (2,) + jst["state"].shape
    assert tst["state"].dtype == torch.float32
    for k in ("x", "B", "C"):
        assert tuple(tst["conv"][k].shape) == (2,) + jst["conv"][k].shape
        assert tst["conv"][k].dtype == dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_ssm_shapes_dtypes_and_ranges(dtype):
    """The reference's leaves, shapes and dtypes (A_log, D, dt_bias f32),
    with a leading stack axis; A_log = log U(1, 16), dt_bias the inverse
    softplus of dt in [1e-3, 0.1], D = 1, biases 0, norm 1."""
    jcfg = jget_config("mamba2-2.7b").reduced()
    tcfg = dataclasses.replace(tget_config("mamba2-2.7b").reduced(),
                               param_dtype=str(dtype).split(".")[1])
    jp = jssm.init_ssm(jax.random.PRNGKey(0), jcfg,
                       jnp.dtype(tcfg.param_dtype))
    tp = tssm.init_ssm((3,), tcfg, torch.Generator().manual_seed(0), dtype,
                       "cpu")
    assert list(tp) == list(jp)
    for k, v in tp.items():
        assert tuple(v.shape) == (3,) + jp[k].shape, k
        assert str(v.dtype).split(".")[1] == jp[k].dtype.name, k
    a_log, dt_bias = tp["A_log"], tp["dt_bias"]
    assert bool((a_log >= 0).all()) and bool((a_log <= np.log(16.0)).all())
    dt = torch.nn.functional.softplus(dt_bias)
    assert bool((dt >= 1e-3 * (1 - 1e-4)).all())
    assert bool((dt <= 0.1 * (1 + 1e-4)).all())
    assert bool((tp["D"] == 1).all()) and bool((tp["norm_w"] == 1).all())
    assert not tp["conv_b_x"].any()
    assert len({float(v) for v in a_log.flatten()}) == a_log.numel()
    sd = jcfg.d_model ** -0.5
    assert abs(float(to_np(tp["w_z"]).std()) - sd) < 0.2 * sd
