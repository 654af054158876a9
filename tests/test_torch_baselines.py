"""Port parity: the calibrated base methods (``repro_torch.core`` taps, GPTQ,
AWQ, OmniQuant) and ``quantize_model``'s dispatch of them vs the JAX
reference.

The same numpy inputs go through both packages; JAX weights cross with
``params_from_numpy``. Exactness is out of reach for these methods (XLA
evaluates the chains in another order, and ``jnp.power`` and torch's
``pow`` part in the last ulp), so the bars are:

- taps: rtol 1e-4, atol 1e-5 (the forward's bar, ``test_torch_model.py``);
- GPTQ outputs: within one quantization step on < 0.1 % of elements and
  within 1e-3 elsewhere (:func:`assert_gptq_close`), up to the first row
  where a code flips at a near round-half tie, after which the later rows
  absorb the other error and part (:func:`assert_gptq_rows_close`); U:
  rtol 1e-3 of its largest entry (entries near zero carry no relative
  precision);
- AWQ: the grids bit for bit, s at rtol 1e-5 with the same chosen α, the
  same clip ratio;
- OmniQuant: the LWC forward at rtol 1e-6, its gradient at rtol 1e-4, the
  block losses over 10 steps at rtol 1e-3;
- the pipeline: every method's weights within the GPTQ bar, except that
  GPTQ's own weights may also part at an exact round-half tie of the final
  fake-quant (:func:`assert_parts_only_at_ties`): GPTQ leaves each group on
  a subset of its levels, so re-quantizing puts several % of the elements
  on exact ties, where an ulp of the GPTQ output decides; and that an
  OmniQuant layer whose 200-step trajectory parts from the reference's
  (the per-step losses part by more than 1e-5 relative: a code flips at a
  near tie of the STE's rounding, and the block climbs another way) is held
  instead to what stays determined (:func:`assert_parted_layer`);
- one OmniQuant step, teacher-forced: from the reference's own state at
  every one of the 200 steps, the loss within 1e-5 relative and the next θ
  within 1e-5 relative plus one ulp of θ's init value 4.0
  (:func:`teacher_forced_deviation`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.torch_parity import to_np
from repro.configs import get_config as jget_config
from repro.core import awq as jawq
from repro.core import gptq as jgptq
from repro.core import omniquant as jomni
from repro.core import quant as jq
from repro.core import rtn as jrtn
from repro.core.objective import calib_ce as jcalib_ce
from repro.core.pipeline import quantize_model as jquantize_model
from repro.core.taps import capture_dense_taps as jcapture
from repro.models.layers import activation_fn as jact
from repro.models import model as jmodel
from repro.models.config import ModelConfig as JModelConfig
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.core import awq as tawq
from repro_torch.core import gptq as tgptq
from repro_torch.core import omniquant as tomni
from repro_torch.core import quant as tq
from repro_torch.core import rtn as trtn
from repro_torch.core.objective import calib_ce as tcalib_ce
from repro_torch.core.pipeline import quantize_model as tquantize_model
from repro_torch.core.search import SearchConfig
from repro_torch.core.taps import capture_dense_taps as tcapture
from repro_torch.data.calib import calibration_tokens
from repro_torch.models import model as tmodel
from repro_torch.models.config import ModelConfig as TModelConfig

METHODS = ("rtn", "gptq", "awq", "omniquant")


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def assert_gptq_close(got, want, step, what=""):
    """Within 1e-3, except < 0.1 % of elements, each within one step."""
    got, want = to_np(got), to_np(want)
    diff = np.abs(got - want)
    off = diff > 1e-3
    assert float(np.mean(off)) < 1e-3, (
        f"{what}: {np.mean(off):.3%} of elements differ by more than 1e-3")
    assert np.all(diff[off] <= np.asarray(step)[off] * 1.001 + 1e-6), (
        f"{what}: an element differs by more than one step")


def _grid_position(w, bits, group):
    """(w / scale + zero, scale) of the reference's fake-quant of w (L, K,
    N) per group: where each element falls on the rounding grid."""
    L, K, N = w.shape
    g = w.reshape(L, K // group, group, N)
    mx, mn = g.max(2, keepdims=True), g.min(2, keepdims=True)
    scale = np.maximum((mx - mn) / np.float32((1 << bits) - 1), 1e-8)
    zero = np.clip(np.round(-mn / scale), 0, (1 << bits) - 1)
    t = (g / scale + zero).reshape(L, K, N)
    return t, np.broadcast_to(scale, g.shape).reshape(L, K, N)


def assert_parts_only_at_ties(got, want, base_ref, bits, group, what=""):
    """The final fake-quant weights ``got``/``want`` (L, K, N) agree within
    1e-3 wherever the reference's base weights ``base_ref`` do not sit on a
    round-half tie (|frac(t) − 0.5| < 1e-4); at a tie they are one step
    apart at most."""
    got, want = to_np(got), to_np(want)
    t, scale = _grid_position(to_np(base_ref), bits, group)
    tie = np.abs(t - np.floor(t) - 0.5) < 1e-4
    diff = np.abs(got - want)
    assert np.all(diff[~tie] <= 1e-3), f"{what}: parts away from a tie"
    assert np.all(diff[tie] <= scale[tie] * 1.001 + 1e-6), (
        f"{what}: more than one step at a tie")


# ---------------------------------------------------------------------------
# taps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def opt_pair():
    jcfg = jget_config("opt-tiny").reduced()
    tcfg = tget_config("opt-tiny").reduced()
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    calib = calibration_tokens(jcfg.vocab_size, n_seqs=4, seq_len=64)
    return jcfg, tcfg, jparams, tparams, calib


def test_capture_dense_taps_matches_reference(opt_pair):
    jcfg, tcfg, jparams, tparams, calib = opt_pair
    want = jcapture(jparams, jcfg, jnp.asarray(calib))
    got = tcapture(tparams, tcfg, torch.from_numpy(calib.astype(np.int64)))
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(to_np(got[k]), to_np(want[k]), rtol=1e-4,
                                   atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# GPTQ
# ---------------------------------------------------------------------------

def _correlated(K, N, n=512, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((K, N)).astype(np.float32)
    base = rng.standard_normal((n, 8)).astype(np.float32)
    mix = rng.standard_normal((8, K)).astype(np.float32)
    x = (base @ mix + 0.1 * rng.standard_normal((n, K))).astype(np.float32)
    return w, x


def _jax_u(x, damp=0.01):
    """The reference's factorisation (``core/gptq.py:38-45``) in jnp."""
    xf = jnp.asarray(x)
    K = xf.shape[1]
    H = 2.0 * (xf.T @ xf)
    H = H + (damp * jnp.mean(jnp.diag(H)) + 1e-6) * jnp.eye(K)
    Hinv = jax.scipy.linalg.cho_solve((jnp.linalg.cholesky(H), True),
                                      jnp.eye(K))
    Hinv = 0.5 * (Hinv + Hinv.T) + 1e-8 * jnp.eye(K)
    return np.asarray(jnp.linalg.cholesky(Hinv).T)


def _literal_rows(w, U, bits, group):
    """The reference's row loop (``core/gptq.py:57-71``) transcribed into
    float32 numpy: the masked update of every row, the group refresh from
    the updated weights. Returns (dq, each element's distance from a
    round-half tie, |frac(w / scale) − 0.5|, in quantization steps)."""
    K, N = w.shape
    qm = np.float32((1 << bits) - 1)
    W, dq, tie = w.copy(), np.zeros_like(w), np.zeros_like(w)
    for k in range(K):
        if k % group == 0:
            rows = W[k:k + group]
            scale = np.maximum((rows.max(0) - rows.min(0)) / qm,
                               np.float32(1e-8))
            zero = np.clip(np.round(-rows.min(0) / scale), 0, qm)
        t = W[k] / scale
        tie[k] = np.abs(t - np.floor(t) - 0.5)
        q = np.clip(np.round(t) + zero, 0, qm)
        dq[k] = scale * (q - zero)
        err = (W[k] - dq[k]) / U[k, k]
        ucol = np.where(np.arange(K) > k, U[k], np.float32(0))
        W = W - ucol[:, None] * err[None, :]
    return dq, tie


NEAR_TIE = 1e-4     # steps from a round-half tie where fp32 order may decide


def assert_gptq_rows_close(got, want, step, tie, what=""):
    """The GPTQ bar up to the first row where a code flips at a near tie.
    One flip changes that row's error, and every later row absorbs it
    (W[j] -= U[k, j] · err_k), so from there on the outputs legitimately
    part (as the search replays compare up to the first near-tie step).
    ``tie``: the reference loop's tie distances (:func:`_literal_rows`)."""
    got, want = to_np(got), to_np(want)
    parted = np.argwhere(np.abs(got - want) > 1e-3)
    end = got.shape[0]
    if len(parted):
        r, c = parted[0]
        assert tie[r, c] < NEAR_TIE, (
            f"{what}: row {r} parts {abs(got[r, c] - want[r, c]):.3g} away "
            f"from a tie ({tie[r, c]:.3g} steps)")
        end = r + 1          # the row that flipped is held to one step
    assert_gptq_close(got[:end], want[:end], np.asarray(step)[:end], what)


def test_gptq_beats_rtn_on_correlated_inputs():
    """``test_baselines.py:13`` on the port: with correlated activations,
    error compensation gives lower OUTPUT error than RTN."""
    w, x = _correlated(64, 32)
    qcfg = tq.QuantConfig(bits=2, group_size=32)
    w_gptq = tgptq.gptq_matrix(T(w), T(x), qcfg.bits, qcfg.group_size)
    w_rtn = tq.fake_quant(T(w), qcfg)
    err_gptq = float(torch.mean(torch.square(T(x) @ w_gptq - T(x) @ T(w))))
    err_rtn = float(torch.mean(torch.square(T(x) @ w_rtn - T(x) @ T(w))))
    assert err_gptq < err_rtn, f"gptq {err_gptq:.4f} !< rtn {err_rtn:.4f}"


def test_gptq_reduces_to_rtn_for_identity_hessian():
    """``test_baselines.py:30`` on the port: XᵀX ∝ I makes the inverse
    Hessian diagonal, so GPTQ equals plain RTN."""
    rng = np.random.default_rng(1)
    K, N = 32, 16
    w = rng.standard_normal((K, N)).astype(np.float32)
    q, _ = np.linalg.qr(rng.standard_normal((K, K)))
    x = (q.T * 3.0).astype(np.float32)       # x.T @ x = 9 I
    qcfg = tq.QuantConfig(bits=4, group_size=16)
    got = tgptq.gptq_matrix(T(w), T(x), qcfg.bits, qcfg.group_size, damp=0.0)
    np.testing.assert_allclose(to_np(got), to_np(tq.fake_quant(T(w), qcfg)),
                               atol=1e-4)


GPTQ_CASES = [(2, 32), (4, 16)]
GPTQ_IDS = ["b2g32", "b4g16"]


@pytest.mark.parametrize("bits,group", GPTQ_CASES, ids=GPTQ_IDS)
def test_gptq_matrix_matches_reference(bits, group):
    w, x = _correlated(128, 64, seed=bits)
    want = jgptq.gptq_matrix(jnp.asarray(w), jnp.asarray(x), bits, group)
    got, scales = tgptq.gptq_rows(T(w), tgptq.gptq_factor(T(x)), bits, group)
    np.testing.assert_array_equal(
        to_np(tgptq.gptq_matrix(T(w), T(x), bits, group)), to_np(got))
    _, tie = _literal_rows(w, _jax_u(x), bits, group)
    assert_gptq_rows_close(got, want, np.repeat(to_np(scales), group, axis=0),
                           tie, f"gptq b{bits} g{group}")


@pytest.mark.parametrize("bits,group", GPTQ_CASES, ids=GPTQ_IDS)
def test_gptq_factor_matches_reference(bits, group):
    _, x = _correlated(128, 64, seed=bits)
    want = _jax_u(x)
    got = to_np(tgptq.gptq_factor(T(x)))
    np.testing.assert_allclose(got, want, rtol=1e-3,
                               atol=1e-3 * np.abs(want).max())
    assert np.all(np.tril(got, -1) == 0), "U must be upper triangular"


@pytest.mark.parametrize("bits,group", GPTQ_CASES, ids=GPTQ_IDS)
def test_gptq_rows_matches_a_literal_transcription(bits, group):
    """The row loop alone, on one U, against the reference's loop in
    float32 numpy (:func:`_literal_rows`)."""
    w, x = _correlated(128, 64, seed=bits)
    U = to_np(tgptq.gptq_factor(T(x)))
    want, tie = _literal_rows(w, U, bits, group)
    got, scales = tgptq.gptq_rows(T(w), torch.from_numpy(U), bits, group)
    assert_gptq_rows_close(got, want, np.repeat(to_np(scales), group, axis=0),
                           tie, "row loop")


# ---------------------------------------------------------------------------
# AWQ
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("start,stop,num", [(0.0, 1.0, tawq.ALPHA_GRID),
                                            (0.5, 1.0, tawq.CLIP_GRID)],
                         ids=["alpha", "clip"])
def test_awq_grids_are_the_reference_grids(start, stop, num):
    want = np.asarray(jnp.linspace(start, stop, num))
    got = np.asarray(tawq.f32_linspace(start, stop, num), dtype=np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def _ffn_case(gated, seed=0):
    rng = np.random.default_rng(seed)
    D, F, n = 32, 64, 256
    w_up = rng.standard_normal((D, F)).astype(np.float32)
    w_up[:, :4] *= 8.0                      # outlier hidden channels
    w_down = rng.standard_normal((F, D)).astype(np.float32)
    b_up = (0.1 * rng.standard_normal(F)).astype(np.float32)
    w_gate = rng.standard_normal((D, F)).astype(np.float32) if gated else None
    x = rng.standard_normal((n, D)).astype(np.float32)
    kw = dict(activation="silu", gated_mlp=True) if gated else dict(
        activation="relu", gated_mlp=False)
    return w_up, w_down, b_up, w_gate, x, JModelConfig(**kw), TModelConfig(**kw)


def _opt(a, conv):
    return None if a is None else conv(a)


@pytest.mark.parametrize("gated", [False, True], ids=["relu", "gated-silu"])
def test_awq_scale_ffn_matches_reference(gated):
    w_up, w_down, b_up, w_gate, x, jcfg, tcfg = _ffn_case(gated)
    jout = jawq.awq_scale_ffn(jnp.asarray(w_up), jnp.asarray(w_down),
                              jnp.asarray(b_up), _opt(w_gate, jnp.asarray),
                              jnp.asarray(x), jq.QuantConfig(2, 32), jcfg)
    qc = tq.QuantConfig(2, 32)
    s, choice = tawq.awq_alpha_search(T(w_up), T(w_down), T(b_up),
                                      _opt(w_gate, T), T(x), qc, tcfg)
    tout = tawq.awq_scale_ffn(T(w_up), T(w_down), T(b_up), _opt(w_gate, T),
                              T(x), qc, tcfg)
    s_ref = to_np(jout[4])
    # the reference's chosen α: the grid point whose s it returned
    up = np.maximum(x @ w_up + b_up, 0) if not gated else None
    if gated:
        g = x @ w_gate
        up = g / (1 + np.exp(-g)) * (x @ w_up + b_up)
    mag = np.mean(np.abs(up), axis=0).astype(np.float64) + 1e-8
    dist = []
    for a in tawq.f32_linspace(0.0, 1.0, tawq.ALPHA_GRID):
        c = mag ** a
        c = np.clip(c / np.sqrt(c.max() * c.min() + 1e-12), 1e-4, 1e4)
        dist.append(np.abs(c - s_ref).max())
    assert choice.index == int(np.argmin(dist))
    assert len(choice.losses) == tawq.ALPHA_GRID
    assert choice.losses[choice.index] == min(choice.losses)
    np.testing.assert_allclose(to_np(s), s_ref, rtol=1e-5)
    for got, want in zip(tout, jout):
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_clip_search_picks_the_reference_ratio(seed):
    rng = np.random.default_rng(seed)
    K, N, n = 64, 32, 256
    w = rng.standard_normal((K, N)).astype(np.float32)
    w[0, 0] = 20.0                          # an outlier that wrecks the scale
    x = rng.standard_normal((n, K)).astype(np.float32)
    want = to_np(jawq.clip_search(jnp.asarray(w), jnp.asarray(x), 2, 32))
    got, choice = tawq.clip_grid_search(T(w), T(x), tq.QuantConfig(2, 32))
    # the reference's ratio: the grid point whose clipped weights it returned
    g = w.reshape(K // 32, 32, N)
    dist = [np.abs(np.clip(g, g.min(1, keepdims=True) * np.float32(r),
                           g.max(1, keepdims=True) * np.float32(r))
                   .reshape(K, N) - want).max()
            for r in tawq.f32_linspace(0.5, 1.0, tawq.CLIP_GRID)]
    assert choice.index == int(np.argmin(dist)) and min(dist) == 0.0
    np.testing.assert_array_equal(to_np(got), want)
    np.testing.assert_array_equal(
        to_np(tawq.clip_search(T(w), T(x), 2, 32)), want)


def test_awq_scaling_beats_plain_rtn():
    """``test_baselines.py:44`` on the port."""
    w_up, w_down, b_up, _, x, _, tcfg = _ffn_case(False)
    b_up = np.zeros_like(b_up)
    qcfg = tq.QuantConfig(bits=2, group_size=32)

    def out_err(wu, wd, bu):
        y_fp = torch.relu(T(x) @ T(w_up) + T(b_up)) @ T(w_down)
        y = torch.relu(T(x) @ tq.fake_quant(wu, qcfg) + bu) @ tq.fake_quant(
            wd, qcfg)
        return float(torch.mean(torch.square(y - y_fp)))

    su, sd, sb, _, _ = tawq.awq_scale_ffn(T(w_up), T(w_down), T(b_up), None,
                                          T(x), qcfg, tcfg)
    assert out_err(su, sd, sb) <= out_err(T(w_up), T(w_down), T(b_up)) + 1e-6


def test_clip_search_not_worse():
    """``test_baselines.py:67`` on the port."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    w[0, 0] = 20.0
    x = rng.standard_normal((256, 64)).astype(np.float32)
    qcfg = tq.QuantConfig(bits=2, group_size=32)
    wc = tawq.clip_search(T(w), T(x), qcfg.bits, qcfg.group_size)
    y = T(x) @ T(w)
    err_clip = float(torch.mean(torch.square(T(x) @ tq.fake_quant(wc, qcfg) - y)))
    err_rtn = float(torch.mean(torch.square(T(x) @ tq.fake_quant(T(w), qcfg) - y)))
    assert err_clip <= err_rtn + 1e-6


# ---------------------------------------------------------------------------
# OmniQuant
# ---------------------------------------------------------------------------

def _lwc_case(seed=0):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((64, 16)).astype(np.float32)
    gamma = rng.uniform(-1, 5, (2, 16)).astype(np.float32)
    beta = rng.uniform(-1, 5, (2, 16)).astype(np.float32)
    cot = rng.standard_normal((64, 16)).astype(np.float32)
    return w, gamma, beta, cot


@pytest.mark.parametrize("bits", [2, 4])
def test_fake_quant_lwc_forward_matches_reference(bits):
    w, gamma, beta, _ = _lwc_case(bits)
    want = jomni.fake_quant_lwc(jnp.asarray(w), jq.QuantConfig(bits, 32),
                                jnp.asarray(gamma), jnp.asarray(beta))
    got = tomni.fake_quant_lwc(T(w), tq.QuantConfig(bits, 32), T(gamma),
                               T(beta))
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("bits", [2, 4])
def test_fake_quant_lwc_gradient_matches_reference(bits):
    """d/d(w, gamma, beta) of <fq_lwc(w), c>: the STE passes the gradient
    through round(), the shrink reaches gamma/beta through max/min."""
    w, gamma, beta, cot = _lwc_case(bits)

    def jloss(w, g, b):
        return jnp.sum(jomni.fake_quant_lwc(w, jq.QuantConfig(bits, 32), g, b)
                       * jnp.asarray(cot))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(w), jnp.asarray(gamma), jnp.asarray(beta))
    args = [T(a).requires_grad_(True) for a in (w, gamma, beta)]
    out = tomni.fake_quant_lwc(args[0], tq.QuantConfig(bits, 32), *args[1:])
    got = torch.autograd.grad(torch.sum(out * T(cot)), args)
    for name, g, j in zip(("w", "gamma", "beta"), got, want):
        j = to_np(j)
        np.testing.assert_allclose(to_np(g), j, rtol=1e-4,
                                   atol=1e-4 * np.abs(j).max(), err_msg=name)


@pytest.mark.parametrize("gated", [False, True], ids=["relu", "gated-silu"])
def test_optimize_block_losses_match_reference(gated):
    w_up, w_down, b_up, w_gate, x, jcfg, _ = _ffn_case(gated, seed=3)
    w_gate = np.zeros_like(w_up) if w_gate is None else w_gate
    kw = dict(bits=2, group_size=16, steps=10, gated=gated,
              act_name=jcfg.activation)
    jo = jomni._optimize_block(*(jnp.asarray(a) for a in (
        w_up, w_down, w_gate, b_up, x)), **kw)
    to = tomni._optimize_block(*(T(a) for a in (w_up, w_down, w_gate, b_up, x)),
                               **kw)
    np.testing.assert_allclose(to_np(to[3]), to_np(jo[3]), rtol=1e-3)
    np.testing.assert_allclose(to_np(to[2]), to_np(jo[2]), rtol=1e-3,
                               atol=1e-5)


def test_omniquant_block_loss_decreases():
    """``test_baselines.py:80`` on the port."""
    rng = np.random.default_rng(0)
    D, F, n = 16, 32, 128
    w_up = rng.standard_normal((D, F)).astype(np.float32)
    w_down = rng.standard_normal((F, D)).astype(np.float32)
    x = rng.standard_normal((n, D)).astype(np.float32)
    _, _, _, losses = tomni._optimize_block(
        T(w_up), T(w_down), torch.zeros(D, F), torch.zeros(F), T(x), bits=2,
        group_size=16, steps=60, gated=False, act_name="relu")
    assert float(losses[-1]) < float(losses[0]), "LWC+LET must reduce block MSE"


def test_fake_quant_lwc_matches_plain_at_identity():
    """``test_baselines.py:92`` on the port: sigmoid(+inf) == 1 recovers
    plain fake-quant."""
    w = T(np.random.default_rng(0).standard_normal((64, 8)))
    qcfg = tq.QuantConfig(bits=4, group_size=32)
    big = torch.full((2, 8), 50.0)
    np.testing.assert_allclose(to_np(tomni.fake_quant_lwc(w, qcfg, big, big)),
                               to_np(tq.fake_quant(w, qcfg)), rtol=1e-5,
                               atol=1e-6)


OMNI_STEPS = 200
OMNI_LR = 5e-3
TF_RTOL = 1e-5          # the teacher-forced step bars (loss, next θ)
TF_ATOL = 2.0 ** -21    # one ulp of 4.0, θ's clip logits at init
PART_RTOL = 1e-5        # per-step losses parted from the reference's
EARLY_STEPS, EARLY_RTOL = 50, 1e-6   # a parted layer's early agreement


def _reference_block_step(w_up, w_down, w_gate, b_up, x, qcfg, act_name,
                          gated=False, lr=OMNI_LR):
    """The reference's OmniQuant step, composed here from its own
    ``fake_quant_lwc``, ``_adam_update`` and ``jax.value_and_grad`` exactly
    as ``repro/core/omniquant.py::_optimize_block`` composes them (its scan
    body), jitted: (θ, m, v, 0-based step) -> (loss at θ, θ', m', v')."""
    act = jact(act_name)

    def ffn(wu, wd, wg, bu, x):
        up = x @ wu + bu
        h = act(x @ wg) * up if gated else act(up)
        return h @ wd

    y_fp = ffn(w_up, w_down, w_gate, b_up, x)

    def loss_fn(theta):
        s = jnp.exp(theta["log_s"])
        wu = jomni.fake_quant_lwc(w_up * s[None, :], qcfg, theta["g_up"],
                                  theta["b_up_c"])
        wd = jomni.fake_quant_lwc(w_down / s[:, None], qcfg, theta["g_dn"],
                                  theta["b_dn_c"])
        return jnp.mean(jnp.square(ffn(wu, wd, w_gate, b_up * s, x) - y_fp))

    @jax.jit
    def step(theta, m, v, t):
        loss, g = jax.value_and_grad(loss_fn)(theta)

        def upd(p, gi, mi, vi):
            d, mi, vi = jomni._adam_update(gi, mi, vi, t + 1.0, lr)
            return p + d, mi, vi

        new = jax.tree.map(upd, theta, g, m, v)

        def pick(i):
            return jax.tree.map(lambda x: x[i], new,
                                is_leaf=lambda x: isinstance(x, tuple))

        return loss, pick(0), pick(1), pick(2)

    return step


def teacher_forced_deviation(jcfg, jparams, calib, layer, steps=OMNI_STEPS):
    """Run ``steps`` OmniQuant steps of opt-tiny's FFN ``layer`` (2-bit
    g32, the reference's taps as input), giving both sides the REFERENCE's
    state (θ, m, v) at every step, and return the worst relative loss gap
    and the worst next-θ gap in units of the bar (> 1 fails), each with
    its step."""
    taps = jcapture(jparams, jcfg, jnp.asarray(calib))
    x = np.asarray(taps["mlp_in"][layer]).reshape(-1, jcfg.d_model)
    mlp = jparams["blocks"]["mlp"]
    wu, wd, bu = (np.asarray(mlp[k][layer]) for k in ("up", "down", "b_up"))
    wg = np.zeros_like(wu)
    jstep = _reference_block_step(*(jnp.asarray(a) for a in (wu, wd, wg, bu, x)),
                                  jq.QuantConfig(2, 32), jcfg.activation)
    theta, loss_of, _ = tomni.block_problem(
        T(wu), T(wd), T(wg), T(bu), T(x), 2, 32, False, jcfg.activation)
    jth = {k: jnp.asarray(v.numpy()) for k, v in theta.items()}
    jm = {k: jnp.zeros_like(v) for k, v in jth.items()}
    jv = dict(jm)
    worst_loss, worst_theta = (0.0, -1), (0.0, -1)
    for step in range(steps):
        lj, th2, m2, v2 = jstep(jth, jm, jv, jnp.float32(step))
        lt, tth2, _, _ = tomni.omni_step(
            loss_of, {k: T(v) for k, v in jth.items()},
            {k: T(v) for k, v in jm.items()},
            {k: T(v) for k, v in jv.items()}, step, OMNI_LR)
        gap = abs(float(lt) - float(lj)) / abs(float(lj))
        worst_loss = max(worst_loss, (gap, step))
        for k, want in th2.items():
            want = np.asarray(want)
            units = np.abs(to_np(tth2[k]) - want) / (TF_RTOL * np.abs(want)
                                                     + TF_ATOL)
            worst_theta = max(worst_theta, (float(units.max()), step))
        jth, jm, jv = th2, m2, v2
    return worst_loss, worst_theta


@pytest.fixture(scope="module")
def teacher_forced(opt_pair):
    jcfg, _, jparams, _, calib = opt_pair
    return {i: teacher_forced_deviation(jcfg, jparams, calib, i)
            for i in range(jcfg.n_layers)}


@pytest.mark.parametrize("layer", [0, 1])
def test_omniquant_step_matches_reference_teacher_forced(teacher_forced,
                                                         layer):
    """Every OmniQuant step, from the reference's own state, agrees with the
    reference's at ulp level (the loss within 1e-5 relative, the next θ
    within 1e-5 relative + one ulp of 4.0): where the 200-step trajectories
    part, they part through the STE's near ties, not through the step."""
    (gap, at), (units, at_theta) = teacher_forced[layer]
    assert gap <= TF_RTOL, f"layer {layer} step {at}: loss gap {gap:.3g}"
    assert units <= 1.0, (f"layer {layer} step {at_theta}: next θ off by "
                          f"{units:.3g} bars")


def parted_step(t_losses, j_losses, rtol=PART_RTOL):
    """The first step whose losses part by more than ``rtol`` relative, or
    None."""
    rel = np.abs(to_np(t_losses) - to_np(j_losses)) / np.abs(to_np(j_losses))
    off = np.flatnonzero(rel > rtol)
    return int(off[0]) if len(off) else None


def assert_on_own_grid(w, bits, group, what=""):
    """Every element of w (K, N) lies on its own group's ``bits``-bit grid:
    (w / scale + zero) within 1e-3 of an integer in [0, 2^bits − 1], with
    scale and zero the fake-quant's from the group's own max and min."""
    t, _ = _grid_position(to_np(w)[None], bits, group)
    off = np.abs(t - np.round(t))
    assert float(off.max()) <= 1e-3, f"{what}: off the grid by {off.max():.3g}"
    assert t.min() > -1e-3 and t.max() < (1 << bits) - 1 + 1e-3, what


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipeline_runs(opt_pair):
    """quantize_model(method) on both sides, 2-bit g32, at opt-tiny reduced;
    GPTQ's base (pre-fake-quant) weights from the reference too."""
    jcfg, tcfg, jparams, tparams, calib = opt_pair
    runs = {}
    for m in METHODS:
        jr = jquantize_model(jparams, jcfg, jq.QuantConfig(2, 32), method=m,
                             calib_tokens=jnp.asarray(calib))
        tr = tquantize_model(tparams, tcfg, tq.QuantConfig(2, 32), m, calib,
                             device="cpu")
        runs[m] = (jr, tr)
    gptq_base = jgptq.gptq_process_dense(jparams, jcfg, jnp.asarray(calib),
                                         jq.QuantConfig(2, 32))
    # the reference's per-step OmniQuant losses (L, 200), beside the port's
    # in ``runs["omniquant"][1].base["losses"]``
    _, omni_losses = jomni.omniquant_process_dense(
        jparams, jcfg, jnp.asarray(calib), jq.QuantConfig(2, 32))
    runs["omniquant_ref_losses"] = np.asarray(omni_losses)
    return runs, gptq_base


def assert_parted_layer(t_losses, j_losses, tf, weights, what=""):
    """What stays determined for an OmniQuant layer whose trajectory parts:
    (a) the losses agree within 1e-6 relative for at least the first 50
    steps; (b) the teacher-forced step holds for the layer
    (``tf`` = its :func:`teacher_forced_deviation`); (c) every final weight
    of the layer lies on its own group's 2-bit grid."""
    first = parted_step(t_losses, j_losses, EARLY_RTOL)
    assert first is None or first >= EARLY_STEPS, (
        f"{what}: losses part by > {EARLY_RTOL} at step {first}")
    (gap, at), (units, at_theta) = tf
    assert gap <= TF_RTOL and units <= 1.0, (
        f"{what}: teacher-forced step off (loss {gap:.3g} at {at}, θ "
        f"{units:.3g} bars at {at_theta})")
    for name, w in weights.items():
        assert_on_own_grid(w, 2, 32, f"{what} {name}")


@pytest.mark.parametrize("method", METHODS)
def test_quantize_model_matches_reference(opt_pair, pipeline_runs, method,
                                          request, record_property):
    """Every method's weights against the reference's at the pipeline bar.
    For OmniQuant the bar holds each layer whose per-step losses agree with
    the reference's within 1e-5 relative over all 200 steps; a layer whose
    trajectory parts is held by :func:`assert_parted_layer`, and the case
    reports it (``parted_layers``: layer -> first parted step)."""
    _, _, jparams, _, _ = opt_pair
    runs, gptq_base = pipeline_runs
    jr, tr = runs[method]
    assert tr.method == jr.method == method and tr.search is None
    paths = jmodel.quantizable_paths(jparams)
    assert len(paths) == 6
    parted = {}
    if method == "omniquant":
        j_losses = runs["omniquant_ref_losses"]
        t_losses = to_np(tr.base["losses"])
        parted = {i: s for i in range(len(j_losses))
                  if (s := parted_step(t_losses[i], j_losses[i])) is not None}
        record_property("parted_layers", parted)
        print(f"omniquant: parted layers (layer: first step > {PART_RTOL}): "
              f"{parted}")
        for i, step in parted.items():
            tf = request.getfixturevalue("teacher_forced")[i]
            assert_parted_layer(
                t_losses[i], j_losses[i], tf,
                {k: trtn.get_by_path(tr.params_q, ("blocks", "mlp", k))[i]
                 for k in ("up", "down")}, f"omniquant layer {i}")
    for path in paths:
        got = to_np(trtn.get_by_path(tr.params_q, path))
        want = to_np(jrtn.get_by_path(jr.params_q, path))
        if method == "gptq":
            assert_parts_only_at_ties(got, want,
                                      jrtn.get_by_path(gptq_base, path), 2,
                                      32, f"gptq {path}")
            continue
        keep = [i for i in range(got.shape[0])
                if not (path[-1] in ("up", "down") and i in parted)]
        if keep:
            _, scale = _grid_position(want[keep], 2, 32)
            assert_gptq_close(got[keep], want[keep], scale, f"{method} {path}")
    for key in ("b_up", "b_down"):
        np.testing.assert_allclose(
            to_np(tr.params_q["blocks"]["mlp"][key]),
            to_np(jr.params_q["blocks"]["mlp"][key]), rtol=1e-5, atol=1e-6)


def test_gptq_process_dense_matches_reference(opt_pair, pipeline_runs):
    """GPTQ's own output, before the pipeline's fake-quant: the GPTQ bar."""
    jcfg, tcfg, _, tparams, calib = opt_pair
    _, want = pipeline_runs
    got = tgptq.gptq_process_dense(tparams, tcfg, torch.from_numpy(
        calib.astype(np.int64)), tq.QuantConfig(2, 32))
    for path in jmodel.quantizable_paths(want):
        g, w = to_np(trtn.get_by_path(got, path)), to_np(
            jrtn.get_by_path(want, path))
        _, scale = _grid_position(w, 2, 32)
        assert_gptq_close(g, w, scale, f"gptq base {path}")


def test_quantize_model_reports_the_base_method(opt_pair, pipeline_runs):
    _, tcfg, _, _, _ = opt_pair
    runs, _ = pipeline_runs
    choices = runs["awq"][1].base["choices"]
    assert len(choices) == tcfg.n_layers
    for c in choices:
        assert len(c["alpha"].losses) == tawq.ALPHA_GRID
        assert sorted(c["clip"]) == ["down", "up", "wk", "wo", "wq", "wv"]
    assert tuple(runs["omniquant"][1].base["losses"].shape) == (
        tcfg.n_layers, 200)
    assert runs["gptq"][1].base is None and runs["rtn"][1].base is None


@pytest.mark.parametrize("method", ["gptq", "awq", "omniquant"])
def test_quantize_model_base_method_with_search(opt_pair, method):
    _, tcfg, _, tparams, calib = opt_pair
    res = tquantize_model(tparams, tcfg, tq.QuantConfig(2, 32), method,
                          calib, SearchConfig(steps=2, fused_kernel=True,
                                              log_every=0),
                          omniquant_steps=5, device="cpu")
    assert res.method == method + "+invarexplore"
    assert len(res.search.history) == 3
    assert res.search.final_loss <= res.search.initial_loss


def test_quantize_model_needs_calibration_for_calibrated_methods(opt_pair):
    _, tcfg, _, tparams, _ = opt_pair
    for method in ("gptq", "awq", "omniquant"):
        with pytest.raises(ValueError, match="needs calib_tokens"):
            tquantize_model(tparams, tcfg, tq.QuantConfig(2, 32), method,
                            device="cpu")


def _ulp(rng):
    """Move every element of an array by one ulp up, down or not, at random."""
    def move(w):
        w = np.asarray(w)
        u = rng.integers(-1, 2, size=w.shape)
        return jnp.asarray(np.where(u > 0, np.nextafter(w, np.float32(np.inf)),
                                    np.where(u < 0, np.nextafter(
                                        w, np.float32(-np.inf)), w)))
    return move


def _reference_ulp_spread(method, jparams, jcfg, calib, draws=2):
    """How far the reference's own calibration CE moves under one-ulp
    changes, the largest of ``draws``: of GPTQ's output (the pipeline's
    fake-quant re-rounds several % of its elements at exact round-half
    ties, so an ulp decides them) or of OmniQuant's input weights (200 Adam steps
    through a rounding STE: a code that flips at a near tie sends the block
    down another trajectory)."""
    qc = jq.QuantConfig(2, 32)
    rng = np.random.default_rng(0)

    def ce(params_q):
        return float(jcalib_ce(jmodel.forward(params_q, jcfg, calib), calib,
                               jcfg.vocab_size))

    if method == "gptq":
        base = jgptq.gptq_process_dense(jparams, jcfg, calib, qc)

        def run(move):
            return ce(jrtn.map_quantizable(
                base, lambda w, p: jq.fake_quant(move(w), qc)))
    else:
        def run(move):
            return ce(jquantize_model(jax.tree.map(move, jparams), jcfg, qc,
                                      method=method,
                                      calib_tokens=calib).params_q)
    ce0 = run(lambda w: w)
    return max(abs(run(_ulp(rng)) - ce0) for _ in range(draws))


def test_trained_tiny_ordering_and_ce_match_reference(trained_tiny, calib):
    """``test_baselines.py:102-118`` on the port, beside the reference: 2-bit
    RTN hurts the trained model, AWQ and GPTQ beat RTN, and the port's
    calibration CE per method is the reference's within rtol 1e-3 — for
    GPTQ and OmniQuant within twice the reference's own one-ulp spread
    where that is wider (:func:`_reference_ulp_spread`): the port lands on
    another of the trajectories that an ulp sends the reference down."""
    jparams, jcfg = trained_tiny
    tcfg = tget_config("opt-tiny").reduced(
        **{f: getattr(jcfg, f) for f in ("n_layers", "d_model", "d_ff",
                                         "vocab_size", "n_heads",
                                         "n_kv_heads", "max_seq_len")})
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    toks = np.asarray(calib)
    ttoks = torch.from_numpy(toks.astype(np.int64))
    ce_t, ce_j = {}, {}
    for m in METHODS:
        jr = jquantize_model(jparams, jcfg, jq.QuantConfig(2, 32), method=m,
                             calib_tokens=calib)
        ce_j[m] = float(jcalib_ce(jmodel.forward(jr.params_q, jcfg, calib),
                                  calib, jcfg.vocab_size))
        tr = tquantize_model(tparams, tcfg, tq.QuantConfig(2, 32), m, toks,
                             device="cpu")
        ce_t[m] = float(tcalib_ce(tmodel.forward(tr.params_q, tcfg, ttoks),
                                  ttoks, tcfg.vocab_size))
    ce_fp = float(tcalib_ce(tmodel.forward(tparams, tcfg, ttoks), ttoks,
                            tcfg.vocab_size))
    assert ce_fp < ce_t["rtn"], "2-bit RTN must visibly hurt a trained model"
    assert ce_t["awq"] < ce_t["rtn"]
    assert ce_t["gptq"] < ce_t["rtn"]
    for m in ("rtn", "awq"):
        np.testing.assert_allclose(ce_t[m], ce_j[m], rtol=1e-3, err_msg=m)
    for m in ("gptq", "omniquant"):
        bar = max(1e-3 * ce_j[m], 2 * _reference_ulp_spread(m, jparams, jcfg,
                                                            calib))
        assert abs(ce_t[m] - ce_j[m]) <= bar, (m, ce_t[m], ce_j[m], bar)
