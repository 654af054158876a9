"""The batch-wide sampled paged decode step
(``make_paged_decode_step(cfg, temperature=, top_k=)``) against the
reference's, from the same converted packed weights and page pools
(opt-tiny reduced, MHA).

- ``temperature <= 0`` is the greedy step whatever ``top_k`` is: its tokens
  equal the reference's greedy step's.
- ``temperature > 0`` takes one generator a row. Its noise is not
  ``jax.random``'s, so its tokens are held by their properties: each lies in
  the top-k of the reference's step logits (the port's within 1e-4 of them,
  the bar of ``tests/test_paged.py``); the same keys give the same tokens; the step equals
  ``sample_logits`` on the greedy step's logits with the same keys; and
  many draws follow softmax(logits / T) over the kept set (chi-square,
  p >= 1e-3).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from helpers.torch_parity import one_torch_thread, to_np  # noqa: F401
from repro.configs import get_config as jget_config
from repro.core.quant import QuantConfig as JQuantConfig
from repro.quantized.qmodel import pack_model as jpack_model
from repro.serving import decode as jdec
from repro_torch.configs import get_config as tget_config
from repro_torch.convert import params_from_numpy
from repro_torch.models.model import init_params as tinit_params
from repro_torch.serving import decode as tdec
from test_torch_serving import TINY, _jax_decode_logits, _random_pools

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BT = np.arange(1, 13, dtype=np.int32).reshape(3, 4)
LENS = np.asarray([5, 9, 23], np.int32)
TOKS = np.asarray([[7], [11], [200]], np.int64)
N_DRAWS = 3000


@pytest.fixture(scope="module")
def case():
    """(tcfg, port packed, numpy pools, reference logits (B, V) of the
    step at BT / LENS / TOKS, the reference's greedy tokens (B,) from its
    step with ``temperature=0, top_k=5``). MHA, as opt-1.3b's heads; the
    routes' parity is ``test_torch_serving.py``'s. The weights are drawn
    by the port's init, packed by the reference's ``pack_model`` and
    converted back; the reference runs compiled."""
    jcfg = jget_config("opt-tiny").reduced(**TINY, n_kv_heads=4)
    tcfg = tget_config("opt-tiny").reduced(**TINY, n_kv_heads=4)
    params = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tinit_params(
        tcfg, torch.Generator().manual_seed(0), device="cpu"))
    jpq = jax.jit(lambda p: jpack_model(
        p, JQuantConfig(bits=2, group_size=32)))(params)
    tpq = params_from_numpy(jax.tree.map(np.asarray, jpq), "cpu")
    pools = _random_pools(tcfg, n_pages=13, psz=8, seed=3)
    jpools = {k: jnp.asarray(v) for k, v in pools.items()}
    args = (jnp.asarray(TOKS, jnp.int32), jpools, jnp.asarray(BT),
            jnp.asarray(LENS))
    jl, _ = jax.jit(lambda p, *a: _jax_decode_logits(p, jcfg, *a))(jpq,
                                                                   *args)
    jtok, _ = jdec.make_paged_decode_step(jcfg, temperature=0.0,
                                          top_k=5)(jpq, *args)
    return tcfg, tpq, pools, np.asarray(jl)[:, -1], np.asarray(jtok)[:, 0]


def _run(step, tpq, pools, *extra, toks=TOKS, bt=BT, lens=LENS):
    tp = {k: torch.from_numpy(v.copy()) for k, v in pools.items()}
    return step(tpq, torch.from_numpy(toks), tp, torch.from_numpy(bt),
                torch.from_numpy(lens), *extra)[0]


def _keys(seed, n):
    return [tdec.request_key(seed, b, "cpu") for b in range(n)]


def _top_k_sets(logits, k):
    """Per row, the ids whose logit is at least the row's k-th largest."""
    kth = np.sort(logits, axis=-1)[:, ::-1][:, k - 1:k]
    return logits >= kth


@pytest.mark.parametrize("top_k", [0, 5])
def test_greedy_form_equals_the_reference_greedy_step(case, top_k):
    tcfg, tpq, pools, jl, jgreedy = case
    got = _run(tdec.make_paged_decode_step(tcfg, temperature=0.0,
                                           top_k=top_k), tpq, pools)
    greedy = _run(tdec.make_paged_decode_step(tcfg), tpq, pools)
    np.testing.assert_array_equal(got.numpy()[:, 0], jgreedy)
    np.testing.assert_array_equal(got.numpy(), greedy.numpy())
    np.testing.assert_array_equal(jgreedy, np.argmax(jl, axis=-1))


@pytest.mark.parametrize("temperature,top_k", [(0.8, 5), (1.0, 1), (3.0, 8)])
def test_sampled_tokens_lie_in_the_reference_top_k(case, temperature, top_k):
    """The port's logits within 1e-4 of the reference's; over 8 key draws
    every sampled token of the port lies in the reference logits' top-k."""
    tcfg, tpq, pools, jl, _ = case
    tl, _ = tdec.paged_decode_logits(
        tpq, tcfg, torch.from_numpy(TOKS),
        {k: torch.from_numpy(v.copy()) for k, v in pools.items()},
        torch.from_numpy(BT), torch.from_numpy(LENS))
    V = tcfg.vocab_size
    np.testing.assert_allclose(to_np(tl)[:, -1, :V], jl[:, :V], rtol=1e-5,
                               atol=1e-4)
    kept = _top_k_sets(jl, top_k)
    step = tdec.make_paged_decode_step(tcfg, temperature=temperature,
                                       top_k=top_k)
    for seed in range(8):
        tok = _run(step, tpq, pools, _keys(seed, 3)).numpy()[:, 0]
        assert all(kept[b, t] for b, t in enumerate(tok)), (seed, tok)


def test_sampled_step_is_deterministic_in_its_keys_and_equals_sample_logits(
        case):
    tcfg, tpq, pools, _, _ = case
    step = tdec.make_paged_decode_step(tcfg, temperature=0.8, top_k=50)
    a = _run(step, tpq, pools, _keys(7, 3))
    b = _run(step, tpq, pools, _keys(7, 3))
    assert torch.equal(a, b)
    tl, _ = tdec.paged_decode_logits(
        tpq, tcfg, torch.from_numpy(TOKS),
        {k: torch.from_numpy(v.copy()) for k, v in pools.items()},
        torch.from_numpy(BT), torch.from_numpy(LENS))
    want = tdec.sample_logits(tl[:, -1], _keys(7, 3), temperature=0.8,
                              top_k=50)
    assert torch.equal(a[:, 0], want)
    draws = {tuple(_run(step, tpq, pools, _keys(s, 3))[:, 0].tolist())
             for s in range(8)}
    assert len(draws) > 1, "eight key sets drew the same tokens"


@pytest.mark.parametrize("temperature,top_k", [(0.8, 5), (1.0, 0)])
def test_step_draws_follow_softmax_over_the_kept_set(case, temperature,
                                                     top_k):
    """N_DRAWS rows of one sequence (every row the same token, pages and
    length: each writes the same K/V into the same slot), one generator a
    row: the token counts against softmax(reference logits / T) over the
    top-k kept set, by a chi-square test (cells under 5 expected draws
    pooled); nothing outside the kept set is drawn."""
    tcfg, tpq, pools, jl, _ = case
    V = tcfg.vocab_size
    n = N_DRAWS
    step = tdec.make_paged_decode_step(tcfg, temperature=temperature,
                                       top_k=top_k)
    toks = _run(step, tpq, pools, _keys(11, n),
                toks=np.repeat(TOKS[:1], n, 0), bt=np.repeat(BT[:1], n, 0),
                lens=np.repeat(LENS[:1], n)).numpy()[:, 0]
    z = jl[0, :V].astype(np.float64) / temperature
    if top_k:
        z = np.where(_top_k_sets(jl[:1, :V], top_k)[0], z, -np.inf)
    p = np.exp(z - z.max())
    p /= p.sum()
    counts = np.bincount(toks, minlength=V)
    kept = p > 0
    assert counts[~kept].sum() == 0
    exp = n * p[kept]
    obs, small = counts[kept], exp < 5
    f_obs = np.append(obs[~small], obs[small].sum())
    f_exp = np.append(exp[~small], exp[small].sum())
    if not small.any():
        f_obs, f_exp = f_obs[:-1], f_exp[:-1]
    res = stats.chisquare(f_obs, f_exp)
    assert res.pvalue >= 1e-3, (res, f_obs, f_exp)
