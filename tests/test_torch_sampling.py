"""Sampled decoding of the port (``repro_torch.serving.decode``) held by its
distribution and by the reference's reach.

- Every token keeps finite Gumbel noise: the uniform draws lie in
  [finfo(f32).tiny, 1), as those of ``jax.random.categorical`` do. The
  stream of seed 0, token index 8 draws u = 0 at index 44874 of opt-1.3b's
  50272-entry vocabulary; with that entry's logit far above the rest, the
  reference samples it, and so must the port.
- Many draws at a small vocabulary follow softmax(logits / T) over the
  top-k kept set: a chi-square test at p >= 1e-3, through both samplers,
  with and without top-k.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from helpers.torch_parity import one_torch_thread  # noqa: F401
from repro_torch.serving import decode as tdec

pytestmark = pytest.mark.usefixtures("one_torch_thread")

V_OPT = 50272          # opt-1.3b's vocabulary
ZERO_DRAW = (0, 8, 44874)   # seed, token index, where the uniform draw is 0


def _peaked_logits():
    logits = torch.full((1, V_OPT), -1e4)
    logits[0, ZERO_DRAW[2]] = 100.0
    return logits


def test_zero_uniform_draw_is_the_pinned_case():
    """The stream of (seed 0, index 8) really draws u = 0 at 44874, so the
    two tests below exercise the repaired edge."""
    seed, index, at = ZERO_DRAW
    u = torch.rand(V_OPT, generator=tdec.request_key(seed, index, "cpu"))
    assert float(u[at]) == 0.0


@pytest.mark.parametrize("sampler", ["sample_logits", "sample_logits_per_seq"])
def test_a_zero_uniform_draw_keeps_its_token(sampler):
    """Logit 100 at the u = 0 entry and -1e4 elsewhere, T = 1: the port
    draws that entry, as the reference's categorical does."""
    seed, index, at = ZERO_DRAW
    logits = _peaked_logits()
    key = [tdec.request_key(seed, index, "cpu")]
    if sampler == "sample_logits":
        tok = tdec.sample_logits(logits, key, temperature=1.0)
    else:
        tok = tdec.sample_logits_per_seq(logits, key, [1.0], [0])
    assert int(tok[0]) == at
    want = jax.random.categorical(jax.random.PRNGKey(seed),
                                  jnp.asarray(logits.numpy()), axis=-1)
    assert int(want[0]) == at


def test_gumbel_noise_is_finite_at_a_zero_draw():
    seed, index, at = ZERO_DRAW
    noise = tdec._gumbel([tdec.request_key(seed, index, "cpu")], V_OPT, "cpu")
    assert bool(torch.isfinite(noise).all())
    assert float(noise[0, at]) < -4.0     # the smallest noise of the row


N_DRAWS = 6000
V_SMALL = 12


def _softmax_kept(logits, temperature, top_k):
    z = logits / temperature
    if top_k:
        kth = np.sort(z)[::-1][top_k - 1]
        z = np.where(z >= kth, z, -np.inf)
    p = np.exp(z - z.max())
    return p / p.sum()


@pytest.mark.parametrize("sampler", ["sample_logits", "sample_logits_per_seq"])
@pytest.mark.parametrize("temperature,top_k", [(1.0, 0), (0.6, 0), (1.7, 5),
                                               (1.0, 3)])
def test_draws_follow_softmax_over_the_kept_set(sampler, temperature, top_k):
    """N_DRAWS rows of the same logits, each with its own (seed, index)
    stream: the token counts against softmax(logits / T) after top-k, by a
    chi-square test over the kept tokens; nothing outside them is drawn."""
    logits = np.random.default_rng(3).normal(size=V_SMALL).astype(np.float32)
    rows = torch.from_numpy(np.tile(logits, (N_DRAWS, 1)))
    keys = [tdec.request_key(11, i, "cpu") for i in range(N_DRAWS)]
    if sampler == "sample_logits":
        toks = tdec.sample_logits(rows, keys, temperature=temperature,
                                  top_k=top_k)
    else:
        toks = tdec.sample_logits_per_seq(rows, keys, [temperature] * N_DRAWS,
                                          [top_k] * N_DRAWS)
    counts = np.bincount(toks.numpy(), minlength=V_SMALL)
    p = _softmax_kept(logits.astype(np.float64), temperature, top_k)
    kept = p > 0
    assert counts[~kept].sum() == 0
    assert kept.sum() == (top_k or V_SMALL)
    res = stats.chisquare(counts[kept], N_DRAWS * p[kept])
    assert res.pvalue >= 1e-3, (counts, N_DRAWS * p)
