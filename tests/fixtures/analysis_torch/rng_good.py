"""Fixture: every draw names its stream (0 findings expected)."""
import numpy as np
import torch


def good_draws(shape, seed):
    g = torch.Generator().manual_seed(seed)
    a = torch.randn(shape, generator=g)
    b = torch.empty(shape).normal_(0.0, 1.0, generator=g)
    idx = torch.randperm(shape[0], generator=g)
    return a + b, idx


def good_numpy(n, seed):
    rng = np.random.default_rng(seed)
    state = np.random.SeedSequence([seed, 1]).generate_state(1)
    return rng.normal(size=n), rng.multinomial(3, [0.5, 0.5]), state
