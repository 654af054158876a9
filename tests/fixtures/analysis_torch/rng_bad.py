"""Fixture: draws from process-global generators (5 findings expected)."""
import numpy as np
import torch


def bad_global_draw(shape):
    return torch.randn(shape)              # the global torch generator


def bad_in_place(x):
    return x.normal_(0.0, 1.0)             # in-place, global generator


def bad_seed():
    torch.manual_seed(0)                   # seeds the global generator
    return torch.zeros(3)


def bad_numpy(n):
    np.random.seed(0)                      # numpy's global state
    return np.random.normal(size=n)
