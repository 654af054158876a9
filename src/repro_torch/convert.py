"""Carry a reference param tree across: numpy leaves -> the port's tensors."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["params_from_numpy"]


def _leaf(x, dev):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":       # ml_dtypes bf16 has no torch view
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(dev)    # a writable copy


def params_from_numpy(tree, device="cuda"):
    """Nested dict of numpy arrays (the reference tree after
    ``jax.tree.map(np.asarray, params)``) -> the same dict of tensors on
    ``device``, leaf for leaf, dtype kept."""
    dev = resolve_device(device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        return _leaf(t, dev)

    return walk(tree)
