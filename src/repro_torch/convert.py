"""Carry a reference param tree across: numpy leaves -> the port's tensors.

A packed leaf (the reference's ``QTensor`` after ``jax.tree.map(np.asarray,
...)``: an object with ``packed``/``scale``/``zero``/``bits``/``group_size``/
``shape`` attributes, recognised by those attributes) becomes the port's
``QTensor``, its uint32 words viewed as int32 bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quant import QTensor
from repro_torch.device import resolve_device

__all__ = ["params_from_numpy"]


_QT_FIELDS = ("packed", "scale", "zero", "bits", "group_size", "shape")


def _leaf(x, dev):
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":       # ml_dtypes bf16 has no torch view
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(dev)    # a writable copy


def params_from_numpy(tree, device="cuda"):
    """Nested dict of numpy arrays (the reference tree after
    ``jax.tree.map(np.asarray, params)``) -> the same dict of tensors on
    ``device``, leaf for leaf, dtype kept; packed leaves become QTensors."""
    dev = resolve_device(device)

    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if all(hasattr(t, a) for a in _QT_FIELDS):
            words = np.asarray(t.packed)
            return QTensor(_leaf(words.view(np.int32), dev), _leaf(t.scale, dev),
                           _leaf(t.zero, dev), int(t.bits), int(t.group_size),
                           tuple(int(d) for d in t.shape))
        return _leaf(t, dev)

    return walk(tree)
