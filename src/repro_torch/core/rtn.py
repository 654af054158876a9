"""Round-to-nearest baseline: plain asymmetric group quantization of every
quantizable weight (paper Table 1, 'RTN')."""
from __future__ import annotations

from repro_torch.core.quant import QuantConfig, fake_quant
from repro_torch.models.model import quantizable_paths

__all__ = ["rtn_quantize", "get_by_path", "set_by_path", "map_quantizable"]


def get_by_path(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def set_by_path(tree, path, value):
    """A new tree with ``value`` at ``path``; ``tree`` is left as it was."""
    if not path:
        return value
    out = dict(tree)
    out[path[0]] = set_by_path(tree[path[0]], path[1:], value)
    return out


def map_quantizable(params, fn, only=None):
    """Apply fn(leaf, path) to every quantizable weight leaf."""
    out = params
    for path in quantizable_paths(params):
        if only is not None and not only(path):
            continue
        out = set_by_path(out, path, fn(get_by_path(out, path), path))
    return out


def rtn_quantize(params, qcfg: QuantConfig, only=None):
    return map_quantizable(params, lambda w, _: fake_quant(w, qcfg), only=only)
