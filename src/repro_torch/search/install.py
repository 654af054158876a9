"""Candidate install into a stacked tree, and the memory model's bytes.

Trees here are dicts of tensors or ``FFNTransform``s (named tuples of
tensors), nested freely; every leaf carries a leading unit axis.

- :func:`tree_install_unit` returns a FRESH tree with unit ``u`` replaced,
  so a tree held elsewhere (the elite snapshot) never changes under a later
  install. The engine installs an accepted unit this way, and
  ``install="stack"`` builds each of its K candidate stacks this way.
- :func:`cast_unit` gives a unit the stack's dtypes without installing it
  (the engine's override forward under ``install="unit"``).
- :func:`stack_unit_batch` stacks K per-unit trees along a new leading
  axis (the engine's identity transforms, one per unit).
- :func:`tree_bytes` counts the payload bytes of a tree or of a list of
  trees: the engine's ``stack_bytes`` and ``candidate_batch_bytes``
  (K × unit under ``install="unit"``, K × stack under ``"stack"``).
"""
from __future__ import annotations

import torch

__all__ = ["tree_install_unit", "cast_unit", "stack_unit_batch",
           "tree_bytes"]


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return fn(tree, *rest)


def _leaves(tree):
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def tree_install_unit(tree, u: int, unit):
    """A fresh copy of the stacked ``tree`` with index ``u`` of every leaf's
    leading axis set to the matching leaf of ``unit``."""
    def one(x, n):
        out = x.clone()
        out[u] = n.to(x.dtype)
        return out

    return _map(one, tree, unit)


def cast_unit(unit, tree):
    """``unit`` with each leaf in the dtype of the matching leaf of the
    stacked ``tree``: the cast :func:`tree_install_unit` makes on install
    (the reference's ``n[None].astype(x.dtype)``), for a unit that is read
    without being installed (``install="unit"``'s override forward)."""
    return _map(lambda n, x: n.to(x.dtype), unit, tree)


def stack_unit_batch(units):
    """[unit tree] * K -> one tree with a leading K axis on every leaf."""
    return _map(lambda *xs: torch.stack(xs), units[0], *units[1:])


def tree_bytes(tree) -> int:
    """Total payload bytes of the tensors of a tree (or list of trees)."""
    return int(sum(x.numel() * x.element_size() for x in _leaves(tree)))
