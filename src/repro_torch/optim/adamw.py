"""AdamW + LR schedules + global-norm clipping, from scratch (no
``torch.optim``): the reference's ``repro.optim.adamw`` as functions over
dict-of-tensor trees.

The state mirrors the param tree (``{"m", "v"}`` f32 per leaf, plus an
int32 ``"step"`` scalar), so it checkpoints under the reference's keys.

Where the reference's numbers come from, and how they are kept here:
- ``jax.tree.leaves`` walks dict keys in sorted order, so the global norm
  sums the per-leaf squares in that order (:func:`tree_leaves`);
- the reference does its scalar arithmetic in f32 arrays (``b1 ** step``,
  the warmup ratio, ``cos(pi * t)``), but folds products of Python scalars
  such as ``min_lr_frac * lr`` in double first (JAX's weak typing): each
  such constant is folded in Python and then made an f32 tensor
  (:func:`_f32`);
- every division is by a same-device f32 tensor: PyTorch's division by a
  Python scalar (and ``scalar / tensor``) goes through a reciprocal, which
  is not the reference's correctly rounded division;
- ``step`` is incremented before the schedule is read.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "clip_by_global_norm",
           "cosine_schedule", "linear_warmup", "tree_map", "tree_leaves"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of a nested dict (and the same-keyed ``rest``),
    keys in ``tree``'s order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves of a nested dict in ``jax.tree.leaves`` order (sorted keys)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def adamw_init(params):
    leaves = tree_leaves(params)
    return {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32, device=leaves[0].device),
    }


def clip_by_global_norm(grads, max_norm: float):
    leaves = tree_leaves(grads)
    dev = leaves[0].device
    total = None
    for g in leaves:
        s = torch.sum(torch.square(g.float()))
        total = s if total is None else total + s
    gnorm = torch.sqrt(total)
    scale = torch.minimum(_f32(1.0, dev), _f32(max_norm, dev)
                          / torch.clamp_min(gnorm, 1e-12))
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gnorm


def cosine_schedule(cfg: AdamWConfig) -> Callable:
    def lr_at(step):
        dev = step.device
        step = step.to(torch.float32)
        warm = _f32(cfg.lr, dev) * step / _f32(max(cfg.warmup_steps, 1), dev)
        t = torch.clamp((step - _f32(cfg.warmup_steps, dev))
                        / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), dev),
                        0.0, 1.0)
        cos = (_f32(cfg.min_lr_frac * cfg.lr, dev)
               + _f32(0.5 * (1 - cfg.min_lr_frac) * cfg.lr, dev)
               * (1 + torch.cos(_f32(math.pi, dev) * t)))
        return torch.where(step < _f32(cfg.warmup_steps, dev), warm, cos)
    return lr_at


def linear_warmup(cfg: AdamWConfig) -> Callable:
    def lr_at(step):
        dev = step.device
        ratio = (step.to(torch.float32) + 1) / _f32(max(cfg.warmup_steps, 1), dev)
        return _f32(cfg.lr, dev) * torch.minimum(_f32(1.0, dev), ratio)
    return lr_at


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, schedule: Callable = None):
    """One AdamW step. Returns (new_params, new_state, metrics); the inputs
    are not modified."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    step = state["step"] + 1
    lr = (schedule or cosine_schedule(cfg))(step)
    dev = step.device
    sf = step.to(torch.float32)
    b1, b2 = _f32(cfg.b1, dev), _f32(cfg.b2, dev)
    c1, c2 = _f32(1 - cfg.b1, dev), _f32(1 - cfg.b2, dev)
    bc1 = 1 - torch.pow(b1, sf)
    bc2 = 1 - torch.pow(b2, sf)
    eps, wd = _f32(cfg.eps, dev), _f32(cfg.weight_decay, dev)

    def upd(p, g, m, v):
        gf = g.float()
        m2 = b1 * m + c1 * gf
        v2 = b2 * v + c2 * torch.square(gf)
        delta = (m2 / bc1) / (torch.sqrt(v2 / bc2) + eps) + wd * p.float()
        return (p.float() - lr * delta).to(p.dtype), m2, v2

    out = tree_map(upd, params, grads, state["m"], state["v"])
    new_params, new_m, new_v = (tree_map(lambda o, i=i: o[i], out)
                                for i in range(3))
    return new_params, {"m": new_m, "v": new_v, "step": step}, \
        {"grad_norm": gnorm, "lr": lr}
