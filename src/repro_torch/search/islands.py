"""Island model: independent chains + elite migration on a cadence.

Each island owns its full chain state (transforms, fake-quant stack, host
stream, proposal source) and explores independently; every
``migrate_every`` steps the global elite's best state replaces the worst
island's current state.

Streams (:func:`make_island_streams`):
- the host stream is the reference's verbatim: island 0 draws from
  ``np.random.default_rng(seed)``, island i from
  ``np.random.default_rng([seed, i])``, so the unit picks and accept
  uniforms of every island match the JAX engine's;
- the proposal source replaces the reference's per-island ``jax.random``
  key: island 0's is exactly the single-chain
  ``NativeProposals(seed, device)``; island i's is a ``NativeProposals``
  seeded with the first 64-bit word of
  ``np.random.SeedSequence([seed, i]).generate_state(1, np.uint64)``.

So a 1-island run and island 0 of an N-island run walk identical
trajectories until a migration rewrites someone's state.

Across processes (``SearchConfig(mapped=True)``: one island per rank),
:func:`migrate_on_mesh` is the same migration over a process group: one
scalar race (:func:`elite_over_mesh`), one all-gather of the current
losses, and the winner's elite state broadcast from its rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List

import numpy as np
import torch

from repro_torch.core.invariance import NativeProposals
from repro_torch.dist import runtime
from repro_torch.dist.collectives import (all_gather, argmin_allgather,
                                          elite_broadcast)

__all__ = ["IslandState", "island_seed", "make_island_streams", "migrate",
           "elite_over_mesh", "migrate_on_mesh"]


@dataclasses.dataclass
class IslandState:
    """One chain's complete mutable search state."""

    index: int
    rng: np.random.Generator          # host stream: unit picks + accept draws
    proposals: Callable               # (t_u, k, pcfg) -> [FFNTransform] * k
    transforms: Any                   # stacked per-unit FFNTransform
    fq_stack: Any                     # current fake-quant unit stack
    current_loss: float
    best_loss: float                  # elite (lowest loss ever seen)
    best_transforms: Any
    best_fq: Any
    history: list = dataclasses.field(default_factory=list)
    n_accept: int = 0


def island_seed(seed: int, index: int) -> int:
    """Seed of island ``index``'s native proposal generator (``seed`` itself
    for island 0)."""
    if index == 0:
        return int(seed)
    return int(np.random.SeedSequence([seed, index])
               .generate_state(1, np.uint64)[0])


def make_island_streams(seed: int, index: int, device, proposer=None):
    """(host rng, native proposal source on ``device`` drawing with
    ``proposer``, :func:`core.invariance.propose` by default) for island
    ``index``; island 0 reproduces the single-chain streams exactly."""
    rng = (np.random.default_rng(seed) if index == 0
           else np.random.default_rng([seed, index]))
    return rng, NativeProposals(island_seed(seed, index), device, proposer)


def migrate(islands: List[IslandState]) -> bool:
    """Elite migration: the best island's elite state overwrites the worst
    island's CURRENT state (its own elite snapshot is kept unless beaten).
    The source is the first island of minimum ``best_loss``, the
    destination the first of maximum ``current_loss``; nothing moves when
    they are the same island or the source is not strictly better.
    Returns True iff any state moved. Consumes no RNG from any island."""
    if len(islands) < 2:
        return False
    src = min(islands, key=lambda s: s.best_loss)
    dst = max(islands, key=lambda s: s.current_loss)
    if src is dst or src.best_loss >= dst.current_loss:
        return False
    dst.transforms = src.best_transforms
    dst.fq_stack = src.best_fq
    dst.current_loss = src.best_loss
    if src.best_loss < dst.best_loss:
        dst.best_loss = src.best_loss
        dst.best_transforms = src.best_transforms
        dst.best_fq = src.best_fq
    return True


def elite_over_mesh(loss, group=None):
    """(global min loss, owning rank) over ``group``: the migration source's
    scalar race across ranks (ties to the lowest rank)."""
    return argmin_allgather(loss, group)


def migrate_on_mesh(best_loss, cur_loss, transforms, fq_stack,
                    best_transforms, best_fq, group=None):
    """One elite migration over ``group``, each rank holding one island.

    Semantically :func:`migrate` — the same tie-breaks (the first minimum
    ``best_loss`` is the source, the first maximum ``cur_loss`` the
    destination), the same guard (nothing moves when they are the same
    rank or the source is not strictly better), the same update of the
    destination's elite. The scalar exchange is one :func:`elite_over_mesh`
    and one all-gather of the current losses; the winner's elite state
    moves by ``elite_broadcast``. Returns the four state trees (this rank's
    new ones) and the "did anything move" flag, the same on every rank."""
    gmin, src = elite_over_mesh(best_loss, group)
    cur_all = torch.cat(all_gather(gmin.new_tensor([float(cur_loss)]),
                                   group))
    dst = int(torch.argmax(cur_all))
    did = src != dst and bool(gmin < cur_all[dst])
    if not did:
        return transforms, fq_stack, best_transforms, best_fq, False
    elite_t = elite_broadcast(best_transforms, src, group)
    elite_fq = elite_broadcast(best_fq, src, group)
    if runtime.group_rank(group) == dst:
        transforms, fq_stack = elite_t, elite_fq
        if bool(gmin < gmin.new_tensor(float(best_loss))):
            best_transforms, best_fq = elite_t, elite_fq
    return transforms, fq_stack, best_transforms, best_fq, True
