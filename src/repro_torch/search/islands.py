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
trajectories until a migration rewrites someone's state. Migration across
devices (the reference's mesh functions) waits for the multi-GPU port.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List

import numpy as np

from repro_torch.core.invariance import NativeProposals

__all__ = ["IslandState", "island_seed", "make_island_streams", "migrate"]


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
