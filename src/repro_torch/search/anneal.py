"""Temperature schedules + Metropolis acceptance for the annealed search.

The legacy hill climb accepts iff the loss strictly improves; simulated
annealing relaxes that to accepting an uphill move with probability
``exp(-Δ/T)``. Every schedule here returns ``0.0`` everywhere when the
initial temperature is ``0.0``, and ``accept(Δ, 0.0, ·)`` is exactly the
strict ``Δ < 0`` comparison — so the greedy hill-climb is the T=0 special
case of the engine, bit-for-bit (no extra RNG draws happen at T=0: the
uniform is only consumed by the T>0 branch, keeping the proposal stream
identical to the legacy loop).
"""
from __future__ import annotations

import math
from typing import Callable, Optional

__all__ = ["temperature_schedule", "accept", "SCHEDULES"]

SCHEDULES = ("constant", "geometric", "linear")


def temperature_schedule(kind: str, t0: float, steps: int,
                         t_final: float = 1e-4) -> Callable[[int], float]:
    """Return ``T(step)`` for ``step`` in [1, steps].

    - ``constant``:  T ≡ t0
    - ``geometric``: T decays from t0 to ``t_final`` on a log-linear ramp
      (the classic annealing schedule)
    - ``linear``:    T decays from t0 to 0 linearly

    ``t0 == 0`` short-circuits every schedule to the all-zeros function.
    """
    if kind not in SCHEDULES:
        raise ValueError(f"unknown anneal schedule {kind!r}; pick from {SCHEDULES}")
    if t0 <= 0.0:
        return lambda step: 0.0
    if kind == "constant":
        return lambda step: t0
    if kind == "linear":
        return lambda step: t0 * max(0.0, 1.0 - step / max(steps, 1))
    t_final = min(t_final, t0)
    ratio = t_final / t0
    return lambda step: t0 * ratio ** (min(step, steps) / max(steps, 1))


def accept(delta: float, temperature: float, uniform: Optional[float]) -> bool:
    """Metropolis rule. ``uniform`` is a pre-drawn U[0,1) sample; it may be
    None when ``temperature == 0`` (the greedy branch never reads it)."""
    if delta < 0.0:
        return True
    if temperature <= 0.0:
        return False
    return uniform < math.exp(-delta / temperature)
