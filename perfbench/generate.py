"""Seeds for the parts of a run, derived from the run's seed: the weights,
the calibration batch, each job's proposals. A traffic mix's parameters
(``perfbench/traffic/<mix>.json``) fix the sizes; the seed draws only what
the inputs say, so every seed gives the same work.
"""
from __future__ import annotations

import numpy as np


def derive_seed(seed: int, *words: int, bits: int = 62) -> int:
    """A seed below 2**bits for a part of the run, from the run's seed."""
    state = np.random.SeedSequence([int(seed), *map(int, words)]) \
        .generate_state(2, np.uint32)
    return ((int(state[0]) << 32) | int(state[1])) >> (64 - bits)
