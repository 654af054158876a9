"""Tried-point tabu/dedup memory for search proposals.

The reference's ``search/tabu.py`` host logic, verbatim. A greedy chain
re-proposes from the SAME state until a move is accepted, so the proposal
distribution keeps re-drawing points the engine already paid a full
calibration forward to reject. Here:

- a fingerprint is state-contextual: it hashes (chain digest, unit index,
  candidate transform bytes). The chain digest advances on every ACCEPTED
  move, so rejected-candidate fingerprints stay valid exactly while the
  chain state they were evaluated against is unchanged, and the whole
  memory implicitly invalidates the moment the state moves (no sweep);
- a hit replays the cached (loss, primary, aux) scalars instead of paying
  the device eval; the skip draws no extra proposal — the step's source
  was already called — and the accept uniform is drawn (T > 0) exactly as
  on the eval path;
- capacity-bounded LRU (``OrderedDict``), per island. A hit can never block
  an improving move: the cached scalars feed the SAME accept rule a fresh
  eval would, so only moves already seen-and-rejected at this state are
  short-circuited.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Optional, Tuple

import numpy as np

__all__ = ["TabuMemory", "transform_bytes"]


def transform_bytes(t) -> bytes:
    """Canonical bytes of one candidate ``FFNTransform`` (π, s, φ), copied
    to the host: one device-to-host copy per tensor, paid only when the
    tabu memory is on. The bytes are canonical within the port only: π is
    int64 here and int32 in the reference, so a port fingerprint never
    equals a reference one."""
    return b"".join(np.ascontiguousarray(x.detach().cpu().numpy()).tobytes()
                    for x in t)


class TabuMemory:
    """Capacity-bounded tried-point memory for ONE island's chain."""

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._seen: "OrderedDict[bytes, Tuple[float, float, float]]" = \
            OrderedDict()
        self._digest = b"\x00" * 16
        self.hits = 0

    def fingerprint(self, u: int, cand: bytes) -> bytes:
        h = hashlib.blake2b(digest_size=16)
        h.update(self._digest)
        h.update(int(u).to_bytes(4, "little"))
        h.update(cand)
        return h.digest()

    def lookup(self, fp: bytes) -> Optional[Tuple[float, float, float]]:
        """Cached (loss, primary, aux) for a tried point, or None. A hit
        refreshes LRU recency and bumps the hit counter."""
        got = self._seen.get(fp)
        if got is not None:
            self._seen.move_to_end(fp)
            self.hits += 1
        return got

    def record(self, fp: bytes, loss: float, primary: float,
               aux: float) -> None:
        self._seen[fp] = (loss, primary, aux)
        self._seen.move_to_end(fp)
        while len(self._seen) > self.capacity:
            self._seen.popitem(last=False)

    def advance(self, accepted_cand: bytes) -> None:
        """Chain the digest past an accepted move: every fingerprint minted
        before this instant stops matching (stale entries age out of the
        LRU; they can never collide with post-move fingerprints)."""
        h = hashlib.blake2b(digest_size=16)
        h.update(self._digest)
        h.update(accepted_cand)
        self._digest = h.digest()

    def adopt_digest(self, other: "TabuMemory") -> None:
        """Migration rewrote this island's state to ``other``'s elite: adopt
        a digest derived from the donor's so stale local entries die."""
        h = hashlib.blake2b(digest_size=16)
        h.update(other._digest)
        h.update(b"migrate")
        self._digest = h.digest()

    def __len__(self) -> int:
        return len(self._seen)
