"""The measured window's arithmetic, on the host's monotonic clock.

A run measures from ``t0`` to ``t1 = t0 + seconds``. Work counts when it
completes inside ``[t0, t1]``: a search step when its proposals are scored
(the program's ``search_proposals_total`` counter, read at the two edges).
A job cut by ``t1`` counts the steps it finished before it.
"""
from __future__ import annotations

import threading
import time


def inside(t: float, t0: float, t1: float) -> bool:
    return t0 <= t <= t1


def spans_inside(spans, t0: float, t1: float, exclude=None):
    """(start, end) spans that end inside the window and do not overlap the
    ``exclude`` interval (the profiled stretch)."""
    out = []
    for s, e in spans:
        if not inside(e, t0, t1):
            continue
        if exclude is not None and s < exclude[1] and e > exclude[0]:
            continue
        out.append((s, e))
    return out


class EdgeReader:
    """Reads ``read()`` now (the window's start) and again at ``deadline``
    on the monotonic clock, from a thread of its own, so the reading at the
    window's end does not wait for the work in flight."""

    def __init__(self, read, deadline: float):
        self._read = read
        self.start = read()
        self.end = None
        self._deadline = deadline
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        delay = self._deadline - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        self.end = self._read()

    def delta(self, timeout: float = 60.0) -> float:
        self._thread.join(timeout)
        if self.end is None:
            raise RuntimeError("the window's end was never read")
        return self.end - self.start
