"""Device time of named kernels from a ``torch.profiler`` trace.

``trace_ms`` is a frozen copy of ``chip_smoke.py``'s: the benchmark reads
the trace of a stretch of its own window, so ``chip_smoke.py``'s
``device_ms``, which runs a function under the profiler on its own, has no
use here and is not copied.
"""
from __future__ import annotations


def trace_ms(events, fragments, calls):
    """From a profiler's ``key_averages()`` over ``calls`` calls: (device ms
    per call of the kernels whose names hold one of ``fragments``, or None
    when the trace is incomplete; their event counts by name; the names of
    the other events with device time). A trace is complete when it holds
    these kernels and each was counted a whole multiple of ``calls`` times:
    after long traces the profiler drops some kernels' events and then
    reads low."""
    total, counts, others = 0, {}, []
    for e in events:
        t = getattr(e, "self_device_time_total", 0)
        if t <= 0:
            continue
        if any(f in e.key for f in fragments):
            total += t
            counts[e.key] = counts.get(e.key, 0) + e.count
        else:
            others.append(e.key)
    whole = all(n > 0 and n % calls == 0 for n in counts.values())
    ms = total / calls / 1e3 if counts and whole else None
    return ms, counts, others
