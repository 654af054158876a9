"""Helpers the per-layer readers share: the window's time outside the
profiled stretch, and the spans of a record that count."""
from perfbench.window import spans_inside


def unprofiled_s(rec) -> float:
    """The window's seconds outside the profiled stretch."""
    t0, t1 = rec.window
    if rec.stretch is None:
        return t1 - t0
    s, e = rec.stretch
    return (t1 - t0) - max(0.0, min(e, t1) - max(s, t0))


def mean_ms(rec, spans):
    """Mean length in ms of the spans that end inside the window, outside
    the profiled stretch, or None."""
    if spans is None:
        return None
    inside = spans_inside(spans, *rec.window, exclude=rec.stretch)
    if not inside:
        return None
    return sum(e - s for s, e in inside) / len(inside) * 1e3


def idle_pct(rec):
    """The device's idle share of the profiled stretch, in %."""
    if rec.trace is None or rec.trace.busy_s <= 0:
        return None
    return max(0.0, 1.0 - rec.trace.busy_s / rec.trace.window_s) * 100
