"""The device's idle share of the profiled job, in %."""
from perfbench.metrics._window import idle_pct


def read(rec):
    return idle_pct(rec) if rec.kind == "search" else None
