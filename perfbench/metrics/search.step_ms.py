"""Search engine: the mean ``search.step`` span (one island step: the
candidate build, the scoring forward, the accept) of the window, in ms;
the profiled job left out."""
from perfbench.metrics._window import mean_ms


def read(rec):
    if rec.kind != "search":
        return None
    return mean_ms(rec, rec.step_spans)
