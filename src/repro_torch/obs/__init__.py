"""Observability for the port: metrics registry, span tracing and a
single-process snapshot writer (the part of the reference's ``repro.obs``
that serving and the search read; the multi-host merge waits for the
multi-GPU slice).
Call sites write ``from repro_torch import obs``."""
from __future__ import annotations

import json
import pathlib
from typing import Optional

from repro_torch.obs.registry import (LATENCY_BUCKETS_S, Counter, Gauge,
                                      Histogram, Registry, counter, gauge,
                                      get_registry, hist_quantile, histogram)
from repro_torch.obs.tracing import (emit, enable_profiler, profile_range,
                                     set_trace_sink, trace_span)

__all__ = [
    "LATENCY_BUCKETS_S", "Counter", "Gauge", "Histogram", "Registry",
    "counter", "gauge", "get_registry", "hist_quantile", "histogram",
    "emit", "enable_profiler", "profile_range", "set_trace_sink",
    "trace_span", "DEFAULT_METRICS_PATH", "write_snapshot",
]

# under the git-ignored build/ (relative to the working directory), so a
# CLI run from a checkout writes nothing that git tracks
DEFAULT_METRICS_PATH = "build/obs/metrics.json"


def write_snapshot(snapshot: Optional[dict] = None,
                   path=DEFAULT_METRICS_PATH, *,
                   registry: Optional[Registry] = None,
                   merge: bool = True) -> pathlib.Path:
    """Write this process's snapshot (``registry`` or the default one) to
    ``path``. With ``merge=True`` an existing file's metrics are kept unless
    this snapshot carries the same name, so sequential runs accumulate
    into one report."""
    if snapshot is None:
        snapshot = (registry or get_registry()).snapshot()
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    out = snapshot
    if merge and p.exists():
        try:
            prev = json.loads(p.read_text())
        except ValueError:
            prev = {}
        out = {**prev, **snapshot}
    p.write_text(json.dumps(out, indent=1, sort_keys=True))
    return p
