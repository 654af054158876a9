"""Observability for the port: metrics registry, span tracing, and the
multi-process aggregate (``dist_snapshot``: every rank's registry merged,
identical on every rank; ``write_snapshot``: rank 0 commits it).
Call sites write ``from repro_torch import obs``."""
from __future__ import annotations

from repro_torch.obs.registry import (LATENCY_BUCKETS_S, Counter, Gauge,
                                      Histogram, Registry, counter, gauge,
                                      get_registry, hist_quantile, histogram,
                                      merge_snapshots, snapshot_json)
from repro_torch.obs.tracing import (emit, enable_profiler, profile_range,
                                     set_trace_sink, trace_span)
from repro_torch.obs.aggregate import (DEFAULT_METRICS_PATH, dist_snapshot,
                                       write_snapshot)

__all__ = [
    "LATENCY_BUCKETS_S", "Counter", "Gauge", "Histogram", "Registry",
    "counter", "gauge", "get_registry", "hist_quantile", "histogram",
    "emit", "enable_profiler", "profile_range", "set_trace_sink",
    "trace_span", "DEFAULT_METRICS_PATH", "write_snapshot", "dist_snapshot",
    "merge_snapshots", "snapshot_json",
]

