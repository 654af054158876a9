"""Process-local metrics registry: counters, gauges, fixed-bucket histograms.

The port's own copy of the reference's ``repro.obs.registry`` (stdlib only):
the instruments, ``Registry.snapshot`` and ``reset``, and the multi-process
``merge_snapshots`` / ``snapshot_json`` as they are there. The Prometheus
exposition waits for the tooling slice.

Three instrument kinds, as in the reference:

  Counter     monotonically increasing float.
  Gauge       last-set value (snapshotted as the n=1 (min, max, sum, n)
              aggregate, the reference's mergeable form).
  Histogram   fixed bucket edges declared at creation; observations land in
              the first bucket with ``value <= edge`` (Prometheus ``le``
              semantics) plus an implicit +Inf bucket; ``quantile`` answers
              to within one bucket width.

Series are keyed by free-form labels (``counter.inc(1, reason="cow")``); a
label-less call is the single unlabeled series. All mutation is
lock-guarded.

``Registry.snapshot()`` produces the canonical JSON-able form that
``obs.write_snapshot`` commits. ``reset()`` zeroes every series IN PLACE, so
instrument handles held by instrumented code stay valid across runs (the
batcher-reuse contract).
"""
from __future__ import annotations

import bisect
import json
import threading
from typing import Dict, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "hist_quantile",
           "LATENCY_BUCKETS_S", "get_registry", "counter", "gauge",
           "histogram", "merge_snapshots", "snapshot_json"]

# geometric ladder from 100us to 2 minutes: wide enough for a CPU-container
# TTFT and a real-accelerator decode step to land in informative buckets
LATENCY_BUCKETS_S = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)


def _label_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    kind = "abstract"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._series: Dict[Tuple[Tuple[str, str], ...], object] = {}

    def _reset(self) -> None:
        with self._lock:
            self._series.clear()

    def _sorted_items(self):
        return sorted(self._series.items(), key=lambda kv: kv[0])


class Counter(_Metric):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name}: negative increment {amount}")
        key = _label_key(labels)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + amount

    def value(self, **labels) -> float:
        return float(self._series.get(_label_key(labels), 0.0))

    def total(self) -> float:
        """Sum over every label series (the "all reasons" roll-up)."""
        with self._lock:
            return float(sum(self._series.values()))

    def _snapshot_series(self) -> List[dict]:
        with self._lock:
            return [{"labels": dict(k), "value": float(v)}
                    for k, v in self._sorted_items()]


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = _label_key(labels)
        with self._lock:
            self._series[key] = float(value)

    def value(self, **labels) -> Optional[float]:
        v = self._series.get(_label_key(labels))
        return None if v is None else float(v)

    def _snapshot_series(self) -> List[dict]:
        # canonical (min, max, sum, n) form: a single-host snapshot is the
        # degenerate n=1 aggregate, so local and merged snapshots share one
        # schema and merging is closed
        with self._lock:
            return [{"labels": dict(k), "min": float(v), "max": float(v),
                     "sum": float(v), "n": 1}
                    for k, v in self._sorted_items()]


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 buckets=LATENCY_BUCKETS_S):
        super().__init__(name, help)
        edges = tuple(float(e) for e in buckets)
        if list(edges) != sorted(set(edges)):
            raise ValueError(f"histogram {name}: bucket edges must be "
                             f"strictly increasing, got {edges}")
        self.edges = edges

    def observe(self, value: float, **labels) -> None:
        key = _label_key(labels)
        i = bisect.bisect_left(self.edges, value)  # le: value == edge counts
        with self._lock:
            s = self._series.get(key)
            if s is None:
                s = {"counts": [0] * (len(self.edges) + 1),
                     "sum": 0.0, "count": 0}
                self._series[key] = s
            s["counts"][i] += 1
            s["sum"] += float(value)
            s["count"] += 1

    def count(self, **labels) -> int:
        s = self._series.get(_label_key(labels))
        return 0 if s is None else int(s["count"])

    def quantile(self, q: float, **labels) -> float:
        s = self._series.get(_label_key(labels))
        if s is None:
            return 0.0
        return hist_quantile(s["counts"], self.edges, q)

    def _snapshot_series(self) -> List[dict]:
        with self._lock:
            return [{"labels": dict(k), "counts": list(v["counts"]),
                     "sum": float(v["sum"]), "count": int(v["count"])}
                    for k, v in self._sorted_items()]


def hist_quantile(counts, edges, q: float) -> float:
    """q-quantile from per-bucket counts, linearly interpolated inside the
    bucket the rank falls in — exact to within one bucket width. The open
    +Inf bucket clamps to the largest finite edge."""
    total = sum(counts)
    if total == 0:
        return 0.0
    rank = min(max(q, 0.0), 1.0) * total
    cum = 0
    for i, c in enumerate(counts):
        prev, cum = cum, cum + c
        if cum >= rank and c > 0:
            if i >= len(edges):           # +Inf bucket: no finite upper edge
                return float(edges[-1])
            lo = edges[i - 1] if i > 0 else 0.0
            frac = (rank - prev) / c
            return float(lo + (edges[i] - lo) * frac)
    return float(edges[-1])


class Registry:
    """Get-or-create instrument store. Re-requesting a name returns the SAME
    instrument (kind and — for histograms — bucket edges must match), so any
    module can say ``get_registry().counter("x_total")`` without
    coordination."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help: str, **kw) -> _Metric:
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kw)
                self._metrics[name] = m
                return m
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{m.kind}, requested {cls.kind}")
        if isinstance(m, Histogram) and "buckets" in kw and \
                tuple(float(e) for e in kw["buckets"]) != m.edges:
            raise ValueError(f"histogram {name!r} already registered with "
                             f"different bucket edges")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets=LATENCY_BUCKETS_S) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def reset(self) -> None:
        """Zero every series; instruments (and handles to them) survive."""
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            m._reset()

    def snapshot(self) -> dict:
        """Canonical JSON-able snapshot: name -> {kind, help, [edges,]
        series}. Deterministically ordered (names and label sets sorted) so
        equal registries serialize to equal JSON."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        out = {}
        for name, m in metrics:
            entry = {"kind": m.kind, "help": m.help,
                     "series": m._snapshot_series()}
            if isinstance(m, Histogram):
                entry["edges"] = list(m.edges)
            out[name] = entry
        return out


def _merge_series(kind: str, a: List[dict], b: List[dict]) -> List[dict]:
    by_key: Dict[tuple, dict] = {}
    for src in (a, b):
        for s in src:
            key = _label_key(s["labels"])
            cur = by_key.get(key)
            if cur is None:
                s = dict(s)
                if kind == "gauge":     # normalize away any stray value field
                    s = {"labels": s["labels"], "min": s["min"],
                         "max": s["max"], "sum": s["sum"], "n": s["n"]}
                by_key[key] = s
            elif kind == "counter":
                cur["value"] = cur["value"] + s["value"]
            elif kind == "gauge":
                cur["min"] = min(cur["min"], s["min"])
                cur["max"] = max(cur["max"], s["max"])
                cur["sum"] = cur["sum"] + s["sum"]
                cur["n"] = cur["n"] + s["n"]
            else:                        # histogram: exact bucket-wise add
                cur["counts"] = [x + y for x, y in
                                 zip(cur["counts"], s["counts"])]
                cur["sum"] = cur["sum"] + s["sum"]
                cur["count"] = cur["count"] + s["count"]
    return [by_key[k] for k in sorted(by_key)]


def merge_snapshots(a: dict, b: dict) -> dict:
    """Merge two ``Registry.snapshot()`` dicts: counters sum, gauges combine
    (min, max, sum, n), histograms add bucket-wise. Associative and
    commutative, so fleet aggregation order does not matter."""
    out = {}
    for name in sorted(set(a) | set(b)):
        ea, eb = a.get(name), b.get(name)
        if ea is None or eb is None:
            src = ea or eb
            entry = dict(src)
            entry["series"] = _merge_series(src["kind"], src["series"], [])
            out[name] = entry
            continue
        if ea["kind"] != eb["kind"]:
            raise ValueError(f"metric {name!r}: kind mismatch "
                             f"{ea['kind']} vs {eb['kind']}")
        if ea["kind"] == "histogram" and ea["edges"] != eb["edges"]:
            raise ValueError(f"histogram {name!r}: bucket edges differ "
                             f"across snapshots")
        entry = {"kind": ea["kind"], "help": ea["help"] or eb["help"],
                 "series": _merge_series(ea["kind"], ea["series"],
                                         eb["series"])}
        if ea["kind"] == "histogram":
            entry["edges"] = list(ea["edges"])
        out[name] = entry
    return out


def snapshot_json(snap: dict) -> str:
    """Deterministic JSON encoding (sorted keys) of a snapshot."""
    return json.dumps(snap, sort_keys=True)


# -- module-level default registry ------------------------------------------

_default = Registry()


def get_registry() -> Registry:
    return _default


def counter(name: str, help: str = "") -> Counter:
    return _default.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return _default.gauge(name, help)


def histogram(name: str, help: str = "",
              buckets=LATENCY_BUCKETS_S) -> Histogram:
    return _default.histogram(name, help, buckets=buckets)
