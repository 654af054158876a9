"""A bounded stretch of a run under ``torch.profiler``, read into the few
numbers the per-layer readers take: the device's busy time (the union of
every kernel's and copy's interval), each kernel's device time and count,
the longest idle gaps with what the host was doing in each, and the stretch's length
on the host clock.

Only ``key_averages``-sized summaries are kept: no chrome trace is
written, so a traced run writes nothing to disk.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class KernelStat:
    """One device operation's totals (the fields ``trace_ms`` reads)."""

    key: str
    count: int = 0
    self_device_time_total: float = 0.0     # us


@dataclasses.dataclass
class TraceSummary:
    window_s: float                          # host clock, stretch start to end
    busy_s: float                            # union of device intervals
    kernels: List[KernelStat]
    idle_gaps: List[Tuple[str, float]]       # longest gaps: (host op, s)
    n_device_events: int

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        ranked = sorted(self.kernels, key=lambda k: -k.self_device_time_total)
        return [(short(k.key), k.self_device_time_total / 1e6)
                for k in ranked[:n]]


def short(name: str, width: int = 120) -> str:
    """A kernel's name cut to ``width`` characters for the result line."""
    return name if len(name) <= width else name[: width - 3] + "..."


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarize(events, window_s: float) -> TraceSummary:
    """``events``: a profiler's ``events()`` (FunctionEvents, times in us).
    Device events are those whose ``device_type`` is CUDA; the program's
    ``record_function`` ranges appear there too as user annotations, and
    do not count as work."""
    from torch.autograd import DeviceType

    dev, host = [], []
    for e in events:
        s, t = float(e.time_range.start), float(e.time_range.end)
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                dev.append((e.name, s, t))
        elif t > s:
            host.append((e.name, s, t))
    merged = _merge([(s, t) for _, s, t in dev])
    busy_us = sum(t - s for s, t in merged)
    stats: Dict[str, KernelStat] = {}
    for name, s, t in dev:
        k = stats.setdefault(name, KernelStat(name))
        k.count += 1
        k.self_device_time_total += t - s
    gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1],
                    merged[i + 1][0]) for i in range(len(merged) - 1)),
                  reverse=True)[:10]
    named = []
    for g, s, t in gaps:
        mid = (s + t) / 2
        inner = [(he - hs, n) for n, hs, he in host if hs <= mid <= he]
        named.append((short(min(inner)[1]) if inner else "(no host op)",
                      g / 1e6))
    return TraceSummary(window_s=window_s, busy_s=busy_us / 1e6,
                        kernels=list(stats.values()), idle_gaps=named,
                        n_device_events=len(dev))


def _activities():
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


def warm_profiler() -> None:
    """Start and stop the profiler once, so that its first start (which
    loads and sets up the device tracer, seconds on some hosts) falls in
    the set-up and not in the window."""
    from torch.profiler import profile

    with profile(activities=_activities()):
        pass


class Stretch:
    """``with Stretch() as st: ...`` profiles its body (CPU and CUDA
    activity) with the program's profiler ranges switched on
    (``obs.enable_profiler``), and leaves ``st.summary`` after it.
    ``(st.t0, st.t1)`` is the stretch on the monotonic clock, the
    profiler's own start and stop included."""

    def __init__(self):
        self._summary: Optional[TraceSummary] = None
        self.t0 = self.t1 = None

    def __enter__(self):
        import torch
        from torch.profiler import profile

        from repro_torch import obs

        self.t0 = time.monotonic()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._obs = obs
        obs.enable_profiler(True)
        self._prof = profile(activities=_activities())
        self._prof.__enter__()
        self._inner0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._inner = time.monotonic() - self._inner0
        self._prof.__exit__(*exc)
        self._obs.enable_profiler(False)
        self.t1 = time.monotonic()
        return False

    @property
    def summary(self) -> TraceSummary:
        """The trace's summary, read on first use: after the window, so
        that reading the profiler's events costs the window nothing."""
        if self._summary is None:
            self._summary = summarize(self._prof.events(), self._inner)
            self._prof = None
        return self._summary
