"""The profiled job's device time, idle time and launches, charged to the
program's own ranges, and the host spans of a search job's phases.

The program names each phase of a job and each sublayer of the scoring
forward (``repro_torch.obs``: ``trace_span`` and ``profile_range``, which
are ``torch.profiler`` ranges while ``obs.enable_profiler()`` is on, as in
``devtrace.Stretch``). ``attribute(events)`` reads a profiler's events:

- device time: each device operation's share of the busy time (the union
  of their intervals; where two overlap, the one that started first holds
  the overlap) goes to the innermost range of ``RANGES`` that held the
  host when it launched the operation. The profiler links the two by
  correlation id: the runtime call that launched it (``cudaLaunchKernel``
  and the like), else the operator that made that call. An operation with
  neither, or launched outside every range, goes to ``OUTSIDE``;
- idle time: each gap between the merged device intervals goes to the
  innermost range the host was in at the gap's midpoint;
- launches: device operations by range, those launched inside a
  ``search.step`` range (at any depth), and the number of such steps.

The readers (``READERS``, one a metric) take a run's record: its trace
summary with a ``ranges`` field holding ``attribute``'s result, and
``spans``, the window's host spans by name (``JOB_SPANS`` and
``search.step``). Each returns None where the record has neither, as a
record of the benchmark's own runs has today (``PERF.md``, section 7,
names the edits that would give it both).

    python3 perfbench/ranges.py --workload <cell> --seed <n> --seconds <s> [--no-profile]

runs a cell as ``run.py --trace 1`` does, with the profiled job's events
and the window's job spans kept for these readers, and prints the line
``run.py`` would, with the five metrics, ``breakdown.device_by_range`` and
``breakdown.idle_by_range`` (seconds, largest first) and ``ranges`` (the
launches by range, the profiled job's mean ``search.step``) added. With
``--no-profile`` no job is profiled and the line gives the end-to-end
metrics of a run whose spans all go to the in-memory sink: what the sink
costs when it is on. Needs a CUDA device.
"""
from __future__ import annotations

import bisect
import dataclasses
import sys
from pathlib import Path
from typing import Dict, Optional

ROOT = Path(__file__).resolve().parents[1]

# the program's ranges, as it names them; an enclosing range is charged
# only for what no range inside it holds
RANGES = ("quantize.base", "search.setup", "search.run", "search.step",
          "search.eval", "search.build", "search.score", "search.sync",
          "search.accept", "search.finish", "model.dequant",
          "model.attention", "model.ffn", "model.head", "objective.evaluate")
OUTSIDE = "(outside)"
# host spans kept beside search.step for the readers
JOB_SPANS = ("quantize.base", "search.setup", "search.finish", "search.sync")
NONSTEP = ("quantize.base", "search.setup", "search.finish")


@dataclasses.dataclass
class RangeSplit:
    device_s: Dict[str, float]   # share of busy time, by range
    idle_s: Dict[str, float]     # gaps between device intervals, by range
    launches: Dict[str, int]     # device operations, by range
    step_launches: int           # launched inside a search.step range
    steps: int                   # search.step ranges
    step_s: Optional[float]      # their mean length on the host
    unlinked: int                # device operations with no launch found
    kernels: Dict[str, Dict[str, float]]   # range -> operation name -> s


def _times(e):
    return float(e.time_range.start), float(e.time_range.end)


class _Innermost:
    """The innermost range open at a time: the ranges flattened into
    breakpoints, each starting a stretch held by one range (or none). A
    range that outlives the one around it is cut at that one's end."""

    def __init__(self, ranges):
        self.t, self.name = [], []
        stack = []

        def close_until(t):
            while stack and stack[-1][0] <= t:
                end = stack.pop()[0]
                self.t.append(end)
                self.name.append(stack[-1][1] if stack else OUTSIDE)

        for s, e, n in sorted(ranges, key=lambda r: (r[0], -r[1])):
            close_until(s)
            if stack:
                e = min(e, stack[-1][0])
            stack.append((e, n))
            self.t.append(s)
            self.name.append(n)
        close_until(float("inf"))

    def at(self, t) -> str:
        if t is None:
            return OUTSIDE
        i = bisect.bisect_right(self.t, t) - 1
        return self.name[i] if i >= 0 else OUTSIDE


def _launch_times(events, cuda):
    """A function from a device operation to the host time of its launch:
    the start of its runtime call (a CPU event of the CUDA runtime or
    driver, ``cu...``, whose id, the profiler's correlation id, is the
    operation's), else that of the operator that made the call (the CPU
    event whose id is the operation's linked id, where the profiler's
    events carry one), else None."""
    runtime, ops = {}, {}
    for e in events:
        if e.device_type == cuda:
            continue
        if e.name.startswith("cu"):
            runtime[e.id] = _times(e)[0]
        elif not getattr(e, "linked_correlation_id", 0):
            ops.setdefault(e.id, _times(e)[0])

    def launch(d):
        t = runtime.get(d.id)
        linked = getattr(d, "linked_correlation_id", 0)
        return t if t is not None else ops.get(linked) if linked else None
    return launch


def attribute(events, ranges=RANGES) -> RangeSplit:
    """``events``: a profiler's ``events()`` (FunctionEvents, times in us).
    Seconds and counts by the innermost of ``ranges``."""
    from torch.autograd import DeviceType

    cuda = DeviceType.CUDA
    host = [(*_times(e), e.name) for e in events
            if e.device_type != cuda and e.name in ranges]
    inner = _Innermost(host)
    steps = sorted((s, t) for s, t, n in host if n == "search.step")
    step_starts = [s for s, _ in steps]
    launch = _launch_times(events, cuda)
    # device operations; a range's GPU-side annotation is no work
    device = sorted((*_times(e), launch(e), e.name) for e in events
                    if e.device_type == cuda
                    and not getattr(e, "is_user_annotation", False))
    device_us: Dict[str, float] = {}
    kernel_us: Dict[str, Dict[str, float]] = {}
    launches: Dict[str, int] = {}
    idle_us: Dict[str, float] = {}
    covered, step_launches = float("-inf"), 0
    for s, t, at, op in device:
        name = inner.at(at)
        share = max(0.0, t - max(s, covered))
        if s > covered and covered > float("-inf"):
            mid = (covered + s) / 2
            gap = inner.at(mid)
            idle_us[gap] = idle_us.get(gap, 0.0) + (s - covered)
        covered = max(covered, t)
        device_us[name] = device_us.get(name, 0.0) + share
        ops = kernel_us.setdefault(name, {})
        ops[op] = ops.get(op, 0.0) + share
        launches[name] = launches.get(name, 0) + 1
        i = -1 if at is None else bisect.bisect_right(step_starts, at) - 1
        if i >= 0 and at <= steps[i][1]:
            step_launches += 1
    return RangeSplit(
        device_s={k: v / 1e6 for k, v in device_us.items()},
        idle_s={k: v / 1e6 for k, v in idle_us.items()},
        launches=launches, step_launches=step_launches,
        steps=len(steps), unlinked=sum(d[2] is None for d in device),
        kernels={r: {k: v / 1e6 for k, v in ops.items()}
                 for r, ops in kernel_us.items()},
        step_s=(sum(t - s for s, t in steps) / len(steps) / 1e6
                if steps else None))


# --- the readers: a metric each, None where the record has nothing ---

def _split(rec):
    trace = getattr(rec, "trace", None)
    split = getattr(trace, "ranges", None)
    if split is None or not trace.busy_s > 0:
        return None
    return split


def _device_pct(rec, names):
    split = _split(rec)
    if split is None or not any(n in split.device_s for n in names):
        return None
    return sum(split.device_s.get(n, 0.0) for n in names) \
        / rec.trace.busy_s * 100


def nonstep_pct(rec):
    """``quantize.base`` + ``search.setup`` + ``search.finish`` spans that
    end in the window outside the profiled stretch, over those seconds,
    in %."""
    from perfbench.metrics._window import unprofiled_s
    from perfbench.window import spans_inside

    spans = getattr(rec, "spans", None)
    if spans is None:
        return None
    inside = [x for n in NONSTEP for x in spans_inside(
        spans.get(n, ()), *rec.window, exclude=rec.stretch)]
    if not inside:
        return None
    return sum(e - s for s, e in inside) / unprofiled_s(rec) * 100


def sync_ms(rec):
    """The mean ``search.sync`` span (the host's wait for a step's losses)
    in the window outside the profiled stretch, in ms."""
    from perfbench.metrics._window import mean_ms

    spans = getattr(rec, "spans", None)
    return None if spans is None else mean_ms(rec, spans.get("search.sync"))


def attention_pct(rec):
    """``model.attention``'s share of the profiled job's busy time, in %."""
    return _device_pct(rec, ("model.attention",))


def head_pct(rec):
    """``model.head`` and ``objective.evaluate``'s share of the profiled
    job's busy time, in %."""
    return _device_pct(rec, ("model.head", "objective.evaluate"))


def launches_per_step(rec):
    """Device operations launched inside ``search.step`` ranges, per step of
    the profiled job."""
    split = _split(rec)
    if split is None or not split.steps:
        return None
    return split.step_launches / split.steps


READERS = {"search.nonstep_pct": nonstep_pct, "search.sync_ms": sync_ms,
           "search.attention_pct": attention_pct,
           "search.head_pct": head_pct,
           "search.launches_per_step": launches_per_step}


def breakdown(rec) -> dict:
    """``device_by_range`` and ``idle_by_range``: (range, seconds), largest
    first; empty where the record has no split."""
    split = _split(rec)
    if split is None:
        return {}

    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])]
    return {"device_by_range": ranked(split.device_s),
            "idle_by_range": ranked(split.idle_s)}


# --- the command line ---

def ranged_run(cell, seed: int, seconds: float, device, profile=True):
    """One run of ``cell`` as ``run.py --trace 1`` makes it, the search
    driver's profiled stretch keeping its split by range and its sink the
    job spans: the record, with ``spans`` set. ``profile=False`` profiles
    no job."""
    import time

    from perfbench import devtrace, harness
    from perfbench import run as runner
    from perfbench.spans import SpanSink

    class RangedStretch(devtrace.Stretch):
        @property
        def summary(self):
            if self._summary is None:
                events = self._prof.events()
                self._summary = devtrace.summarize(events, self._inner)
                self._summary.ranges = attribute(events)
                self._prof = None
            return self._summary

    sinks = []

    def sink(names):
        sinks.append(SpanSink(tuple(names) + JOB_SPANS))
        return sinks[-1]

    if not profile:
        cell = dataclasses.replace(cell, traffic=dict(cell.traffic,
                                                      profile_job=-1))
    drv = harness.driver(cell.traffic["driver"])
    ctx = runner.make_context(cell, seed, seconds, True, device,
                              time.monotonic())
    kept = drv.Stretch, drv.SpanSink
    drv.Stretch, drv.SpanSink = RangedStretch, sink
    try:
        rec = drv.run(ctx)
    finally:
        drv.Stretch, drv.SpanSink = kept
    rec.spans = sinks[-1].spans if sinks else None
    return rec


def line_of(cell, rec, info: dict) -> dict:
    """``run.py``'s traced line for ``rec``, with the end-to-end metrics,
    the five readers, the split, and by range the launches and the three
    operations of most device time."""
    from perfbench import run as runner
    from perfbench.devtrace import short

    line = runner.result(cell, rec, True, info)
    line["metrics"].update(runner.metrics_of(rec, cell.end_to_end))
    for name, read in READERS.items():
        value = read(rec)
        if value is not None:
            line["metrics"][name] = {"value": float(value)}
    line.setdefault("breakdown", {}).update(breakdown(rec))
    split = _split(rec)
    if split is not None:
        top = {r: [[short(k), v] for k, v in sorted(
            ops.items(), key=lambda kv: -kv[1])[:3]]
            for r, ops in split.kernels.items()}
        line["ranges"] = {"launches": split.launches,
                          "unlinked": split.unlinked, "steps": split.steps,
                          "step_ms": (None if split.step_s is None
                                      else split.step_s * 1e3),
                          "top_ops": top}
    line["checks"] = line.pop("checks")
    return line


def main(argv=None) -> int:
    import argparse
    import json

    for p in (ROOT, ROOT / "src"):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    from perfbench import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--no-profile", action="store_true")
    args = ap.parse_args(argv)
    harness.cache_env(ROOT)
    harness.few_threads()
    import torch
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("ranges: needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, ROOT)
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    rec = ranged_run(cell, args.seed, args.seconds, device,
                     profile=not args.no_profile)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(rec.memory_peak),
            "power_limit_w": harness.power_limit_w()}
    print(json.dumps(line_of(cell, rec, info)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
