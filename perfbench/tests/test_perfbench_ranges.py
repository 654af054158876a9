"""Device time, idle gaps and launches charged to the program's ranges
(``perfbench/ranges.py``), on synthetic profiler events; the readers on
records with and without what they read; and a tiny traced run on the CPU
whose sink keeps the job spans."""
import json
import types

import pytest
import torch
from torch.autograd import DeviceType

from perfbench import devtrace, harness, ranges
from perfbench.tiny import tiny_cell

ROOT = harness.ROOT
US = 1e-6


def _ev(name, start, end, *, device=False, annotation=False, id=0,
        linked=0):
    """A profiler event; ``linked`` None for a profiler whose events carry
    no linked id (the runtime call's correlation id links them alone)."""
    ev = types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        is_user_annotation=annotation, id=id)
    if linked is not None:
        ev.linked_correlation_id = linked
    return ev


def _range(name, start, end, id):
    return _ev(name, start, end, annotation=True, id=id)


# host, in us: a step [0, 110] holding an eval [10, 90] (score [10, 60]
# with attention [15, 30], ffn [30, 45] and the head [46, 55] inside it;
# sync [60, 90]) and an accept [92, 108]; a range the program does not
# name [15, 20]. Operators (frontend, linked 0) launch at 16 (attention,
# through its runtime call at 17), 31 (ffn), 50 (head), 95 (accept) and
# 125 (outside every range); a runtime call alone at 47 (head); one
# kernel has no link at all.
EVENTS = [
    _range("search.step", 0, 110, 900), _range("search.eval", 10, 90, 901),
    _range("search.score", 10, 60, 902),
    _range("model.attention", 15, 30, 903), _range("other", 15, 20, 904),
    _range("model.ffn", 30, 45, 905), _range("model.head", 46, 55, 906),
    _range("search.sync", 60, 90, 907), _range("search.accept", 92, 108, 908),
    _ev("aten::mm", 16, 18, id=1), _ev("cudaLaunchKernel", 17, 17.5, id=101,
                                       linked=1),
    _ev("aten::relu", 31, 32, id=2), _ev("aten::mm", 50, 51, id=3),
    _ev("aten::copy_", 95, 96, id=4), _ev("aten::add", 125, 126, id=5),
    # device: [40, 60] attention, [60, 70] ffn, [65, 80] head (overlaps
    # the ffn's by 5), [120, 130] accept, [140, 150] outside, [150, 155]
    # unlinked, [155, 156] head; the GPU side of a range is no work
    _ev("gemm", 40, 60, device=True, id=101, linked=1),
    # linked by its runtime call's id alone, at 47 (under the head)
    _ev("cudaLaunchKernel", 47, 47.5, id=107, linked=None),
    _ev("fill", 155, 156, device=True, id=107, linked=None),
    _ev("relu", 60, 70, device=True, id=102, linked=2),
    _ev("gemm", 65, 80, device=True, id=103, linked=3),
    _ev("copy", 120, 130, device=True, id=104, linked=4),
    _ev("add", 140, 150, device=True, id=105, linked=5),
    _ev("memset", 150, 155, device=True, id=106),
    _ev("model.attention", 40, 60, device=True, annotation=True),
]


@pytest.fixture(scope="module")
def split():
    return ranges.attribute(EVENTS)


def test_nested_ranges_charge_the_innermost(split):
    assert split.device_s == pytest.approx({
        "model.attention": 20 * US, "model.ffn": 10 * US,
        "model.head": 11 * US, "search.accept": 10 * US,
        ranges.OUTSIDE: 15 * US})


def test_operations_by_range(split):
    assert split.kernels["model.attention"] == pytest.approx({"gemm": 20 * US})
    assert split.kernels["model.head"] == pytest.approx({"gemm": 10 * US,
                                                         "fill": 1 * US})
    assert split.kernels[ranges.OUTSIDE] == pytest.approx({"add": 10 * US,
                                                           "memset": 5 * US})


def test_ops_launched_outside_every_range(split):
    assert split.launches[ranges.OUTSIDE] == 2
    assert split.unlinked == 1


def test_gap_midpoints_are_attributed(split):
    # (80, 120): midpoint 100, in the accept; (130, 140): outside
    assert split.idle_s == pytest.approx({"search.accept": 40 * US,
                                          ranges.OUTSIDE: 10 * US})


def test_launches_by_range_and_step(split):
    assert split.launches == {"model.attention": 1, "model.ffn": 1,
                              "model.head": 2, "search.accept": 1,
                              ranges.OUTSIDE: 2}
    assert (split.step_launches, split.steps) == (5, 1)
    assert split.step_s == pytest.approx(110 * US)


def test_device_time_sums_to_busy(split):
    busy = devtrace.summarize(EVENTS, 1.0).busy_s
    assert busy == pytest.approx(66 * US)
    assert sum(split.device_s.values()) == pytest.approx(busy, rel=0.01)


def test_an_overlapping_range_is_cut_at_its_parent():
    evs = [_range("search.step", 0, 50, 1), _range("search.sync", 40, 70, 2),
           _ev("aten::mm", 60, 61, id=3),
           _ev("k", 100, 110, device=True, id=4, linked=3)]
    assert ranges.attribute(evs).device_s == pytest.approx(
        {ranges.OUTSIDE: 10 * US})


def _record(with_new):
    """A traced search record, with the split and the job spans or
    without them."""
    trace = devtrace.summarize(EVENTS, 200 * US)
    steps = [(0.1, 0.35), (0.35, 0.6), (0.82, 0.9)]
    rec = types.SimpleNamespace(
        kind="search", window=(0.0, 1.0), window_s=1.0, setup_s=3.0,
        stretch=(0.6, 0.8), step_spans=steps, trace=trace,
        trace_host=trace, proposals=3, proposals_in_stretch=2,
        population=1, flops_per_proposal=1e12, peak_ops=1e13,
        tq_bytes_per_proposal=1e6)
    if with_new:
        trace.ranges = ranges.attribute(EVENTS)
        rec.spans = {"search.step": steps,
                     "quantize.base": [(0.0, 0.05), (0.8, 0.81)],
                     "search.setup": [(0.05, 0.1), (0.81, 0.82)],
                     "search.finish": [(0.9, 0.92)],
                     "search.sync": [(0.3, 0.31), (0.5, 0.53)]}
    return rec


def test_new_readers_on_a_record_with_the_split():
    rec = _record(True)
    got = {n: read(rec) for n, read in ranges.READERS.items()}
    busy = rec.trace.busy_s
    assert got == pytest.approx({
        # 0.05 + 0.05 + 0.01 + 0.01 + 0.02 s of the 0.8 s unprofiled
        "search.nonstep_pct": 0.14 / 0.8 * 100,
        "search.sync_ms": 20.0,
        "search.attention_pct": 20 * US / busy * 100,
        "search.head_pct": 11 * US / busy * 100,
        "search.launches_per_step": 5.0})
    b = ranges.breakdown(rec)
    assert b["device_by_range"][0] == ["model.attention", pytest.approx(
        20 * US)]
    assert [k for k, _ in b["idle_by_range"]] == ["search.accept",
                                                  ranges.OUTSIDE]


@pytest.mark.parametrize("what", ["no trace", "no split", "no spans"])
def test_new_readers_read_nothing_without_it(what):
    rec = _record(what == "no spans")
    if what == "no trace":
        rec.trace = None
    if what == "no spans":
        del rec.spans
    device = ("search.attention_pct", "search.head_pct",
              "search.launches_per_step")
    for name, read in ranges.READERS.items():
        some = what == "no spans" and name in device
        assert (read(rec) is not None) is some, name
    assert bool(ranges.breakdown(rec)) is (what == "no spans")


EXISTING = [m["name"] for m in json.loads((ROOT / "BENCHMARK.json")
                                          .read_text())["end_to_end"]
            + json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]]


@pytest.mark.parametrize("metric", EXISTING)
def test_existing_readers_ignore_the_new_fields(metric):
    read = harness.reader(metric)
    assert read(_record(True)) == read(_record(False))


def test_a_tiny_traced_run_keeps_the_job_spans():
    """The search driver's run on the CPU with the job spans kept: a
    span each phase of each job in the window, the readers of host spans
    reading them; the result line as ``run.py``'s with the additions."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cell = tiny_cell("search.opt-1.3b", profile_job=0)
        rec = ranges.ranged_run(cell, 11, 1.5, torch.device("cpu"))
    finally:
        torch.set_num_threads(n)
    spans = rec.spans
    jobs = len(rec.jobs)
    assert len(spans["search.setup"]) == len(spans["search.finish"]) == jobs
    assert len(spans["quantize.base"]) == jobs
    assert len(spans["search.sync"]) == len(spans["search.step"]) \
        == jobs * cell.traffic["steps"]
    assert rec.trace is not None and rec.trace.ranges.steps == \
        cell.traffic["steps"]
    line = ranges.line_of(cell, rec, {"platform": "cpu"})
    assert list(line)[-1] == "checks" and line["correct"]
    for name in ("proposals_per_s", "setup_s", "search.step_ms",
                 "search.sync_ms"):
        assert name in line["metrics"], name
