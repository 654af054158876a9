"""``chip_smoke.py``'s reading of a profiler trace (``trace_ms``), which the
CPU reaches: device time is taken only from a complete trace, one in which
every named kernel was counted a whole multiple of the calls. On the H100,
after long traces, the profiler drops some kernels' events and would
otherwise read low."""
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


trace_ms = _chip_smoke().trace_ms
SPLIT = "void split_decode::split_kernel<float, false, 1, true>"
MERGE = "split_decode::merge_kernel(split_decode::Args)"
NAMES = ("split_decode::split_kernel", "split_decode::merge_kernel")


def _ev(key, count, us):
    return SimpleNamespace(key=key, count=count, self_device_time_total=us)


@pytest.mark.parametrize("events,want", [
    ([_ev(SPLIT, 20, 300.0), _ev(MERGE, 20, 50.0)], 350.0 / 20 / 1e3),
    ([_ev(SPLIT, 120, 600.0)], 600.0 / 20 / 1e3),          # 6 launches a call
    ([_ev(SPLIT, 20, 300.0), _ev("cudaLaunchKernel", 7, 0.0)], 300.0 / 20 / 1e3),
], ids=["split+merge", "six-a-call", "zero-time-entry"])
def test_a_complete_trace_gives_the_time_per_call(events, want):
    ms, counts, others = trace_ms(events, NAMES, 20)
    assert ms == pytest.approx(want) and others == []
    assert all(n % 20 == 0 for n in counts.values())


@pytest.mark.parametrize("events", [
    [_ev(SPLIT, 16, 1670.0)],                                # dropped events
    [_ev(SPLIT, 20, 300.0), _ev(MERGE, 19, 48.0)],           # one kernel short
    [_ev(SPLIT, 118, 590.0)],                                # 6 a call, 2 lost
    [],                                                      # empty trace
], ids=["dropped", "one-short", "six-a-call-short", "empty"])
def test_an_incomplete_trace_gives_no_time(events):
    ms, counts, _ = trace_ms(events, NAMES, 20)
    assert ms is None
    assert counts == {e.key: e.count for e in events}


def test_other_kernels_are_named_not_timed():
    """A trace with device work under other names only: no time, and the
    names are returned so that the caller can fail on wrong fragments."""
    ms, counts, others = trace_ms([_ev("ampere_sgemm_32x32", 20, 90.0)],
                                  NAMES, 20)
    assert ms is None and counts == {} and others == ["ampere_sgemm_32x32"]
