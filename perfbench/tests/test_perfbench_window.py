"""The window's arithmetic: rates over the window, steps of a job cut by
the window's end, the counter read at the window's two edges, and the
roofline reader against hand numbers."""
import time
import types

import pytest

from perfbench import harness
from perfbench.window import EdgeReader, spans_inside


def test_spans_inside_the_window():
    spans = [(0.0, 0.5), (0.8, 1.2), (1.5, 2.5), (3.0, 4.5)]
    # a span counts where it ends inside the window
    assert spans_inside(spans, 1.0, 4.0) == [(0.8, 1.2), (1.5, 2.5)]
    assert spans_inside(spans, 1.0, 4.0, exclude=(1.0, 1.6)) == []
    assert spans_inside(spans, 5.0, 6.0) == []


def test_partial_job_steps_count():
    # a job's steps end at 1, 2, ..., 9; the window closes at 5.5 mid-job
    steps = [(t - 0.9, float(t)) for t in range(1, 10)]
    assert len(spans_inside(steps, 0.0, 5.5)) == 5
    # the profiled stretch (2.5, 4.2) leaves out the steps overlapping it
    kept = spans_inside(steps, 0.0, 5.5, exclude=(2.5, 4.2))
    assert [e for _, e in kept] == [1.0, 2.0]
    rec = types.SimpleNamespace(kind="search", window=(0.0, 5.5),
                                window_s=5.5, stretch=None, step_spans=steps,
                                population=1, flops_per_proposal=2.0e12,
                                peak_ops=1.0e13, proposals=5)
    assert harness.reader("proposals_per_s")(rec) == pytest.approx(5 / 5.5)
    assert harness.reader("search.step_ms")(rec) == pytest.approx(900.0)
    assert harness.reader("search.mfu")(rec) == pytest.approx(
        5 * 2.0e12 / 5.5 / 1.0e13 * 100)


def test_edge_reader_reads_at_the_deadline():
    box = {"n": 0.0}
    t0 = time.monotonic()
    edges = EdgeReader(lambda: box["n"], t0 + 0.2)
    box["n"] = 3.0            # a step that ends inside the window
    time.sleep(0.35)
    box["n"] = 5.0            # the job runs on past the window's end
    assert edges.delta() == 3.0


def _kernels(**counts):
    from perfbench.devtrace import KernelStat
    return [KernelStat(k.replace("__", "::"), n, t) for k, (n, t) in
            counts.items()]


def test_tq_roofline_against_hand_numbers():
    from perfbench.metrics import _yardstick as Y
    # transform_quant: ms per proposal from whole counts, against its bytes
    arch = types.SimpleNamespace(d_model=4, d_ff=8, gated_mlp=False)
    srec = types.SimpleNamespace(
        kind="search", proposals_in_stretch=2,
        trace=types.SimpleNamespace(kernels=_kernels(
            transform_quant_up=(2, 6.0), transform_quant_down=(2, 4.0),
            other=(7, 99.0))),
        tq_bytes_per_proposal=Y.tq_bytes_per_proposal(arch, 2, 4))
    want = Y.tq_bytes_per_proposal(arch, 2, 4) / Y.HBM_BYTES_PER_S * 1e3 \
        / 0.005 * 100
    assert harness.reader("search.tq_roofline")(srec) == pytest.approx(want)
    # a job with no transform_quant launch in its trace reads nothing
    srec.trace.kernels = _kernels(other=(7, 99.0))
    assert harness.reader("search.tq_roofline")(srec) is None


def test_readers_of_a_run_without_a_trace_read_nothing():
    rec = types.SimpleNamespace(kind="search", trace=None, stretch=None,
                                step_spans=None, proposals_in_stretch=0)
    for name in ("search.tq_roofline", "search.device_idle",
                 "search.step_ms", "search.mfu"):
        assert harness.reader(name)(rec) is None
