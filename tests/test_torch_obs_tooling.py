"""Port parity: the rest of ``obs`` — ``Registry.render_prometheus`` and the
scoped trace sink (``trace_to``, ``get_trace_sink``) — against the JAX
reference's ``repro.obs``.

Bars: the Prometheus text equal character for character after the same
metric calls; a ``trace_to`` block's events in the reference's order and
shape, with the previous sink back in place after it (also after an
exception, and when nested).
"""
import io
import json

import pytest

from repro import obs as jobs
from repro_torch import obs as tobs


def _drive(obs):
    r = obs.Registry()
    r.counter("c_total", "requests served").inc(2)
    r.counter("c_total").inc(1.5, route="paged", tenant="a")
    r.counter("c_total").inc(1, route="flash", tenant="b")
    r.gauge("g_bytes", "bytes live").set(3.0)
    r.gauge("g_bytes").set(-1.25, rank="1")
    h = r.histogram("h_seconds", "step time")
    for v in (0.05, 0.5, 50.0, 1e-5, 200.0):
        h.observe(v)
    h.observe(0.3, route="paged")
    r.histogram("small", buckets=(1.0, 2.0)).observe(1.5)
    r.counter("empty_total")          # registered, never written
    return r


def test_render_prometheus_equals_reference():
    got, want = _drive(tobs).render_prometheus(), \
        _drive(jobs).render_prometheus()
    assert got == want
    assert 'h_seconds_bucket{le="+Inf"} 5' in got
    assert 'c_total{route="paged",tenant="a"} 1.5' in got
    r = tobs.Registry()
    assert r.render_prometheus() == jobs.Registry().render_prometheus() == "\n"


def test_render_prometheus_after_reset_equals_reference():
    t, j = _drive(tobs), _drive(jobs)
    t.reset()
    j.reset()
    assert t.render_prometheus() == j.render_prometheus()


def _events(buf):
    return [json.loads(line) for line in buf.getvalue().splitlines()]


def test_trace_to_restores_the_previous_sink():
    outer, inner = io.StringIO(), io.StringIO()
    assert tobs.get_trace_sink() is None
    with tobs.trace_to(outer):
        assert tobs.get_trace_sink() is outer
        with tobs.trace_to(inner):
            assert tobs.get_trace_sink() is inner
            with tobs.trace_span("unit", k=1):
                pass
            tobs.emit("ev", _print=False, a=2)
        assert tobs.get_trace_sink() is outer
        with pytest.raises(RuntimeError):
            with tobs.trace_to(io.StringIO()):
                raise RuntimeError("x")
        assert tobs.get_trace_sink() is outer
    assert tobs.get_trace_sink() is None
    ev = _events(inner)
    assert [e["ph"] for e in ev] == ["M", "B", "E", "i"]
    assert ev[0]["name"] == "clock_anchor" and ev[1]["attrs"] == {"k": 1}
    assert [e["ph"] for e in _events(outer)] == ["M"]
    # the reference's sink emits the same event sequence
    ref = io.StringIO()
    with jobs.trace_to(ref):
        with jobs.trace_span("unit", k=1):
            pass
        jobs.emit("ev", _print=False, a=2)
    assert [(e["ph"], e["name"]) for e in _events(ref)] == \
        [(e["ph"], e["name"]) for e in ev]
    assert [sorted(e) for e in _events(ref)] == [sorted(e) for e in ev]


def test_trace_to_a_path_closes_its_own_file(tmp_path):
    path = tmp_path / "sub" / "trace.jsonl"
    with tobs.trace_to(str(path)) as scope:
        with tobs.trace_span("unit"):
            pass
        f = tobs.get_trace_sink()
    assert f.closed and tobs.get_trace_sink() is None
    assert scope is not None
    assert [e["ph"] for e in _events(io.StringIO(path.read_text()))] == \
        ["M", "B", "E"]
