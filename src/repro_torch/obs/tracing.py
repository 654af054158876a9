"""Span tracing: monotonic-duration spans to an optional JSONL sink.

The port's copy of the reference's ``repro.obs.tracing`` for what serving
reads. ``trace_span(name, hist=..., **attrs)`` times its body on the
MONOTONIC clock, observes the duration into ``hist`` (an ``obs.Histogram``)
on exit, and, when a sink is set (``set_trace_sink``), writes a begin and
an end event (``{"ph": "B"/"E", "name", "ts", ...}``). Event ``ts`` values
are wall-valued but monotonically derived from one (wall, monotonic) anchor
per process, written once per sink as a ``clock_anchor`` metadata event, so
``E.ts - B.ts`` is exactly ``dur_s``. ``profile=True`` (or
``enable_profiler()``) also wraps the body in
``torch.profiler.record_function``, so spans line up against device
activity in a ``torch.profiler`` trace — the counterpart of the reference's
``jax.profiler`` annotation. ``profile_range(name)`` marks a region inside a
span for such a trace only (no sink event, no histogram) and is a no-op
unless ``enable_profiler()`` is on. ``emit(name, **fields)`` writes an
instant event to the sink and prints the same ``[name] k=v ...`` line as
the reference's.
"""
from __future__ import annotations

import contextlib
import json
import pathlib
import threading
import time
from typing import IO, Optional, Union

__all__ = ["trace_span", "set_trace_sink", "enable_profiler",
           "profile_range", "emit"]

_lock = threading.Lock()
_sink: Optional[IO] = None
_sink_owned = False        # opened by us (close on replace) vs caller-owned
_profile_default = False

_EPOCH_WALL = time.time()
_EPOCH_MONO = time.monotonic()


def _now_ts() -> float:
    """Wall-valued, monotonically-derived timestamp."""
    return _EPOCH_WALL + (time.monotonic() - _EPOCH_MONO)


def enable_profiler(on: bool = True) -> None:
    """Process default for the ``torch.profiler.record_function`` wrap."""
    global _profile_default
    _profile_default = bool(on)


def profile_range(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` when
    ``enable_profiler()`` is on, else a no-op context."""
    if not _profile_default:
        return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function(name)


def set_trace_sink(sink: Union[str, IO, None]) -> None:
    """Point span output at a JSONL file. A string opens (appends) the path;
    a file-like object is used as-is; ``None`` disables tracing."""
    global _sink, _sink_owned
    if isinstance(sink, str):
        p = pathlib.Path(sink)
        p.parent.mkdir(parents=True, exist_ok=True)
        new, owned = p.open("a"), True
    else:
        new, owned = sink, False
    with _lock:
        if _sink is not None and _sink_owned:
            _sink.close()
        _sink, _sink_owned = new, owned
    if new is not None:
        _write({"ph": "M", "name": "clock_anchor", "wall": _EPOCH_WALL,
                "mono": _EPOCH_MONO})


def _write(event: dict) -> None:
    sink = _sink
    if sink is None:
        return
    line = json.dumps(event) + "\n"
    with _lock:
        sink.write(line)
        sink.flush()


class trace_span:
    """Context manager; after exit ``.dur`` holds the monotonic duration in
    seconds. ``elapsed()`` reads the running duration while still open."""

    __slots__ = ("name", "attrs", "hist", "hist_labels", "profile", "t_wall",
                 "_t0", "dur", "_record")

    def __init__(self, name: str, hist=None, hist_labels: Optional[dict] = None,
                 profile: Optional[bool] = None, **attrs):
        self.name = name
        self.attrs = attrs
        self.hist = hist
        self.hist_labels = hist_labels or {}
        self.profile = _profile_default if profile is None else profile
        self.dur: Optional[float] = None
        self._record = None

    def elapsed(self) -> float:
        return time.monotonic() - self._t0

    def __enter__(self):
        if self.profile:
            import torch
            self._record = torch.profiler.record_function(self.name)
            self._record.__enter__()
        self.t_wall = _now_ts()
        self._t0 = time.monotonic()
        if _sink is not None:
            _write({"ph": "B", "name": self.name, "ts": self.t_wall,
                    **({"attrs": self.attrs} if self.attrs else {})})
        return self

    def __exit__(self, exc_type, exc, tb):
        self.dur = time.monotonic() - self._t0
        if self._record is not None:
            self._record.__exit__(exc_type, exc, tb)
            self._record = None
        if self.hist is not None:
            self.hist.observe(self.dur, **self.hist_labels)
        if _sink is not None:
            _write({"ph": "E", "name": self.name,
                    "ts": self.t_wall + self.dur, "dur_s": self.dur,
                    **({"error": repr(exc)} if exc is not None else {})})
        return False


def emit(name: str, _print: bool = True, **fields) -> str:
    """Structured instant event + compact human line. Returns the line."""
    if _sink is not None:
        _write({"ph": "i", "name": name, "ts": _now_ts(), **fields})
    line = f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items())
    if _print:
        print(line, flush=True)
    return line
