"""An in-memory sink for the program's span events (``obs.set_trace_sink``
takes any object with ``write`` and ``flush``): it keeps each finished
span of the names asked for as (start, end) on the monotonic clock, and
writes nothing to disk.

The program stamps events with wall-valued times derived from one
(wall, monotonic) anchor, which it writes first as a ``clock_anchor``
event; that anchor turns them back into monotonic times here.
"""
from __future__ import annotations

import json


class SpanSink:
    def __init__(self, names):
        self.spans = {n: [] for n in names}
        self._offset = None          # wall - monotonic, from the anchor

    def write(self, line: str) -> None:
        for text in line.splitlines():
            if not text.strip():
                continue
            ev = json.loads(text)
            if ev.get("name") == "clock_anchor":
                self._offset = ev["wall"] - ev["mono"]
            elif ev.get("ph") == "E" and ev["name"] in self.spans:
                end = ev["ts"] - self._offset
                self.spans[ev["name"]].append((end - ev["dur_s"], end))

    def flush(self) -> None:
        pass
