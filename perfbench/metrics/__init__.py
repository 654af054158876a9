"""One reader per metric, found by the metric's name; ``_``-named files are shared helpers."""
