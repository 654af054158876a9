"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Finds the cell in ``BENCHMARK.json`` and, by their names, its
configuration (``perfbench/configs/``), its traffic mix
(``perfbench/traffic/``), the driver the mix names (``perfbench/drivers/``),
the limits of its check (``perfbench/checks/<cell>.json``) and a reader for
each of its metrics (``perfbench/metrics/<metric>.py``). Sets up, warms up,
measures for ``--seconds``, checks the outputs against the plain reference,
and prints one JSON line last on standard output: the end-to-end metrics
with ``--trace 0``, the per-layer metrics with ``--trace 1``. The compared
numbers and their limits end standard error and the result line. A run
whose set-up built the program's kernels (the first in a checkout) says
so under ``run.setup_built_kernels``: its ``setup_s`` holds the build.

Needs a CUDA device (and as many as the cell asks for); exits non-zero
without a result when there is none, or when JAX or the JAX package was
loaded.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench import harness  # noqa: E402


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def make_context(cell, seed, seconds, trace, device, t_start):
    ctx = types.SimpleNamespace(cell=cell, seed=int(seed),
                                seconds=float(seconds), trace=bool(trace),
                                device=device, t_start=t_start)
    ctx.check = functools.partial(
        harness.driver(cell.traffic["driver"]).check, ctx)
    return ctx


def metrics_of(rec, entries):
    out = {}
    for m in entries:
        value = harness.reader(m["name"])(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result(cell, rec, trace: bool, device_info: dict):
    """The result line's object, the checks' key last."""
    correct, checks = harness.judge(rec.numbers, cell.limits)
    entries = cell.per_layer if trace else cell.end_to_end
    line = {"correct": correct, "attempted": rec.attempted,
            "failed": rec.failed, "metrics": metrics_of(rec, entries),
            "device": dict(device_info)}
    if trace and rec.trace is not None:
        line["device"]["busy_s"] = rec.trace.busy_s
        line["device"]["window_s"] = rec.trace.window_s
        line["breakdown"] = {"device_ops": [list(x) for x in
                                            rec.trace.top_ops(10)],
                             "idle_gaps": [list(x) for x in
                                           rec.trace_host.idle_gaps[:10]]}
    line["run"] = dict(rec.about, numbers=rec.numbers)
    line["checks"] = checks
    return line


def built_kernels(root: Path = ROOT) -> set:
    """The program's built kernel libraries in the checkout."""
    return set((root / "build" / "kernels").glob("*.so"))


def main(argv=None) -> int:
    args = parse(argv)
    kernels_before = built_kernels()
    harness.cache_env(ROOT)
    harness.few_threads()
    cell = harness.load_cell(args.workload, ROOT)
    import torch
    torch.set_num_threads(1)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"cuda available: {torch.cuda.is_available()}",
              file=sys.stderr)
        return 2
    src = ROOT / "src"
    if str(src) not in sys.path:
        sys.path.insert(0, str(src))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    ctx = make_context(cell, args.seed, args.seconds, args.trace, device,
                       T_START)
    rec = harness.driver(cell.traffic["driver"]).run(ctx)
    rec.about["setup_built_kernels"] = len(built_kernels() - kernels_before)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(rec.memory_peak),
            "power_limit_w": harness.power_limit_w()}
    line = result(cell, rec, bool(args.trace), info)
    found = harness.loaded_forbidden()
    if found:
        print(f"perfbench: forbidden modules were loaded: {found}",
              file=sys.stderr)
        return 3
    print(f"perfbench: {json.dumps(line['run'])}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
