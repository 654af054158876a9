"""Readings that the limits of a cell's check are set from: for each seed,
one run of the cell at its own size and load (a short window), the numbers
the program gives against the plain reference, and the numbers of the
control (the reference in the precision below the configuration's, put in
the program's place), all in one process. With ``--fault`` the program
runs with that fault of ``perfbench.faults`` planted underneath, and its
numbers are the fault's readings.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 10 [--control fp8] [--fault head_altered] [--out cal.jsonl]

Prints one JSON line a seed. Needs a CUDA device. The benchmark's own runs
never run the control or a fault.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from perfbench import harness  # noqa: E402
from perfbench import run as runner  # noqa: E402


def readings(cell, seed: int, seconds: float, control, device, fault=None):
    """One run's program numbers (with ``fault`` planted, if given), the
    control's (with ``control``, a lower precision), and its end-to-end
    metrics."""
    from perfbench.faults import plant

    ctx = runner.make_context(cell, seed, seconds, False, device,
                              time.monotonic())
    drv = harness.driver(cell.traffic["driver"])
    ctx.check = functools.partial(drv.check, ctx, control=control)
    planted = plant(fault, int(cell.traffic["n_match_layers"])) if fault \
        else contextlib.nullcontext()
    with planted:
        rec = drv.run(ctx)
    program_ok, _ = harness.judge(rec.numbers, cell.limits)
    out = {"seed": seed, "fault": fault, "program": rec.numbers,
           "program_correct": program_ok, "run": rec.about,
           "metrics": runner.metrics_of(rec, cell.end_to_end)}
    if control:
        out["control"] = ctx.control
        out["control_correct"] = harness.judge(ctx.control, cell.limits)[0]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    harness.cache_env(ROOT)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload, ROOT)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        line = json.dumps(readings(cell, seed, args.seconds, args.control,
                                   device, args.fault))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
