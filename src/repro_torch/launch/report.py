"""The dry run's tables from its cell records (the reference's
``repro.launch.report``).

    PYTHONPATH=src python -m repro_torch.launch.report [--section ...] [--dir build/dryrun]

Reads the records ``launch.dryrun`` writes under ``build/dryrun`` (the
working directory's). A term a record does not give (the collective term,
the per-device peak) prints as ``n/a``.
"""
from __future__ import annotations

import argparse
import json
import pathlib

ART = pathlib.Path("build") / "dryrun"

ARCH_ORDER = ["zamba2-7b", "internlm2-1.8b", "qwen3-4b", "command-r-35b",
              "yi-6b", "mamba2-2.7b", "internvl2-1b", "seamless-m4t-medium",
              "phi3.5-moe-42b-a6.6b", "moonshot-v1-16b-a3b"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load_cells(include_opts: bool = False, art=ART):
    cells = {}
    for p in pathlib.Path(art).glob("*.json"):
        if "__opt-" in p.name and not include_opts:
            continue  # §Perf variants live beside the baselines
        r = json.loads(p.read_text())
        cells[(r["arch"], r["shape"], r["mesh"])] = r
    return cells


def fmt_bytes(n):
    if n is None:
        return "-"
    return f"{n / 2**30:.2f}"


def _sci(x, spec):
    return "n/a" if x is None else format(x, spec)


def dryrun_table(cells):
    lines = [
        "| arch | shape | 16x16 | 2x16x16 | per-dev peak GiB | args GiB "
        "| collective schedule (per-device bytes, scan body x1) |",
        "|---|---|---|---|---|---|---|",
    ]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            c1 = cells.get((a, s, "16x16"))
            c2 = cells.get((a, s, "2x16x16"))
            if c1 is None and c2 is None:
                continue
            if c1 and c1.get("skipped"):
                lines.append(f"| {a} | {s} | SKIP (full-attention; DESIGN.md) | SKIP | - | - | - |")
                continue
            ok1 = "PASS" if (c1 and c1.get("ok")) else "FAIL"
            ok2 = "PASS" if (c2 and c2.get("ok")) else "FAIL"
            mem = c1.get("memory") if c1 else None
            coll = c1.get("coll_schedule", {}) if c1 else {}
            coll_s = ", ".join(f"{k}:{v/2**20:.1f}MiB" for k, v in sorted(coll.items())) or "none"
            peak = mem.get("peak_bytes") if mem else None
            lines.append(
                f"| {a} | {s} | {ok1} | {ok2} | "
                f"{'n/a' if mem and peak is None else fmt_bytes(peak)} | "
                f"{fmt_bytes(mem['argument_bytes']) if mem else '-'} | {coll_s} |")
    return "\n".join(lines)


def roofline_table(cells):
    lines = [
        "| arch | shape | compute_s | memory_s | collective_s | dominant "
        "| MODEL_FLOPs | useful ratio | roofline frac (mfu_bound) |",
        "|---|---|---|---|---|---|---|---|---|",
    ]
    for a in ARCH_ORDER:
        for s in SHAPE_ORDER:
            c = cells.get((a, s, "16x16"))
            if c is None:
                continue
            if c.get("skipped"):
                lines.append(f"| {a} | {s} | - | - | - | skipped | - | - | - |")
                continue
            t = c.get("roofline")
            if not t:
                status = 'FAILED' if not c['ok'] else 'no-delta'
                lines.append(f"| {a} | {s} | ? | ? | ? | {status} | - | - | - |")
                continue
            lines.append(
                f"| {a} | {s} | {_sci(t['compute_s'], '.3e')} | "
                f"{_sci(t['memory_s'], '.3e')} | "
                f"{_sci(t['collective_s'], '.3e')} | "
                f"**{t['dominant'][:-2]}** | "
                f"{t['model_flops_global']:.2e} | {t['useful_ratio']:.3f} | "
                f"{t['mfu_bound']:.4f} |")
    return "\n".join(lines)


def summary(cells):
    n_ok = sum(1 for c in cells.values() if c.get("ok") and not c.get("skipped"))
    n_skip = sum(1 for c in cells.values() if c.get("skipped"))
    n_fail = sum(1 for c in cells.values() if not c.get("ok"))
    return f"{len(cells)} cells: {n_ok} compiled PASS, {n_skip} skipped-by-design, {n_fail} FAIL"


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.report")
    ap.add_argument("--section", choices=["dryrun", "roofline", "both"], default="both")
    ap.add_argument("--dir", default=str(ART),
                    help="the cell records (default build/dryrun)")
    args = ap.parse_args(argv)
    cells = load_cells(art=args.dir)
    print(summary(cells))
    if args.section in ("dryrun", "both"):
        print("\n### Dry-run matrix\n")
        print(dryrun_table(cells))
    if args.section in ("roofline", "both"):
        print("\n### Roofline (single-pod 16x16, per-device per-step seconds)\n")
        print(roofline_table(cells))


if __name__ == "__main__":
    main()
