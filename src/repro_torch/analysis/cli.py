"""CLI for the port's static-analysis pass (the reference's
``repro.analysis.cli``).

    PYTHONPATH=src python -m repro_torch.analysis src/repro_torch     # the gate
    PYTHONPATH=src python -m repro_torch.analysis src/repro_torch --json build/analysis/report.json
    PYTHONPATH=src python -m repro_torch.analysis src/repro_torch --update-baseline
    PYTHONPATH=src python -m repro_torch.analysis --list

Exit codes: 0 clean (every finding baselined or suppressed), 1 new
findings, 2 usage errors. The baseline matches findings by
(rule, path, symbol, message) so line churn never trips the gate.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import Optional, Sequence

from repro_torch.analysis import framework as fw


def _human_report(report: fw.AnalysisReport, baseline_used: bool) -> str:
    lines = []
    show = report.new if baseline_used else report.findings
    for f in show:
        sym = f" [{f.symbol}]" if f.symbol else ""
        lines.append(f"{f.path}:{f.line}: {f.rule}: {f.message}{sym}")
    s = report.to_json()["summary"]
    tail = (f"{len(report.files)} files, {len(report.checkers)} checkers: "
            f"{s['total']} findings "
            f"({s['baselined']} baselined, {s['new']} new, "
            f"{s['suppressed']} suppressed)")
    if report.stale_baseline:
        tail += (f"; {len(report.stale_baseline)} stale baseline entr"
                 f"{'y' if len(report.stale_baseline) == 1 else 'ies'} "
                 "(fixed or moved — consider --update-baseline)")
    lines.append(tail)
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repo-specific static analysis for the PyTorch/CUDA port")
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/directories to scan (default: "
                         "src/repro_torch)")
    ap.add_argument("--baseline", default=fw.DEFAULT_BASELINE,
                    help="baseline JSON ('' disables; default "
                         f"{fw.DEFAULT_BASELINE}, ignored if absent unless "
                         "--update-baseline)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="write every current finding to --baseline and "
                         "exit 0")
    ap.add_argument("--json", default="", metavar="PATH",
                    help="also write the full machine-readable report here")
    ap.add_argument("--select", default="",
                    help="comma-separated checker names (default: all)")
    ap.add_argument("--root", default=".",
                    help="paths in the report are relative to this "
                         "(default: cwd; must match the baseline's root)")
    ap.add_argument("--list", action="store_true",
                    help="list registered checkers and exit")
    args = ap.parse_args(argv)

    if args.list:
        fw._load_default_checkers()
        for name in sorted(fw.CHECKERS):
            c = fw.CHECKERS[name]
            print(f"{name}: {c.description}")
            print(f"    guards against: {c.bug_class}")
        return 0

    paths = args.paths or ["src/repro_torch"]
    select = [s.strip() for s in args.select.split(",") if s.strip()] or None
    try:
        report = fw.run_analysis(paths, select=select,
                                 root=pathlib.Path(args.root))
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2

    if args.update_baseline:
        if not args.baseline:
            print("error: --update-baseline needs --baseline",
                  file=sys.stderr)
            return 2
        fw.save_baseline(args.baseline, report.findings)
        print(f"wrote {len(report.findings)} findings to {args.baseline}")
        return 0

    baseline_used = False
    bp = pathlib.Path(args.baseline) if args.baseline else None
    if bp is not None and bp.exists():
        report = fw.diff_against_baseline(report, fw.load_baseline(bp))
        report.baseline_path = str(bp)
        baseline_used = True
    else:
        report.new = list(report.findings)

    if args.json:
        out = pathlib.Path(args.json)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(report.to_json(), indent=1) + "\n")

    print(_human_report(report, baseline_used))
    return 1 if report.new else 0
