"""Core of the port's static-analysis pass (the reference's
``repro.analysis.framework``): findings, checker registry, baseline.

The pass is an AST-plus-replay framework, not a style linter: every
checker guards an *invariant the test suite cannot see* — RNG discipline,
monotonic-clock durations, the kernels' launch budgets, metrics registry
hygiene. Checkers come in two shapes:

- per-file: ``check_file(SourceFile)`` walks one module's AST;
- project: ``check_project(files)`` sees every scanned file at once (needed
  for cross-file invariants like "one metric name, one kind") and may run
  real code (the launch-budget checker replays the kernels' planners over
  the config zoo).

Findings are identified for baseline purposes by (rule, path, symbol,
message) — NOT by line number — so unrelated edits above a known finding do
not churn the committed baseline. The baseline file gives the pass
fail-on-new semantics: ``python -m repro_torch.analysis src/repro_torch``
exits non-zero only
for findings that are neither suppressed in-line nor recorded in the
baseline.

Suppression: append ``# analysis: ignore[rule]`` (or a bare
``# analysis: ignore`` to silence every rule) to the finding's anchor line.
``# analysis: skip-file`` within the first ten lines skips the whole module.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import pathlib
import re
from collections import Counter as _Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = ["Finding", "SourceFile", "Checker", "CHECKERS", "register",
           "collect_files", "run_analysis", "AnalysisReport",
           "load_baseline", "save_baseline", "diff_against_baseline",
           "BASELINE_VERSION", "DEFAULT_BASELINE"]

BASELINE_VERSION = 1
DEFAULT_BASELINE = "analysis_baseline_torch.json"

_IGNORE_RE = re.compile(r"#\s*analysis:\s*ignore(?:\[([A-Za-z0-9_,\- ]+)\])?")
_SKIP_FILE_RE = re.compile(r"#\s*analysis:\s*skip-file")


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    """One violation. ``symbol`` is the enclosing def/class qualname (or ""),
    part of the baseline identity so findings survive line churn."""

    rule: str
    path: str                    # posix path relative to the scan root
    line: int
    message: str
    symbol: str = ""

    @property
    def key(self) -> Tuple[str, str, str, str]:
        return (self.rule, self.path, self.symbol, self.message)

    def to_json(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "symbol": self.symbol, "message": self.message}

    @staticmethod
    def from_json(d: dict) -> "Finding":
        return Finding(rule=d["rule"], path=d["path"],
                       line=int(d.get("line", 0)),
                       message=d["message"], symbol=d.get("symbol", ""))


class SourceFile:
    """A parsed module plus the per-line suppression map."""

    def __init__(self, path: pathlib.Path, rel: str, text: str):
        self.path = path
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.tree: Optional[ast.AST] = None
        self.parse_error: Optional[SyntaxError] = None
        try:
            self.tree = ast.parse(text)
        except SyntaxError as e:
            self.parse_error = e
        self.skip = any(_SKIP_FILE_RE.search(ln) for ln in self.lines[:10])
        # line -> set of suppressed rule names ("*" = all)
        self.suppressed: Dict[int, set] = {}
        for i, ln in enumerate(self.lines, 1):
            m = _IGNORE_RE.search(ln)
            if m:
                rules = ({r.strip() for r in m.group(1).split(",")}
                         if m.group(1) else {"*"})
                self.suppressed.setdefault(i, set()).update(rules)
        self._symbols: Optional[Dict[int, str]] = None

    def is_suppressed(self, finding: Finding) -> bool:
        rules = self.suppressed.get(finding.line)
        return bool(rules) and ("*" in rules or finding.rule in rules)

    def symbol_at(self, line: int) -> str:
        """Qualname of the innermost def/class containing ``line``."""
        if self._symbols is None:
            spans: List[Tuple[int, int, str]] = []

            def walk(node, prefix):
                for child in ast.iter_child_nodes(node):
                    if isinstance(child, (ast.FunctionDef,
                                          ast.AsyncFunctionDef,
                                          ast.ClassDef)):
                        qual = f"{prefix}{child.name}"
                        end = getattr(child, "end_lineno", child.lineno)
                        spans.append((child.lineno, end, qual))
                        walk(child, qual + ".")
                    else:
                        walk(child, prefix)

            if self.tree is not None:
                walk(self.tree, "")
            self._symbols = {}
            # innermost wins: apply wider spans first
            for lo, hi, qual in sorted(spans, key=lambda s: -(s[1] - s[0])):
                for ln in range(lo, hi + 1):
                    self._symbols[ln] = qual
        return self._symbols.get(line, "")


class Checker:
    """Base class. Subclasses set ``name``/``description``/``bug_class`` and
    override ``check_file`` and/or ``check_project``."""

    name: str = "abstract"
    description: str = ""
    bug_class: str = ""

    def check_file(self, sf: SourceFile) -> Iterable[Finding]:
        return ()

    def check_project(self, files: Sequence[SourceFile]) -> Iterable[Finding]:
        return ()


CHECKERS: Dict[str, Checker] = {}


def register(cls):
    """Class decorator: instantiate and add to the registry."""
    inst = cls()
    if inst.name in CHECKERS:
        raise ValueError(f"duplicate checker name {inst.name!r}")
    CHECKERS[inst.name] = inst
    return cls


def _load_default_checkers() -> None:
    """Import the shipped checker modules (idempotent)."""
    from repro_torch.analysis import (clocks, launch_budget,  # noqa: F401
                                      metrics_hygiene, rng)


def collect_files(paths: Sequence[str],
                  root: Optional[pathlib.Path] = None) -> List[SourceFile]:
    """Expand files/directories into SourceFiles with root-relative names."""
    root = pathlib.Path(root or pathlib.Path.cwd()).resolve()
    seen = {}
    for p in paths:
        p = pathlib.Path(p)
        candidates = (sorted(p.rglob("*.py")) if p.is_dir() else [p])
        for c in candidates:
            c = c.resolve()
            if "__pycache__" in c.parts or c in seen:
                continue
            try:
                rel = c.relative_to(root).as_posix()
            except ValueError:
                rel = c.as_posix()
            seen[c] = SourceFile(c, rel, c.read_text())
    return list(seen.values())


@dataclasses.dataclass
class AnalysisReport:
    findings: List[Finding]              # kept (not suppressed), sorted
    suppressed: List[Finding]            # silenced by inline comments
    files: List[str]
    checkers: List[str]
    new: List[Finding] = dataclasses.field(default_factory=list)
    baselined: List[Finding] = dataclasses.field(default_factory=list)
    stale_baseline: List[dict] = dataclasses.field(default_factory=list)
    baseline_path: Optional[str] = None

    def to_json(self) -> dict:
        by_rule = _Counter(f.rule for f in self.findings)
        return {
            "version": BASELINE_VERSION,
            "tool": "repro_torch.analysis",
            "checkers": self.checkers,
            "files_scanned": len(self.files),
            "findings": [f.to_json() for f in self.findings],
            "new": [f.to_json() for f in self.new],
            "baselined": [f.to_json() for f in self.baselined],
            "suppressed": [f.to_json() for f in self.suppressed],
            "stale_baseline": self.stale_baseline,
            "summary": {
                "total": len(self.findings),
                "new": len(self.new),
                "baselined": len(self.baselined),
                "suppressed": len(self.suppressed),
                "by_rule": dict(sorted(by_rule.items())),
            },
        }


def run_analysis(paths: Sequence[str], *, select: Optional[Sequence[str]] = None,
                 root: Optional[pathlib.Path] = None) -> AnalysisReport:
    """Run every (selected) checker over ``paths``. Baseline comparison is a
    separate step (``diff_against_baseline``) so callers can re-diff one run
    against several baselines (the tests do)."""
    _load_default_checkers()
    names = list(select) if select else sorted(CHECKERS)
    unknown = [n for n in names if n not in CHECKERS]
    if unknown:
        raise KeyError(f"unknown checker(s) {unknown}; "
                       f"known: {sorted(CHECKERS)}")
    files = [sf for sf in collect_files(paths, root=root) if not sf.skip]
    by_rel = {sf.rel: sf for sf in files}

    kept: List[Finding] = []
    suppressed: List[Finding] = []
    for name in names:
        checker = CHECKERS[name]
        produced: List[Finding] = []
        for sf in files:
            if sf.tree is None:
                continue
            produced.extend(checker.check_file(sf))
        produced.extend(checker.check_project(files))
        for f in produced:
            sf = by_rel.get(f.path)
            if sf is not None and sf.is_suppressed(f):
                suppressed.append(f)
            else:
                kept.append(f)
    kept.sort()
    suppressed.sort()
    return AnalysisReport(findings=kept, suppressed=suppressed,
                          files=[sf.rel for sf in files], checkers=names)


# -- baseline ---------------------------------------------------------------

def load_baseline(path) -> List[Finding]:
    data = json.loads(pathlib.Path(path).read_text())
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(f"baseline {path}: unsupported version "
                         f"{data.get('version')!r}")
    return [Finding.from_json(d) for d in data["findings"]]


def save_baseline(path, findings: Sequence[Finding]) -> None:
    data = {
        "version": BASELINE_VERSION,
        "tool": "repro_torch.analysis",
        "note": ("Accepted findings. The pass fails only on findings NOT in "
                 "this file; regenerate with "
                 "`python -m repro_torch.analysis <paths> --update-baseline`."),
        "findings": [f.to_json() for f in sorted(findings)],
    }
    pathlib.Path(path).write_text(json.dumps(data, indent=1) + "\n")


def diff_against_baseline(report: AnalysisReport,
                          baseline: Sequence[Finding]) -> AnalysisReport:
    """Split ``report.findings`` into new vs baselined (multiset semantics:
    two identical findings need two baseline entries). Baseline entries that
    no longer occur are reported as stale — informational, never fatal."""
    budget = _Counter(f.key for f in baseline)
    new, matched = [], []
    for f in report.findings:
        if budget.get(f.key, 0) > 0:
            budget[f.key] -= 1
            matched.append(f)
        else:
            new.append(f)
    report.new = new
    report.baselined = matched
    report.stale_baseline = [
        {"rule": k[0], "path": k[1], "symbol": k[2], "message": k[3],
         "count": c}
        for k, c in sorted(budget.items()) if c > 0]
    return report
