"""metrics-hygiene checker: one name, one kind, one label schema.

The obs registry's multi-host aggregation merges snapshots *exactly* —
which only holds if every host agrees on what a metric IS. Two failure
modes break the merge silently:

- the same name registered as two different kinds (a counter on one code
  path, a histogram on another): merge semantics diverge per host;
- the same metric written with different label-key sets (``.inc()`` here,
  ``.inc(reason=...)`` there): series fan out inconsistently and
  Prometheus-text export emits mixed schemas under one HELP block.

This is a project-wide checker: registrations are collected across every
scanned file. Registration sites are calls to ``counter`` / ``gauge`` /
``histogram`` (method or bare import) with a literal string name. Usage
sites (``.inc`` / ``.observe`` / ``.set``) are tied back to a metric name
by resolving the receiver expression through, per file:

- direct chaining: ``obs.counter("x_total", "...").inc()``;
- handle assignment: ``self._c = reg.counter("x_total", ...)``;
- dict-literal registries: ``self.obs = {"cow": reg.counter(...), ...}``
  and functions that *return* such a dict literal
  (``metrics = _search_metrics(reg)`` → ``metrics["cow"]``).

Receivers that don't resolve (function parameters, non-metric objects with
a ``.set()``) are ignored — the checker never guesses.
"""
from __future__ import annotations

import ast
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.analysis.framework import Checker, Finding, SourceFile, register

RULE = "metrics-hygiene"

_KINDS = {"counter", "gauge", "histogram"}
_WRITES = {"inc", "observe", "set"}


def _callee_tail(call: ast.Call) -> str:
    f = call.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _reg_call(node: ast.expr) -> Optional[Tuple[str, str]]:
    """(metric_name, kind) when ``node`` is a registration with a literal
    string name; None otherwise."""
    if not isinstance(node, ast.Call):
        return None
    kind = _callee_tail(node)
    if kind not in _KINDS:
        return None
    args = node.args
    if args and isinstance(args[0], ast.Constant) and \
            isinstance(args[0].value, str):
        return args[0].value, kind
    for kw in node.keywords:
        if kw.arg == "name" and isinstance(kw.value, ast.Constant) and \
                isinstance(kw.value.value, str):
            return kw.value.value, kind
    return None


def _dict_literal_handles(d: ast.Dict) -> Dict[str, str]:
    """{literal_key: metric_name} for registration-valued dict entries."""
    out: Dict[str, str] = {}
    for k, v in zip(d.keys, d.values):
        reg = _reg_call(v)
        if reg and isinstance(k, ast.Constant) and isinstance(k.value, str):
            out[k.value] = reg[0]
    return out


@register
class MetricsHygieneChecker(Checker):
    name = RULE
    description = ("metric names registered under one kind and written "
                   "with one label-key schema")
    bug_class = "divergent multi-host merges / mixed Prometheus schemas"

    def check_project(self, files: Sequence[SourceFile]) -> Iterable[Finding]:
        # metric -> list of (kind, path, line, symbol)
        regs: Dict[str, List[Tuple[str, str, int, str]]] = defaultdict(list)
        # metric -> list of (frozen label keys, path, line, symbol)
        uses: Dict[str, List[Tuple[Tuple[str, ...], str, int, str]]] = \
            defaultdict(list)

        for sf in files:
            if sf.tree is None:
                continue
            handles: Dict[str, str] = {}     # receiver text -> metric name
            dict_fns: Dict[str, Dict[str, str]] = {}

            for node in ast.walk(sf.tree):
                # function returning a dict literal of registrations
                if isinstance(node, ast.FunctionDef):
                    for stmt in node.body:
                        if isinstance(stmt, ast.Return) and \
                                isinstance(stmt.value, ast.Dict):
                            entries = _dict_literal_handles(stmt.value)
                            if entries:
                                dict_fns[node.name] = entries
                if not isinstance(node, ast.Assign):
                    continue
                val, targets = node.value, node.targets
                reg = _reg_call(val)
                if reg:
                    for t in targets:
                        handles[ast.unparse(t)] = reg[0]
                elif isinstance(val, ast.Dict):
                    entries = _dict_literal_handles(val)
                    for t in targets:
                        base = ast.unparse(t)
                        for key, metric in entries.items():
                            handles[f"{base}[{key!r}]"] = metric

            # second pass: resolve `m = _search_metrics(...)` through the
            # dict-returning functions found above
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.Assign) and \
                        isinstance(node.value, ast.Call):
                    fname = _callee_tail(node.value)
                    if fname in dict_fns:
                        for t in node.targets:
                            base = ast.unparse(t)
                            for key, metric in dict_fns[fname].items():
                                handles[f"{base}[{key!r}]"] = metric

            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.Call):
                    continue
                reg = _reg_call(node)
                if reg:
                    regs[reg[0]].append((reg[1], sf.rel, node.lineno,
                                         sf.symbol_at(node.lineno)))
                    continue
                f = node.func
                if not (isinstance(f, ast.Attribute) and f.attr in _WRITES):
                    continue
                recv = f.value
                metric = None
                inner = _reg_call(recv)
                if inner:                      # chained .inc() on the call
                    metric = inner[0]
                else:
                    metric = handles.get(ast.unparse(recv))
                if metric is None:
                    continue
                labels = tuple(sorted(kw.arg for kw in node.keywords
                                      if kw.arg))
                uses[metric].append((labels, sf.rel, node.lineno,
                                     sf.symbol_at(node.lineno)))

        findings: List[Finding] = []
        for metric, sites in sorted(regs.items()):
            kinds = sorted({k for k, *_ in sites})
            if len(kinds) > 1:
                for kind, path, line, symbol in sites:
                    findings.append(Finding(
                        rule=self.name, path=path, line=line, symbol=symbol,
                        message=(f"metric '{metric}' registered as "
                                 f"{' and '.join(kinds)}; a name must have "
                                 "exactly one kind")))
        for metric, sites in sorted(uses.items()):
            schemas = {labels for labels, *_ in sites}
            if len(schemas) > 1:
                canonical = sorted(schemas, key=lambda s: (-sum(
                    1 for labels, *_ in sites if labels == s), s))[0]
                for labels, path, line, symbol in sites:
                    if labels == canonical:
                        continue
                    findings.append(Finding(
                        rule=self.name, path=path, line=line, symbol=symbol,
                        message=(f"metric '{metric}' written with label "
                                 f"keys {list(labels)} but predominantly "
                                 f"with {list(canonical)}; label schemas "
                                 "must agree")))
        return findings
