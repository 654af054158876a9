"""monotonic-clock checker: durations must not come from the wall clock.

``time.time()`` is subject to NTP slew and step adjustments; a duration
computed as ``time.time() - t0`` can be negative or wildly wrong, which is
how ``proposals_per_sec`` once went infinite mid-benchmark. Durations belong
on ``time.monotonic()`` / ``time.perf_counter()`` (or ``obs.trace_span``,
which does it for you). Wall time is fine for *timestamps* — this checker
only fires when a wall-clock reading reaches a subtraction:

- ``time.time() - anything`` / ``anything - time.time()`` directly, or
- ``x - y`` where either name was assigned from ``time.time()`` anywhere in
  the same function scope (assignment tracking is per-scope and text-based:
  ``t0 = time.time() ... dt = time.time() - t0``).

``from time import time`` aliases are resolved through the import table.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Set

from repro_torch.analysis.framework import Checker, Finding, SourceFile, register

RULE = "monotonic-clock"

_WALL_SUFFIX = ("time.time", "datetime.now", "datetime.utcnow")


def _wall_callees(tree: ast.AST) -> Set[str]:
    """Expression texts that read the wall clock in this module, resolving
    ``import time as t`` / ``from time import time as now`` aliases."""
    out = {"time.time"}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "time" and alias.asname:
                    out.add(f"{alias.asname}.time")
        elif isinstance(node, ast.ImportFrom):
            if node.module == "time":
                for alias in node.names:
                    if alias.name == "time":
                        out.add(alias.asname or alias.name)
    return out


def _is_wall_call(node: ast.expr, wall: Set[str]) -> bool:
    if not isinstance(node, ast.Call):
        return False
    try:
        callee = ast.unparse(node.func)
    except Exception:  # pragma: no cover
        return False
    return callee in wall or callee.endswith(_WALL_SUFFIX)


@register
class MonotonicClockChecker(Checker):
    name = RULE
    description = "time.time() readings used in duration arithmetic"
    bug_class = "negative / skewed durations under NTP clock adjustment"

    def check_file(self, sf: SourceFile) -> Iterable[Finding]:
        wall = _wall_callees(sf.tree)
        findings: List[Finding] = []

        def emit(line):
            findings.append(Finding(
                rule=self.name, path=sf.rel, line=line,
                message=("wall-clock reading used to compute a duration; "
                         "use time.monotonic()/perf_counter() or "
                         "obs.trace_span"),
                symbol=sf.symbol_at(line)))

        # scopes: module + each function, walked separately so a var named
        # t0 in one function doesn't taint another
        scopes = [sf.tree] + [n for n in ast.walk(sf.tree)
                              if isinstance(n, (ast.FunctionDef,
                                                ast.AsyncFunctionDef))]
        for scope in scopes:
            body = getattr(scope, "body", [])
            tainted: Set[str] = set()
            nodes: List[ast.AST] = []

            def visit(node):
                if node is not scope and isinstance(
                        node, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.Lambda)):
                    return
                nodes.append(node)
                for child in ast.iter_child_nodes(node):
                    visit(child)

            for stmt in body:
                visit(stmt)
            for node in nodes:
                if isinstance(node, ast.Assign) and \
                        _is_wall_call(node.value, wall):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            tainted.add(tgt.id)
            for node in nodes:
                if isinstance(node, ast.BinOp) and \
                        isinstance(node.op, ast.Sub):
                    for side in (node.left, node.right):
                        if _is_wall_call(side, wall) or (
                                isinstance(side, ast.Name)
                                and side.id in tainted):
                            emit(node.lineno)
                            break
        return findings
