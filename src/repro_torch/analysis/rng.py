"""rng-discipline checker: random draws name their generator.

The port reproduces its runs from explicit seeds: a ``torch.Generator`` passed
to every draw, and ``np.random.default_rng(seed)`` streams on the host (the
reference's ``prng-discipline`` rule guards ``jax.random`` keys; the port's
RNG is stateful, so its rule is different). A draw from a process-global
generator silently couples two callers' streams — a test that draws first
changes every later result — and a global seed hides that until the order
changes. Flagged, per call site:

- ``torch.rand`` / ``rand_like`` / ``randn`` / ``randn_like`` / ``randint`` /
  ``randint_like`` / ``randperm`` / ``normal`` / ``bernoulli`` /
  ``multinomial``, and the in-place samplers ``.normal_`` / ``.uniform_`` /
  ``.bernoulli_`` / ``.random_`` / ``.exponential_`` / ``.geometric_`` /
  ``.cauchy_`` / ``.log_normal_``, called without a ``generator=`` keyword
  (the ``.bernoulli`` / ``.multinomial`` tensor methods are not told apart
  from a numpy ``Generator``'s and are not flagged);
- ``torch.manual_seed`` / ``torch.seed`` / ``torch.cuda.manual_seed`` /
  ``torch.cuda.manual_seed_all`` / ``torch.cuda.seed``: seeding a global
  generator;
- the global ``np.random`` samplers and ``np.random.seed`` (any
  ``np.random.<name>(...)`` but the explicit-stream constructors:
  ``default_rng``, ``Generator``, ``SeedSequence`` and the bit generators).

``import numpy`` / ``import torch`` aliases are resolved through the
module's import table.
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Set

from repro_torch.analysis.framework import (Checker, Finding, SourceFile,
                                            register)

RULE = "rng-discipline"

_TORCH_DRAWS = {"rand", "rand_like", "randn", "randn_like", "randint",
                "randint_like", "randperm", "normal", "bernoulli",
                "multinomial"}
_METHOD_DRAWS = {"normal_", "uniform_", "bernoulli_", "random_",
                 "exponential_", "geometric_", "cauchy_", "log_normal_"}
_TORCH_SEEDS = {"manual_seed", "seed", "cuda.manual_seed",
                "cuda.manual_seed_all", "cuda.seed", "cuda.seed_all"}
_NP_STREAMS = {"default_rng", "Generator", "SeedSequence", "BitGenerator",
               "PCG64", "PCG64DXSM", "Philox", "SFC64", "MT19937"}


def _aliases(tree: ast.AST, module: str) -> Set[str]:
    """Names this module binds to ``module`` (``import numpy as np``)."""
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == module:
                    out.add(a.asname or a.name)
    return out


def _has_generator(call: ast.Call) -> bool:
    return any(kw.arg == "generator" for kw in call.keywords)


@register
class RngDisciplineChecker(Checker):
    name = RULE
    description = ("random draws without an explicit generator, global "
                   "seeding, global np.random samplers")
    bug_class = "streams coupled through a process-global generator (silent)"

    def check_file(self, sf: SourceFile) -> Iterable[Finding]:
        torch_names = _aliases(sf.tree, "torch")
        np_names = _aliases(sf.tree, "numpy")
        findings: List[Finding] = []

        def emit(line, msg):
            findings.append(Finding(rule=self.name, path=sf.rel, line=line,
                                    message=msg, symbol=sf.symbol_at(line)))

        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            try:
                callee = ast.unparse(node.func)
            except Exception:  # pragma: no cover
                continue
            head, _, rest = callee.partition(".")
            if head in torch_names and rest in _TORCH_SEEDS:
                emit(node.lineno, f"'{callee}' seeds a process-global "
                     "generator; pass a torch.Generator to each draw")
            elif head in torch_names and rest in _TORCH_DRAWS:
                if not _has_generator(node):
                    emit(node.lineno, f"'{callee}' draws from the global "
                         "generator; pass generator=")
            elif head in np_names and rest.startswith("random.") and \
                    rest.count(".") == 1 and \
                    rest.split(".")[1] not in _NP_STREAMS:
                emit(node.lineno, f"'{callee}' uses numpy's global random "
                     "state; draw from np.random.default_rng(seed)")
            elif isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _METHOD_DRAWS and \
                    not _has_generator(node):
                emit(node.lineno, f"'.{node.func.attr}' draws from the "
                     "global generator; pass generator=")
        return findings
