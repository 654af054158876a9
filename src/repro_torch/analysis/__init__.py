"""repro_torch.analysis: the port's own static-analysis pass.

``python -m repro_torch.analysis src/repro_torch`` runs four AST-plus-replay
checkers guarding invariants no generic linter knows about (RNG discipline,
monotonic-clock durations, the CUDA kernels' launch budgets, obs-registry
hygiene), compares against the committed ``analysis_baseline_torch.json``
and fails only on NEW findings. The reference's jit-purity checker has no
counterpart: nothing in the port is traced (no jit, no ``torch.compile``,
no CUDA-graph capture).
"""
from repro_torch.analysis.framework import (CHECKERS, AnalysisReport,
                                            Checker, Finding, SourceFile,
                                            diff_against_baseline,
                                            load_baseline, run_analysis,
                                            save_baseline)

__all__ = ["CHECKERS", "AnalysisReport", "Checker", "Finding", "SourceFile",
           "run_analysis", "load_baseline", "save_baseline",
           "diff_against_baseline"]
