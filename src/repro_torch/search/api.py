"""``repro_torch.search.run`` — the front door to the discrete search.

Resolves the adapter from the model family (dense only in this slice) and
the objective (``SearchConfig(objective=...)`` or the ``objective=``
keyword, which wins), then runs the engine. Hybrid two-phase search waits
for the hybrid model family (ROADMAP Queue 1 item 12).
"""
from __future__ import annotations

import dataclasses

from repro_torch.search.engine import _run_engine

__all__ = ["run"]


def run(params_fp, params_base, cfg, qcfg, calib_tokens, scfg=None, *,
        objective=None, proposals=None):
    """Run the InvarExplore search; returns a ``core.search.SearchResult``.

    params_fp: original FP model (reference H₀ / KL targets).
    params_base: base-method-processed model — FFN weights in the
        continuous domain; every OTHER quantizable weight already
        fake-quantized (frozen during the search).
    calib_tokens: (B, S) int tensor on the params' device.
    scfg: ``core.search.SearchConfig`` (defaults reproduce the paper run).
    objective: registry name ("ce", "kl") or an ``Objective`` instance;
        overrides ``scfg.objective``.
    proposals: proposal source ``(t_u, k, pcfg) -> [FFNTransform] * k``,
        called once per step; None draws natively from a torch.Generator.
    """
    from repro_torch.core.search import SearchConfig, make_adapter

    scfg = scfg if scfg is not None else SearchConfig()
    if objective is not None:
        scfg = dataclasses.replace(scfg, objective=objective)
    return _run_engine(params_fp, params_base, cfg, qcfg, calib_tokens, scfg,
                       adapter=make_adapter(cfg),
                       proposals=proposals)
