"""``repro_torch.search.run`` — the front door to the discrete search.

Resolves the adapter from the model family (``core.search.make_adapter``:
dense FFN units, or one unit per expert for MoE) and the objective
(``SearchConfig(objective=...)`` or the ``objective=`` keyword, which
wins), then runs the engine. Hybrid two-phase search waits for the hybrid
model family (ROADMAP Queue 1 item 12).
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
    objective: registry name ("ce", "kl", "swd_actmatch", "saliency_ce") or
        an ``Objective`` instance;
        overrides ``scfg.objective``.
    proposals: proposal source ``(t_u, k, pcfg) -> [FFNTransform] * k``,
        called once per island step: one source (one island) or a list
        with one source per island. None draws natively from one
        torch.Generator per island (``search.islands.make_island_streams``).
    """
    from repro_torch.core.search import SearchConfig, make_adapter

    scfg = scfg if scfg is not None else SearchConfig()
    if objective is not None:
        scfg = dataclasses.replace(scfg, objective=objective)
    if proposals is not None:
        if not isinstance(proposals, (list, tuple)):
            proposals = [proposals]
        if len(proposals) != max(int(scfg.islands), 1):
            raise ValueError(
                f"{len(proposals)} proposal source(s) for {scfg.islands} "
                f"islands: pass one source per island")
    return _run_engine(params_fp, params_base, cfg, qcfg, calib_tokens, scfg,
                       adapter=make_adapter(cfg), proposals=proposals)
