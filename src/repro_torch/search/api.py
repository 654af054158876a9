"""``repro_torch.search.run`` — the front door to the discrete search.

Resolves the adapter from the model family (``core.search.make_adapter``:
dense FFN units, one unit per expert for MoE, Mamba blocks for SSM) and the
objective (``SearchConfig(objective=...)`` or the ``objective=`` keyword,
which wins), then runs the engine. A hybrid (Zamba2) stack runs the
reference's two-phase composite by default: the Mamba blocks' within-head
permutations, then the shared block's FFN (P/S/R). ``forward_kwargs``
(``enc_embeds`` / ``vision_embeds``) reach every forward of the search, as
in the reference.
"""
from __future__ import annotations

import dataclasses

from repro_torch.search.engine import _run_engine

__all__ = ["run"]


def _sources(proposals, scfg):
    """One proposal source per island (or None for the native sources)."""
    if proposals is None:
        return None
    if not isinstance(proposals, (list, tuple)):
        proposals = [proposals]
    if len(proposals) != max(int(scfg.islands), 1):
        raise ValueError(
            f"{len(proposals)} proposal source(s) for {scfg.islands} "
            f"islands: pass one source per island")
    return list(proposals)


def run(params_fp, params_base, cfg, qcfg, calib_tokens, scfg=None, *,
        objective=None, adapter=None, proposals=None, forward_kwargs=None,
        hybrid=None):
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
    adapter: explicit unit adapter (``core.search``); disables the hybrid
        two-phase run unless ``hybrid=True``.
    proposals: proposal source ``(t_u, k, pcfg) -> [FFNTransform] * k``,
        called once per island step: one source (one island) or a list
        with one source per island. None draws natively from one
        torch.Generator per island (``search.islands.make_island_streams``).
        For the two-phase hybrid run, a dict {"mamba": ..., "shared": ...}
        of what each phase takes.
    forward_kwargs: keyword inputs of every ``forward`` of the search:
        ``enc_embeds`` (B, T, D) for an encoder-decoder stack (required
        there), ``vision_embeds`` (B, P, D) for a vision stack. With
        patches, the CE objectives compare P+S-1 logits with S-1 labels
        and raise ``ValueError``, as the reference's do; ``shard_calib``
        slices the tokens but not these inputs, and raises too.
    hybrid: force (True) or suppress (False) the two-phase hybrid run;
        None runs it exactly when ``cfg.block_pattern == "hybrid"`` and no
        ``adapter`` is given (False searches a hybrid stack's Mamba blocks
        alone).
    """
    from repro_torch.core.search import SearchConfig, make_adapter

    scfg = scfg if scfg is not None else SearchConfig()
    if objective is not None:
        scfg = dataclasses.replace(scfg, objective=objective)
    if hybrid is None:
        hybrid = cfg.block_pattern == "hybrid" and adapter is None
    if hybrid:
        if cfg.block_pattern != "hybrid":
            raise ValueError(f"hybrid=True needs block_pattern='hybrid', got "
                             f"{cfg.block_pattern!r}")
        phases = proposals or {}
        return _run_hybrid(params_fp, params_base, cfg, qcfg, calib_tokens,
                           scfg, {k: _sources(phases.get(k), scfg)
                                  for k in ("mamba", "shared")},
                           forward_kwargs)
    return _run_engine(params_fp, params_base, cfg, qcfg, calib_tokens, scfg,
                       adapter=adapter or make_adapter(cfg),
                       proposals=_sources(proposals, scfg),
                       forward_kwargs=forward_kwargs)


def _run_hybrid(params_fp, params_base, cfg, qcfg, calib_tokens, scfg,
                proposals, forward_kwargs=None):
    """Hybrid (Zamba2) InvarExplore, the reference's ``_run_hybrid``: phase
    1 hill-climbs the Mamba blocks' within-head permutations for
    ``steps // 2`` steps; phase 2 the shared FFN's P/S/R for the REMAINDER
    ``steps - steps // 2`` (an odd budget is spent in full), starting from
    phase 1's quantized model. Each phase starts its streams from
    ``scfg.seed``. The returned histories, accept rate and stats merge
    both phases."""
    from repro_torch.core.search import (MambaAdapter, SharedFFNAdapter,
                                         _merge_phase_stats)

    n1 = scfg.steps // 2
    n2 = scfg.steps - n1
    r1 = _run_engine(params_fp, params_base, cfg, qcfg, calib_tokens,
                     dataclasses.replace(scfg, steps=n1),
                     adapter=MambaAdapter(cfg), proposals=proposals["mamba"],
                     forward_kwargs=forward_kwargs)
    r2 = _run_engine(params_fp, r1.params_q, cfg, qcfg, calib_tokens,
                     dataclasses.replace(scfg, steps=n2),
                     adapter=SharedFFNAdapter(cfg),
                     proposals=proposals["shared"],
                     forward_kwargs=forward_kwargs)
    r2.history = r1.history + r2.history
    r2.initial_loss = r1.initial_loss
    r2.accept_rate = (r1.accept_rate * n1 + r2.accept_rate * n2) \
        / max(scfg.steps, 1)
    if r1.island_histories and r2.island_histories:
        r2.island_histories = [h1 + h2 for h1, h2 in
                               zip(r1.island_histories, r2.island_histories)]
    r2.stats = _merge_phase_stats(r1.stats, r2.stats)
    return r2
