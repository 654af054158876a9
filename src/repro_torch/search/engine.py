"""Population × island annealed discrete search (the Algorithm 1 engine),
sequential lane.

Per island step: pick a unit ``u`` from the island's host stream, draw K
candidate transforms for it from the island's proposal source (called
exactly once per island step), build each candidate's fake-quant unit
(fused: ``transform_quant`` kernels; unfused: ``transform_unit`` +
``fake_quant``), score each with one calibration forward, and apply the
Metropolis rule to the best candidate (T = 0: accept iff the loss strictly
improves). The degrees of freedom, each defaulting to the paper's
single-chain hill climb:

- population K, and the memory model (``SearchConfig.install``):
  ``"unit"`` keeps ONE stack plus the K built units and runs each forward
  with the adapter's ``unit_override`` (only unit ``u`` reads the
  candidate: a dense layer's FFN, or one expert of an MoE layer; the stack
  is not copied); ``"stack"`` installs each unit into a full copy of the
  stack (K stacks live at once) and runs the forward without an override.
- temperature T under an annealing schedule (``search/anneal.py``).
- islands: independent chains run one after another, each with its own
  host stream and proposal source (``search/islands.py``), and elite
  migration every ``migrate_every`` steps. With ``shard_calib=True`` each
  island climbs on its own contiguous slice of the calibration batch
  (views of the FP reference's logits and taps), with its own step-0
  baseline; α comes from the full batch.
- a tried-point tabu memory per island (``tabu=N``, ``search/tabu.py``):
  when all K candidates were already evaluated at the current chain state
  the build and forwards are skipped and the cached scalars replayed; if
  the rule then accepts the cached move, only that unit is rebuilt.

Host streams are the reference's verbatim, so unit picks and accept draws
match the JAX engine's. Accepted moves install the winning unit into a
FRESH stack (``adapter.install_unit``) and transform tree
(``search.install.tree_install_unit``), so an elite snapshot never aliases
state that a later step changes.

Observability: the reference's nine ``search_*`` metrics, spans
``search.run`` / ``search.step`` / ``search.eval``, and a ``[search]``
line through ``obs.emit`` every ``log_every`` steps. Spans with no
histogram split a run into its phases: ``search.setup`` (the base
stack, its fake-quant, the FP reference forward, the baseline scores and
α) and ``search.finish`` (after the step loop), once a run; inside
``search.eval``, ``search.build`` (the K candidates), ``search.score``
(the K forwards and the objective dispatched) and ``search.sync`` (the
host's wait for the K losses), none of them on a tabu replay; and
``search.accept`` around each accepted move's install. With
``obs.enable_profiler()`` on, each is a ``torch.profiler`` range too, and
the scoring forward adds ``objective.evaluate``. ``measure_memory``
reads the CUDA caching allocator (see ``_run_engine``).

Mapped islands (``SearchConfig(mapped=True)``): one island per rank of the
``torch.distributed`` world, each on its own device (``_run_mapped``).
Every rank replays every island's host streams (unit picks, accept
uniforms), so the accept logic stays on the host exactly as in the
sequential lane; each rank steps only its own island, through the same
build and score code, and the per-step traffic is one all-gather of each
island's (loss, primary, aux) row. Migration is
``islands.migrate_on_mesh`` (one scalar race, the winner's state
broadcast), and at the end the elite's best state is broadcast to every
rank. Equal to the sequential lane bit for bit by construction: the same
operations on the same inputs on each island's device, and exact data
movement between them.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import invariance as inv
from repro_torch.core import objective as obj
from repro_torch.data.calib import shard_calibration
from repro_torch.dist import runtime
from repro_torch.dist.collectives import all_gather, elite_broadcast
from repro_torch.models.model import forward
from repro_torch.search import anneal
from repro_torch.search.install import (cast_unit, stack_unit_batch,
                                        tree_bytes, tree_install_unit)
from repro_torch.search.islands import (IslandState, make_island_streams,
                                        migrate, migrate_on_mesh)
from repro_torch.search.tabu import TabuMemory, transform_bytes

__all__ = ["_run_engine", "run_population_search"]

def _resolve_install(scfg) -> str:
    mode = str(scfg.install)
    if mode not in ("unit", "stack"):
        raise ValueError(
            f"SearchConfig.install must be 'unit' or 'stack', got {mode!r}")
    return mode


def _search_metrics():
    """Instrument handles on the process registry (get-or-create, so a
    registry ``reset()`` between runs keeps these valid)."""
    reg = obs.get_registry()
    return {
        "proposals": reg.counter(
            "search_proposals_total", "Candidate transforms proposed"),
        "accepts": reg.counter(
            "search_accepts_total", "Moves accepted by the Metropolis rule"),
        "uphill": reg.counter(
            "search_uphill_accepts_total",
            "Accepted strictly-worse (uphill) moves"),
        "migrations": reg.counter(
            "search_migrations_total", "Elite island migrations applied"),
        "tabu": reg.counter(
            "search_tabu_hits_total",
            "Proposals deduplicated by the tried-point memory"),
        "best": reg.gauge(
            "search_objective_best", "Best combined objective seen so far"),
        "temp": reg.gauge(
            "search_temperature", "Annealing temperature at the last step"),
        "step": reg.histogram(
            "search_step_seconds", "Wall time of one full search step"),
        "eval": reg.histogram(
            "search_eval_seconds",
            "Proposal evaluation latency (dispatch + loss sync)"),
    }


def _unit_transform(ts: inv.FFNTransform, u: int) -> inv.FFNTransform:
    return inv.FFNTransform(*(x[u] for x in ts))


def run_population_search(params_fp, params_base, cfg, qcfg, calib_tokens,
                          scfg, adapter, forward_kwargs=None):
    """Deprecated alias of the engine loop (the reference's shim): warns with
    ``DeprecationWarning`` and runs ``_run_engine`` — call
    ``repro_torch.search.run``, which adds objective resolution and the
    hybrid two-phase dispatch."""
    warnings.warn(
        "repro_torch.search.engine.run_population_search is deprecated; use "
        "repro_torch.search.run(...)", DeprecationWarning, stacklevel=2)
    return _run_engine(params_fp, params_base, cfg, qcfg, calib_tokens, scfg,
                       adapter, forward_kwargs=forward_kwargs)


def _run_engine(params_fp, params_base, cfg, qcfg, calib_tokens, scfg,
                adapter, proposals=None, forward_kwargs=None):
    """Run the engine; returns a ``core.search.SearchResult``.

    ``params_fp``: FP reference model. ``params_base``: FFN weights in the
    continuous domain, every other quantizable weight already fake-quantized.
    ``proposals``: one proposal source ``(t_u, k, pcfg) -> [FFNTransform]``
    per island, or None for the native per-island sources on the tokens'
    device (``search.islands.make_island_streams``), which draw with the
    adapter's own ``propose`` where it has one (``MambaAdapter``).
    ``forward_kwargs`` go to every ``forward`` (``enc_embeds`` /
    ``vision_embeds`` over the full batch). With ``shard_calib`` over more
    than one island the reference slices the tokens but not these, so its
    per-island forwards fail on the batch; here that raises ``ValueError``
    before the search starts.

    ``fused_kernel`` on an adapter without ``transform_quant_unit`` (a Mamba
    block has no fused build) warns and runs the unfused lane;
    ``stats["fused"]`` then says False, as in the reference.

    ``measure_memory`` (CUDA only; the CPU has no allocator statistics and
    raises ``ValueError``): after set-up the engine synchronises, empties
    the allocator's cache and resets its peak; ``stats["peak_live_bytes"]``
    is then ``torch.cuda.max_memory_allocated()`` at the end minus
    ``memory_allocated()`` at that start — the bytes of the allocator's
    blocks handed to tensors (rounded up to its block sizes), not the
    tensors' own bytes. ``stack_bytes`` is the fake-quant stack's payload
    and ``candidate_batch_bytes`` the largest per-step payload of the K
    built units (``"unit"``) or the K stacks (``"stack"``).
    """
    from repro_torch.core.search import SearchResult

    n_match = min(scfg.n_match_layers, cfg.n_layers)
    K = max(int(scfg.population), 1)
    n_islands = max(int(scfg.islands), 1)
    migrate_every = int(scfg.migrate_every)
    fused = bool(scfg.fused_kernel)
    if fused and not hasattr(adapter, "transform_quant_unit"):
        warnings.warn(
            f"fused_kernel=True but adapter {type(adapter).__name__} has no "
            f"transform_quant_unit; falling back to the unfused "
            f"transform->quantize path", stacklevel=2)
        fused = False
    install_mode = _resolve_install(scfg)
    tabu_cap = int(scfg.tabu)
    shard_calib = bool(scfg.shard_calib)
    measure = bool(scfg.measure_memory)
    if tabu_cap and scfg.mapped:
        raise ValueError(
            "tabu memory needs the host-synchronous sequential lane "
            "(candidate fingerprints are host state); mapped=True cannot "
            "combine with tabu>0")
    mapped = bool(scfg.mapped)
    rank = runtime.process_index()
    if mapped and n_islands != runtime.process_count():
        raise ValueError(
            f"mapped=True runs one island per device (one device a "
            f"process): islands={n_islands} but the world has "
            f"{runtime.process_count()} process(es) (match --islands to "
            f"the world size)")
    if mapped and measure:
        raise ValueError(
            "measure_memory reads one device's allocator over the sequential "
            "lane; mapped=True runs one island per device")
    fwd_kw = dict(forward_kwargs or {})
    if shard_calib and fwd_kw and n_islands > 1:
        raise ValueError(
            f"shard_calib slices the calibration tokens but not "
            f"forward_kwargs {sorted(fwd_kw)} (the reference's semantics: "
            f"its per-island forwards then fail on the batch); run the "
            f"islands on the full batch (shard_calib=False)")
    objv = obj.get_objective(scfg.objective)
    dev = calib_tokens.device
    if measure and dev.type != "cuda":
        raise ValueError(
            "measure_memory reads the CUDA caching allocator's statistics; "
            f"the calibration tokens are on {dev}")

    def make_env(tokens, lfp, hfp):
        return obj.ObjectiveEnv(calib=tokens, logits_fp=lfp, hidden_fp=hfp,
                                vocab_size=cfg.vocab_size, n_match=n_match,
                                ce_weight=scfg.ce_weight)

    def make_eval(env):
        state = objv.prepare(env)

        def evaluate(fq_stack, override=None):
            logits, hidden = forward(adapter.install(params_base, fq_stack),
                                     cfg, env.calib, collect_hidden=True,
                                     layer_override=override, **fwd_kw)
            with obs.profile_range("objective.evaluate"):
                return objv.evaluate(logits, hidden, state, env)

        return evaluate

    # set-up: the base stack, its fake-quant, the FP reference forward,
    # the baseline score(s) and alpha
    with obs.trace_span("search.setup"):
        base = adapter.base_stack(params_base)
        # the model's dtypes, which the stack and every candidate take (a base
        # method may hand over a wider base: core.pipeline's docstring)
        like = adapter.base_stack(params_fp)
        transforms0 = stack_unit_batch(
            [inv.identity_transform(adapter.f_dim, dev)] * adapter.n_units)
        fq0 = cast_unit(adapter.quant_stack(base, qcfg), like)

        # FP reference forward on the FULL batch; per-island slices are views
        # into these (batch axis 0 for tokens/logits, axis 1 for the taps)
        logits_fp, hidden_fp = forward(params_fp, cfg, calib_tokens,
                                       collect_hidden=True, **fwd_kw)
        hidden_fp = hidden_fp[:n_match].clone() if n_match else None

        env_global = make_env(calib_tokens, logits_fp, hidden_fp)
        eval_global = make_eval(env_global)
        p0, a0 = (float(x) for x in eval_global(fq0))
        alpha = float(objv.resolve_mix(p0, a0, env_global))
        loss0 = p0 + alpha * a0
        # the islands this process steps: all of them, or its own when mapped
        own = [rank] if mapped else list(range(n_islands))
        if shard_calib:
            slices = shard_calibration(calib_tokens, n_islands)
            bounds = np.cumsum([0] + [int(s.shape[0]) for s in slices])
            eval_fns = {i: make_eval(make_env(
                slices[i], logits_fp[bounds[i]:bounds[i + 1]],
                hidden_fp[:, bounds[i]:bounds[i + 1]] if n_match else None))
                for i in own}
            # per-island step-0 baselines on each island's OWN slice (1 island
            # == the full batch == the replicated baseline)
            base0 = {i: tuple(float(x) for x in eval_fns[i](fq0)) for i in own}
            if mapped:   # every rank needs every island's baseline
                row = torch.tensor(base0[rank], dtype=torch.float64,
                                   device=runtime.collective_device())
                base0 = [tuple(r.tolist()) for r in all_gather(row)]
            else:
                base0 = [base0[i] for i in range(n_islands)]
        else:
            eval_fns = {i: eval_global for i in own}
            base0 = [(p0, a0)] * n_islands
        loss0s = [p + alpha * a for p, a in base0]

    def quant_candidate(t_new, u):
        """The candidate unit in the stack's dtypes: both lanes compute the
        transform in f32, and the reference's ``tree_install_unit`` casts
        what it installs, so the override forward reads what an installed
        stack would hold."""
        if fused:
            unit = adapter.transform_quant_unit(base, t_new, u, qcfg)
        else:
            unit = adapter.quant_unit(adapter.transform_unit(base, t_new, u),
                                      qcfg)
        return cast_unit(unit, like)

    def build(cands, fq_stack, u):
        """The K candidates' batch: built units, or stacks holding them."""
        with obs.trace_span("search.build"):
            if install_mode == "unit":
                return [quant_candidate(c, u) for c in cands]
            return [adapter.install_unit(fq_stack, u, quant_candidate(c, u))
                    for c in cands]

    def score(evaluate, batch, fq_stack, u):
        """Host lists (loss, primary, aux) over the K candidates: the K
        forwards and the objective dispatched (``search.score``), then the
        one read-back (``search.sync``)."""
        with obs.trace_span("search.score"):
            if install_mode == "unit":
                outs = [evaluate(fq_stack, adapter.unit_override(u, unit))
                        for unit in batch]
            else:
                outs = [evaluate(stack) for stack in batch]
            p_vec = torch.stack([o[0] for o in outs]).float()
            a_vec = torch.stack([o[1] for o in outs]).float()
            loss_vec = p_vec + alpha * a_vec     # fp32, as on the reference
            rows = torch.stack([loss_vec, p_vec, a_vec])
        with obs.trace_span("search.sync"):
            return rows.tolist()

    schedule = anneal.temperature_schedule(scfg.anneal,
                                           float(scfg.temperature), scfg.steps)
    stats = {"migrations": 0, "uphill_accepts": 0,
             "proposals": scfg.steps * K * n_islands, "fused": fused,
             "mapped": mapped, "objective": objv.name,
             "install": install_mode, "tabu_hits": 0,
             "shard_calib": shard_calib, "tabu_skips": 0,
             "tabu_rebuilds": 0}
    metrics = _search_metrics()
    metrics["best"].set(loss0)

    if mapped:
        return _run_mapped(
            SearchResult, adapter, params_base, scfg, schedule, stats,
            metrics, objv.name, K, n_islands, migrate_every, transforms0, fq0,
            loss0s, base0, dev, proposals, eval_fns[rank], build, score)

    islands, tabus = [], []
    for i in range(n_islands):
        rng, native = make_island_streams(scfg.seed, i, dev,
                                          getattr(adapter, "propose", None))
        islands.append(IslandState(
            index=i, rng=rng,
            proposals=native if proposals is None else proposals[i],
            transforms=transforms0, fq_stack=fq0,
            current_loss=loss0s[i], best_loss=loss0s[i],
            best_transforms=transforms0, best_fq=fq0,
            history=[(0, loss0s[i], base0[i][0], base0[i][1], True)]))
        tabus.append(TabuMemory(tabu_cap) if tabu_cap else None)

    if measure:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        baseline = torch.cuda.memory_allocated(dev)
    batch_bytes = 0

    def island_step(isl, step, T):
        nonlocal batch_bytes
        mem = tabus[isl.index]
        u = int(isl.rng.integers(adapter.n_units))
        cands = isl.proposals(_unit_transform(isl.transforms, u), K,
                              scfg.proposal)
        skipped = False
        if mem is not None:
            cand_bytes = [transform_bytes(c) for c in cands]
            fps = [mem.fingerprint(u, cb) for cb in cand_bytes]
            hits_before = mem.hits
            cached = [mem.lookup(fp) for fp in fps]
            new_hits = mem.hits - hits_before
            if new_hits:
                stats["tabu_hits"] += new_hits
                metrics["tabu"].inc(new_hits)
            skipped = all(c is not None for c in cached)
        with obs.trace_span("search.eval", hist=metrics["eval"]):
            if skipped:
                # replay: no build, no forward; the source was already
                # called this step, exactly as on the eval path
                stats["tabu_skips"] += 1
                i = int(np.argmin([c[0] for c in cached]))
                loss, p, a = cached[i]
                chosen = None
            else:
                batch = build(cands, isl.fq_stack, u)
                if measure:
                    batch_bytes = max(batch_bytes, tree_bytes(batch))
                losses, ps, auxs = score(eval_fns[isl.index], batch,
                                         isl.fq_stack, u)
                i = int(np.argmin(losses))       # first minimum on ties
                loss, p, a = losses[i], ps[i], auxs[i]
                chosen = batch[i]
                del batch      # free the other candidates before an install
                if mem is not None:
                    for k in range(K):
                        mem.record(fps[k], losses[k], ps[k], auxs[k])
        metrics["proposals"].inc(K, objective=objv.name)
        delta = loss - isl.current_loss
        uniform = isl.rng.random() if T > 0.0 else None
        accepted = anneal.accept(delta, T, uniform)
        if accepted:
            with obs.trace_span("search.accept"):
                if skipped:
                    stats["tabu_rebuilds"] += 1
                    fq_new = adapter.install_unit(isl.fq_stack, u,
                                                  quant_candidate(cands[i], u))
                elif install_mode == "unit":
                    fq_new = adapter.install_unit(isl.fq_stack, u, chosen)
                else:
                    fq_new = chosen
                if delta > 0.0:              # strictly-worse moves only
                    stats["uphill_accepts"] += 1
                    metrics["uphill"].inc()
                metrics["accepts"].inc()
                isl.current_loss = loss
                isl.fq_stack = fq_new
                isl.transforms = tree_install_unit(isl.transforms, u, cands[i])
                isl.n_accept += 1
                if mem is not None:
                    mem.advance(cand_bytes[i])
                if loss < isl.best_loss:
                    isl.best_loss = loss
                    isl.best_transforms = isl.transforms
                    isl.best_fq = isl.fq_stack
        isl.history.append((step, loss, float(p), float(a), accepted))

    with obs.trace_span("search.run", mode="sequential", islands=n_islands,
                        population=K) as run_span:
        for step in range(1, scfg.steps + 1):
            T = schedule(step)
            with obs.trace_span("search.step", step=step,
                                hist=metrics["step"]):
                for isl in islands:
                    island_step(isl, step, T)
                if migrate_every and n_islands > 1 \
                        and step % migrate_every == 0:
                    if tabu_cap:
                        src = min(islands, key=lambda s: s.best_loss)
                        dst = max(islands, key=lambda s: s.current_loss)
                        will = (src is not dst
                                and src.best_loss < dst.current_loss)
                    moved = int(migrate(islands))
                    stats["migrations"] += moved
                    metrics["migrations"].inc(moved)
                    if tabu_cap and moved and will:
                        tabus[dst.index].adopt_digest(tabus[src.index])
            metrics["best"].set(min(s.best_loss for s in islands))
            metrics["temp"].set(T)
            if scfg.log_every and step % scfg.log_every == 0:
                best = min(s.best_loss for s in islands)
                rate = sum(s.n_accept for s in islands) / (step * n_islands)
                obs.emit("search", step=step, best=f"{best:.5f}",
                         accept=f"{rate:.2%}", T=f"{T:.4g}",
                         elapsed_s=f"{run_span.elapsed():.1f}")

    with obs.trace_span("search.finish"):
        elite = min(islands, key=lambda s: s.best_loss)
        # monotonic clock (run_span.dur): wall time steps backwards under NTP
        stats["proposals_per_sec"] = stats["proposals"] / max(run_span.dur, 1e-9)
        if measure:
            torch.cuda.synchronize(dev)
            stats["peak_live_bytes"] = max(
                torch.cuda.max_memory_allocated(dev) - baseline, 0)
            stats["stack_bytes"] = tree_bytes(fq0)
            stats["candidate_batch_bytes"] = batch_bytes
        return SearchResult(
            params_q=adapter.install(params_base, elite.best_fq),
            transforms=elite.best_transforms,
            history=elite.history,
            accept_rate=elite.n_accept / max(scfg.steps, 1),
            final_loss=elite.best_loss,
            initial_loss=loss0s[elite.index],
            island_histories=[s.history for s in islands],
            stats=stats,
        )


def _run_mapped(SearchResult, adapter, params_base, scfg, schedule, stats,
                metrics, obj_name, K, n_islands, migrate_every, transforms0,
                fq0, loss0s, base0, dev, proposals, evaluate, build, score):
    """The mapped island loop: island r on rank r, on that rank's device.

    - Every rank replays every island's host stream (unit pick, accept
      uniform), so the accept decisions and histories are computed on the
      host, identically everywhere.
    - Each rank builds and scores its own island's K candidates with the
      sequential lane's ``build`` / ``score``, and the (loss, primary,
      aux) rows meet in one all-gather (float32 as ``score`` made them:
      exact).
    - Migration moves only data: ``islands.migrate_on_mesh`` on the local
      island's trees, the scalars replayed on the host as ``migrate``
      would.
    - The ``search_*`` counters count the local island (proposals, accepts,
      uphill); migrations are counted on rank 0 only, so a merged snapshot
      reconciles with ``stats``.
    """
    rank = runtime.process_index()
    proposer = getattr(adapter, "propose", None)
    islands = []
    for i in range(n_islands):
        rng, native = make_island_streams(scfg.seed, i, dev, proposer)
        mine = i == rank
        islands.append(IslandState(
            index=i, rng=rng,
            proposals=(None if not mine else native if proposals is None
                       else proposals[i]),
            transforms=transforms0 if mine else None,
            fq_stack=fq0 if mine else None,
            current_loss=loss0s[i], best_loss=loss0s[i],
            best_transforms=transforms0 if mine else None,
            best_fq=fq0 if mine else None,
            history=[(0, loss0s[i], base0[i][0], base0[i][1], True)]))
    me = islands[rank]
    install_mode = stats["install"]

    with obs.trace_span("search.run", mode="mapped", islands=n_islands,
                        population=K) as run_span:
        for step in range(1, scfg.steps + 1):
            T = schedule(step)
            with obs.trace_span("search.step", step=step,
                                hist=metrics["step"]):
                us = [int(isl.rng.integers(adapter.n_units))
                      for isl in islands]
                u = us[rank]
                cands = me.proposals(_unit_transform(me.transforms, u), K,
                                     scfg.proposal)
                with obs.trace_span("search.eval", hist=metrics["eval"]):
                    batch = build(cands, me.fq_stack, u)
                    losses, ps, auxs = score(evaluate, batch, me.fq_stack, u)
                    i = int(np.argmin(losses))   # first minimum on ties
                    chosen = batch[i]
                    del batch
                    row = torch.tensor([losses[i], ps[i], auxs[i]],
                                       dtype=torch.float32,
                                       device=runtime.collective_device())
                    rows = [r.tolist() for r in all_gather(row)]
                metrics["proposals"].inc(K, objective=obj_name)
                for isl, (loss, p, a) in zip(islands, rows):
                    delta = loss - isl.current_loss
                    uniform = isl.rng.random() if T > 0.0 else None
                    accepted = anneal.accept(delta, T, uniform)
                    if accepted:
                        with obs.trace_span("search.accept"):
                            if delta > 0.0:
                                stats["uphill_accepts"] += 1
                                if isl is me:
                                    metrics["uphill"].inc()
                            isl.current_loss = loss
                            isl.n_accept += 1
                            if isl is me:
                                metrics["accepts"].inc()
                                me.fq_stack = (adapter.install_unit(
                                    me.fq_stack, u, chosen)
                                    if install_mode == "unit" else chosen)
                                me.transforms = tree_install_unit(
                                    me.transforms, u, cands[i])
                            if loss < isl.best_loss:
                                isl.best_loss = loss
                                if isl is me:
                                    me.best_transforms = me.transforms
                                    me.best_fq = me.fq_stack
                    isl.history.append((step, loss, float(p), float(a),
                                        accepted))
                del chosen
                if migrate_every and n_islands > 1 \
                        and step % migrate_every == 0:
                    (me.transforms, me.fq_stack, me.best_transforms,
                     me.best_fq, did) = migrate_on_mesh(
                        me.best_loss, me.current_loss, me.transforms,
                        me.fq_stack, me.best_transforms, me.best_fq)
                    if did:
                        # replay the decision on the host scalars, exactly
                        # as ``migrate`` makes it
                        src = min(islands, key=lambda s: s.best_loss)
                        dst = max(islands, key=lambda s: s.current_loss)
                        dst.current_loss = src.best_loss
                        dst.best_loss = min(dst.best_loss, src.best_loss)
                        stats["migrations"] += 1
                        if rank == 0:
                            metrics["migrations"].inc()
            metrics["best"].set(min(s.best_loss for s in islands))
            metrics["temp"].set(T)
            if scfg.log_every and step % scfg.log_every == 0:
                best = min(s.best_loss for s in islands)
                rate = sum(s.n_accept for s in islands) / (step * n_islands)
                obs.emit("search", step=step, best=f"{best:.5f}",
                         accept=f"{rate:.2%}", T=f"{T:.4g}",
                         elapsed_s=f"{run_span.elapsed():.1f}", mode="mapped")

    with obs.trace_span("search.finish"):
        elite = min(islands, key=lambda s: s.best_loss)
        best_t = elite_broadcast(me.best_transforms, elite.index)
        best_fq = elite_broadcast(me.best_fq, elite.index)
        stats["proposals_per_sec"] = stats["proposals"] / max(run_span.dur, 1e-9)
        return SearchResult(
            params_q=adapter.install(params_base, best_fq),
            transforms=best_t,
            history=elite.history,
            accept_rate=elite.n_accept / max(scfg.steps, 1),
            final_loss=elite.best_loss,
            initial_loss=loss0s[elite.index],
            island_histories=[s.history for s in islands],
            stats=stats,
        )
