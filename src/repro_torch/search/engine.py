"""The Algorithm 1 engine: sequential lane, one island.

Per step: pick a unit ``u`` from the host stream, draw K candidate
transforms for it from the proposal source, build each candidate's
fake-quant unit (fused: ``transform_quant`` kernels; unfused:
``transform_unit`` + ``fake_quant``), score each with one calibration
forward in which only layer ``u`` reads the candidate (the stack itself is
not copied), and apply the Metropolis rule to the best candidate
(T = 0: accept iff the loss strictly improves).

Host streams are the reference's verbatim: ``np.random.default_rng(seed)``,
``u = rng.integers(n_units)`` every step and ``rng.random()`` only when
T > 0, so the unit picks match the JAX engine's exactly. Proposals come from
a pluggable source (``core.invariance.NativeProposals`` by default).

Accepted moves install the winning unit into a FRESH stack
(``adapter.install_unit``), so the elite snapshot never aliases state that
a later step changes. Islands, tabu memory, sharded calibration, mapped
execution and memory sampling are not ported yet and raise.
"""
from __future__ import annotations

import logging
import time

import numpy as np
import torch

from repro_torch.core import invariance as inv
from repro_torch.core import objective as obj
from repro_torch.models.model import forward
from repro_torch.search import anneal

__all__ = ["_run_engine"]

log = logging.getLogger(__name__)

_NOT_PORTED = (
    ("islands", lambda v: int(v) > 1, "ROADMAP Queue 1 item 7 (islands, migrate)"),
    ("tabu", lambda v: int(v) > 0, "ROADMAP Queue 1 item 7 (search/tabu.py)"),
    ("shard_calib", bool, "ROADMAP Queue 1 item 7 (shard_calib)"),
    ("mapped", bool, "ROADMAP Queue 1 item 14 (mapped islands)"),
    ("measure_memory", bool, "ROADMAP Queue 1 item 7 (measure_memory)"),
)


def _check_ported(scfg) -> None:
    for field, used, item in _NOT_PORTED:
        value = getattr(scfg, field)
        if used(value):
            raise NotImplementedError(
                f"SearchConfig.{field}={value!r} is not ported yet: {item}")


def _stack_transform(t: inv.FFNTransform, n: int) -> inv.FFNTransform:
    return inv.FFNTransform(*(x.unsqueeze(0).repeat((n,) + (1,) * x.ndim)
                              for x in t))


def _unit_transform(ts: inv.FFNTransform, u: int) -> inv.FFNTransform:
    return inv.FFNTransform(*(x[u] for x in ts))


def _install_transform(ts: inv.FFNTransform, u: int,
                       t: inv.FFNTransform) -> inv.FFNTransform:
    out = []
    for stack, row in zip(ts, t):
        new = stack.clone()
        new[u] = row
        out.append(new)
    return inv.FFNTransform(*out)


def _run_engine(params_fp, params_base, cfg, qcfg, calib_tokens, scfg,
                adapter, proposals=None):
    """Run the engine; returns a ``core.search.SearchResult``.

    ``params_fp``: FP reference model. ``params_base``: FFN weights in the
    continuous domain, every other quantizable weight already fake-quantized.
    ``proposals``: proposal source ``(t_u, k, pcfg) -> [FFNTransform]``;
    None draws natively from ``torch.Generator(seed)`` on the tokens' device.
    """
    from repro_torch.core.search import SearchResult

    _check_ported(scfg)
    n_match = min(scfg.n_match_layers, cfg.n_layers)
    K = max(int(scfg.population), 1)
    fused = bool(scfg.fused_kernel)
    objv = obj.get_objective(scfg.objective)
    dev = calib_tokens.device
    if proposals is None:
        proposals = inv.NativeProposals(scfg.seed, dev)

    base = adapter.base_stack(params_base)
    transforms0 = _stack_transform(inv.identity_transform(adapter.f_dim, dev),
                                   adapter.n_units)
    fq0 = adapter.quant_stack(base, qcfg)

    logits_fp, hidden_fp = forward(params_fp, cfg, calib_tokens,
                                   collect_hidden=True)
    hidden_fp = hidden_fp[:n_match].clone() if n_match else None
    env = obj.ObjectiveEnv(calib=calib_tokens, logits_fp=logits_fp,
                           hidden_fp=hidden_fp, vocab_size=cfg.vocab_size,
                           n_match=n_match, ce_weight=scfg.ce_weight)
    state = objv.prepare(env)

    def evaluate(fq_stack, override=None):
        logits, hidden = forward(adapter.install(params_base, fq_stack), cfg,
                                 env.calib, collect_hidden=True,
                                 layer_override=override)
        return objv.evaluate(logits, hidden, state, env)

    p0, a0 = (float(x) for x in evaluate(fq0))
    alpha = float(objv.resolve_mix(p0, a0, env))
    loss0 = p0 + alpha * a0

    def quant_candidate(t_new, u):
        if fused:
            return adapter.transform_quant_unit(base, t_new, u, qcfg)
        return adapter.quant_unit(adapter.transform_unit(base, t_new, u), qcfg)

    schedule = anneal.temperature_schedule(scfg.anneal,
                                           float(scfg.temperature), scfg.steps)
    rng = np.random.default_rng(scfg.seed)
    cur_loss = best_loss = loss0
    fq_stack = best_fq = fq0
    transforms = best_t = transforms0
    history = [(0, loss0, p0, a0, True)]
    n_accept = uphill = 0

    t_start = time.perf_counter()
    for step in range(1, scfg.steps + 1):
        T = schedule(step)
        u = int(rng.integers(adapter.n_units))
        cands = proposals(_unit_transform(transforms, u), K, scfg.proposal)
        units, ps, auxs = [], [], []
        for cand in cands:
            unit = quant_candidate(cand, u)
            p, a = evaluate(fq_stack, adapter.unit_override(u, unit))
            units.append(unit)
            ps.append(p)
            auxs.append(a)
        p_vec = torch.stack(ps).float()
        a_vec = torch.stack(auxs).float()
        loss_vec = p_vec + alpha * a_vec         # fp32, as on the reference
        i = int(torch.argmin(loss_vec))          # first minimum on ties
        loss, p, a = (float(x) for x in (loss_vec[i], p_vec[i], a_vec[i]))
        delta = loss - cur_loss
        uniform = rng.random() if T > 0.0 else None
        accepted = anneal.accept(delta, T, uniform)
        if accepted:
            if delta > 0.0:              # strictly-worse moves only
                uphill += 1
            cur_loss = loss
            fq_stack = adapter.install_unit(fq_stack, u, units[i])
            transforms = _install_transform(transforms, u, cands[i])
            n_accept += 1
            if loss < best_loss:
                best_loss = loss
                best_t = transforms
                best_fq = fq_stack
        history.append((step, loss, p, a, accepted))
        if scfg.log_every and step % scfg.log_every == 0:
            log.info("search step=%d best=%.5f accept=%.2f%% T=%.4g "
                     "elapsed_s=%.1f", step, best_loss,
                     100.0 * n_accept / step, T,
                     time.perf_counter() - t_start)
    elapsed = time.perf_counter() - t_start

    stats = {"uphill_accepts": uphill, "proposals": scfg.steps * K,
             "fused": fused, "objective": objv.name,
             "proposals_per_sec": scfg.steps * K / max(elapsed, 1e-9)}
    return SearchResult(
        params_q=adapter.install(params_base, best_fq),
        transforms=best_t,
        history=history,
        accept_rate=n_accept / max(scfg.steps, 1),
        final_loss=best_loss,
        initial_loss=loss0,
        island_histories=[history],
        stats=stats,
    )
