"""Search traffic: InvarExplore jobs back to back, as a quantiser runs them.

Set-up makes the model's weights and the calibration batch from the seed
on the device and runs one short job, which builds the port's kernels and
warms every shape the jobs use. The window then runs whole jobs through
the port's front door, ``core.pipeline.quantize_model(method="rtn",
search=SearchConfig(...))`` (RTN of the attention projections, then the
search over the FFNs), each seeded from the run's seed and its index, until
the window's end; the job in flight then finishes outside the window.

Proposals scored inside the window are the program's
``search_proposals_total`` counter read at the window's two edges. With
``--trace 1`` the program's ``search.step`` spans are kept in memory, and
one whole job (``profile_job``, the second by default) runs under the
profiler.

Once the window has closed, the plain reference scores the untransformed
model and the transforms that sampled jobs returned, from the same weights
and batch (``reference/search_check.py``).
"""
from __future__ import annotations

import dataclasses
import time
import types

import numpy as np

from perfbench.devtrace import Stretch, warm_profiler
from perfbench.generate import derive_seed
from perfbench.metrics import _yardstick as Y
from perfbench.spans import SpanSink
from perfbench.weights import make_weights
from perfbench.window import EdgeReader


@dataclasses.dataclass
class Job:
    index: int
    start: float
    end: float
    initial: tuple            # (loss, activation MSE) untransformed
    final: tuple              # (loss, activation MSE) of the best state
    n_accept: int
    transforms: tuple


def job_record(index, start, end, res):
    """A job's record from its ``SearchResult``: its history holds (step,
    loss, primary, aux, accepted); the best state is the accepted step of
    least loss (the start when none was accepted)."""
    hist = res.history
    best = min((h for h in hist if h[4]), key=lambda h: h[1])
    return Job(index, start, end, (float(hist[0][1]), float(hist[0][3])),
               (float(best[1]), float(best[3])),
               sum(1 for h in hist[1:] if h[4]),
               tuple(x.detach().clone() for x in res.transforms))


def calibration_batch(arch, mix, seed: int, device):
    """The calibration tokens of a run: ``calib_seqs`` x ``seq_len`` ids drawn
    on the device from the run's seed."""
    import torch
    gen = torch.Generator(device=device).manual_seed(derive_seed(seed, 2))
    return torch.randint(0, arch.vocab_size,
                         (int(mix["calib_seqs"]), int(mix["seq_len"])),
                         generator=gen, device=device)


def model_config(arch):
    from repro_torch.models.config import ModelConfig
    return ModelConfig(**{f.name: getattr(arch, f.name)
                          for f in dataclasses.fields(arch)})


def sample_jobs(jobs, seed: int, n: int):
    """The job with the most accepted moves, and others drawn from the
    seed, ``n`` in all."""
    if not jobs:
        return []
    first = max(jobs, key=lambda j: (j.n_accept, -j.index))
    rest = [j for j in jobs if j is not first]
    rng = np.random.default_rng([int(seed) % 2**63, 4])
    pick = rng.permutation(len(rest))[: max(n - 1, 0)]
    return [first] + [rest[i] for i in sorted(pick)]


def run(ctx):
    import torch

    from repro_torch import obs
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.quant import QuantConfig
    from repro_torch.core.search import SearchConfig

    arch, mix, dev = ctx.cell.arch, ctx.cell.traffic, ctx.device
    q = ctx.cell.config["quant"]
    cfg = model_config(arch)
    qcfg = QuantConfig(bits=q["bits"], group_size=q["group_size"])
    B, S = int(mix["calib_seqs"]), int(mix["seq_len"])
    scfg = SearchConfig(steps=int(mix["steps"]), objective=mix["objective"],
                        n_match_layers=int(mix["n_match_layers"]),
                        ce_weight=float(mix["ce_weight"]),
                        population=int(mix["population"]),
                        temperature=float(mix["temperature"]),
                        fused_kernel=bool(mix["fused_kernel"]), log_every=0)
    cuda = dev.type == "cuda"

    t_enter = time.monotonic()
    params = make_weights(arch, ctx.seed, dev, getattr(torch,
                                                       arch.param_dtype))
    calib = calibration_batch(arch, mix, ctx.seed, dev)

    def job(seed, steps=None):
        s = dataclasses.replace(scfg, seed=seed,
                                steps=steps or scfg.steps)
        return quantize_model(params, cfg, qcfg, method="rtn",
                              calib_tokens=calib, search=s,
                              device=dev).search

    if cuda:
        torch.cuda.synchronize()
    t_made = time.monotonic()
    job(derive_seed(ctx.seed, 3), steps=int(mix["warm_steps"]))
    if ctx.trace:
        warm_profiler()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    counter = obs.get_registry().counter("search_proposals_total",
                                         "Candidate transforms proposed")
    sink = None
    if ctx.trace:
        sink = SpanSink(("search.step",))
        obs.set_trace_sink(sink)
    t0 = time.monotonic()
    t1 = t0 + ctx.seconds
    edges = EdgeReader(counter.total, t1)
    jobs, stretch, in_stretch = [], None, 0.0
    profile_job = int(mix["profile_job"])
    while time.monotonic() < t1:
        j = len(jobs)
        seed_j = derive_seed(ctx.seed, 10, j)
        start = time.monotonic()
        if ctx.trace and j == profile_job:
            before = counter.total()
            with Stretch() as stretch:
                res = job(seed_j)
            in_stretch = counter.total() - before
        else:
            res = job(seed_j)
        jobs.append(job_record(j, start, time.monotonic(), res))
        del res
    proposals = edges.delta()
    if sink is not None:
        obs.set_trace_sink(None)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    window = (t0, t1)

    # --- the check, after the window: the program's state is freed ---
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.monotonic()
    numbers = ctx.check(params, calib, jobs)
    gains = sorted((j.initial[0] - j.final[0]) / j.initial[0] for j in jobs)
    about = {"jobs": len(jobs), "accepts": [j.n_accept for j in jobs],
             "loss_gain_median": gains[len(gains) // 2] if gains else None,
             # set-up: start-up and imports, weights and batch, warm-up
             "setup_split_s": [round(t_enter - ctx.t_start, 3),
                               round(t_made - t_enter, 3),
                               round(t0 - t_made, 3)],
             "after_window_s": round(jobs[-1].end - t1, 3) if jobs else 0,
             "check_s": round(time.monotonic() - t_check, 3)}
    return types.SimpleNamespace(
        kind="search", arch=arch, mix=mix, window=window,
        window_s=ctx.seconds, setup_s=t0 - ctx.t_start,
        attempted=len(jobs), failed=0, proposals=proposals,
        step_spans=sink.spans["search.step"] if sink else None,
        stretch=None if stretch is None else (stretch.t0, stretch.t1),
        trace=None if stretch is None else stretch.summary,
        trace_host=None if stretch is None else stretch.summary,
        proposals_in_stretch=in_stretch, population=scfg.population,
        flops_per_proposal=Y.forward_flops(arch, B, S),
        peak_ops=Y.PEAK_OPS_PER_S[arch.compute_dtype],
        tq_bytes_per_proposal=Y.tq_bytes_per_proposal(
            arch, q["group_size"], 4 if arch.param_dtype == "float32" else 2),
        memory_peak=peak, numbers=numbers, jobs=jobs, about=about)


def _reference(ctx, params, calib, precision):
    from perfbench.reference.search_check import SearchReference

    mix, q = ctx.cell.traffic, ctx.cell.config["quant"]
    return SearchReference(params, ctx.cell.arch, calib, bits=q["bits"],
                           group=q["group_size"],
                           n_match=int(mix["n_match_layers"]),
                           ce_weight=float(mix["ce_weight"]),
                           precision=precision)


def check(ctx, params, calib, jobs, control=None):
    """The compared numbers of a search run, from the plain reference.
    With ``control`` (a lower precision of ``reference.lowp``), also the
    numbers of the control: the reference computed in that precision, put
    in the program's place; they are left in ``ctx.control``."""
    from perfbench.reference.lowp import no_tf32
    from perfbench.reference.search_check import search_numbers

    no_tf32()
    ref = _reference(ctx, params, calib, "float32")
    sampled = sample_jobs(jobs, ctx.seed, int(ctx.cell.traffic["check_jobs"]))
    numbers = search_numbers(ref, [j.initial for j in jobs],
                             [j.final + (j.transforms,) for j in sampled])
    if control:
        low = _reference(ctx, params, calib, control)
        ctx.control = search_numbers(
            ref, [(low.loss0, low.mse0)],
            [low.score(j.transforms) + (j.transforms,) for j in sampled])
    return numbers
