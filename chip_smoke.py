#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Builds the port's CUDA kernels from ``src/repro_torch/csrc/`` (one nvcc per
source, started together, into ``build/kernels/``), then:

1. kernels vs plain versions on the card, held to exact equality (the
   kernels run the plain versions' fp32 operations in the same order):
   ``group_quant`` on (2048, 2048) f32 and bf16 and at every shape the main
   path gives it (the stacked attention, up and down weights of opt-1.3b
   flattened to (24·2048, 2048), (24·2048, 8192) and (24·8192, 2048) f32),
   ``transform_quant`` up (2048, 8192) and down (8192, 2048), bits 2/3/4,
   groups 32/128, and up and down at every dense FFN shape of the config
   zoo (2-bit g32, a random π); times each at the main path's shapes with
   CUDA events and (device ms) under ``torch.profiler`` beside its bound,
   ``transform_quant`` for an identity, a partially shuffled and a random
   π; then the main path at a small size (opt-tiny) on the card against
   the same path on the CPU, where the wrappers run their plain versions;
2. the main path: ``quantize_model`` RTN and RTN + 16 fused InvarExplore
   steps on random-init opt-1.3b at full width and depth, with held-out
   perplexity for fp32 / RTN / RTN+search and the kernels' launch counts;
3. fused lane vs unfused lane for 6 steps from the same seed;
4. where one search step's time goes (candidate build vs forward, and the
   ``transform_quant`` kernels' device time in the fused build), and
   device time by kernel family under ``torch.profiler`` over a 4-step
   fused search, its set-up included;
5. paged serving: (a) the three paged-decode routes vs the plain version
   at rtol = atol = 1e-5 — the reference's own bar (``tests/test_paged.py``):
   the kernel sums scores and values in another order than
   ``paged_decode_ref`` — at opt-1.3b's head layout, a full-width GQA one,
   a long full-width GQA one (B 2 × 64 pages, lengths [1024, 333] and
   [0, 1000]) where the planner splits the pages across CTAs on every
   route (each check logs n_split), and the small configs' layouts that (d)
   serves, on f32, bf16 and int8 pools, ragged lengths (0, 1,
   page-aligned, P·psz), ``normalize=False`` partials and NaN-poisoned
   dead slots; (b) each route's time at the main path's decode shape, at
   B 8 × 1024 tokens and at B 1 × 8192, with its n_split, beside its bound,
   its device time under the profiler, its plain version and
   ``scaled_dot_product_attention`` on K/V already gathered contiguous
   (repeated to H heads, and with ``enable_gqa`` on K/V as they are);
   (c) ``PagedServer`` on 2-bit opt-1.3b (full width and depth) over the
   reference bench's 8-tenant trace with prefix sharing off, then on:
   outputs token-identical (or parting only at a printed near-tie), held
   to a greedy oracle (the full forward over the dequantized weights),
   0 leaked pages, saved_frac >= 0.5, obs counters equal to the stats,
   paged-decode launches = 24 x decode steps; TTFT, tokens/s, bytes and
   peak memory; then a third sharing-on run under ``torch.profiler``:
   device time by kernel family in the decode steps and prefills, and the
   decode step split into per-layer dequant, the paged-decode kernel, the
   other device work and device idle time; (d) the serving CLI's small configs
   (GQA 4/2, GQA with 2 pages per block, MHA) on the card and on the CPU:
   identical greedy tokens and stats, all three routes launched;
6. contiguous-cache serving and the dequant-matmul: (a) ``flash_decode`` vs
   its plain version at rtol = atol = 2e-4, the reference's bar
   (``tests/test_kernels.py``), at opt-1.3b's head layout, a full-width GQA
   one and the small configs', on f32, bf16 and int8 caches, kv_len 0, 1, a
   tile boundary, ragged and S, and NaN in every slot past kv_len; (b) its
   time (one call, and device time under the profiler) at 6c's decode
   shape and at B 8 x 2048 rows beside its bound, its plain version and
   ``scaled_dot_product_attention`` with a length mask;
   (c) ``BatchedServer`` on 2-bit opt-1.3b (full width and depth, batch 8,
   max_len 128) over phase 5's trace with ``use_flash_decode`` off, then
   on: tokens identical (or parting only at a printed near tie), held to
   the greedy oracle on the left-padded prompts, flash_decode launched 24
   layers x 7 steps x 3 batches = 504 times with the flag on and never
   with it off; tokens/s, step ms, cache bytes, peak memory and device time
   by kernel family over batch 0's steps; (d) opt-tiny reduced (GQA 4/2
   and MHA 4/4, compute and int8 KV, flag on) on the card and on the CPU:
   identical greedy tokens; (e) ``quant_matmul`` vs its plain version at
   5e-4 (the reference's bar) at kernel_bench's three shapes, opt-1.3b's
   projections at M 8 and a 3-bit case with K padding, x in f32 and bf16,
   with times (one call, and the kernels' device time under the profiler)
   beside the bound, the plain version and ``torch.matmul`` on the
   dequantised weights, then the public op once per case.

Prints the ``nvidia-smi`` name/power-limit line, a ``{"kernels": [...]}``
line (all seven ported kernels), and last ``{"ok": true, "device":
{...}}``. Any failed check raises, so the script exits non-zero without
that last line; it also exits non-zero when no CUDA card is present or the
port's sources are missing.
"""
from __future__ import annotations

import importlib
import json
import math
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
FP32_OPS_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
# fp32 operations per output element (from the kernels' arithmetic):
# min, max, divide, rint, add, 2 clamps, subtract, multiply
GQ_OPS = 9
# plus the rotation (2 multiplies, 1 add/sub) and the scale multiply
TQ_OPS = 13

BITS = (2, 3, 4)
GROUPS = (32, 128)
# every distinct dense FFN shape (d_model, d_ff) of the config zoo: opt-1.3b
# and internlm2 share the first
ZOO_FFN = ((2048, 8192), (896, 4864), (2560, 9728), (4096, 6400),
           (2048, 1408), (4096, 11008), (3584, 14336), (1024, 4096),
           (8192, 22528))
PI_KINDS = ("identity", "partial", "random")
STEPS = 16
LANE_STEPS = 6
PROFILE_STEPS = 4

# kernel-name fragments -> family for the profile (first match wins)
FAMILIES = (
    ("transform_quant", "transform_quant (port kernel)"),
    ("group_quant", "group_quant (port kernel)"),
    ("gemm", "matmul (cuBLAS)"),
    ("cutlass", "matmul (cuBLAS)"),
    ("softmax", "softmax / log_softmax"),
    ("reduce", "reductions"),
    ("copy", "copies"),
    ("elementwise", "elementwise"),
)


def log(tag, **kw):
    print(f"{tag}: " + json.dumps(kw, sort_keys=True), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, warmup=3, reps=25):
    """Median of ``reps`` CUDA-event timings of ``fn`` after ``warmup``."""
    return time_stats(torch, fn, warmup, reps)[0]


def time_stats(torch, fn, warmup=3, reps=25):
    """(median, [min, max]) of ``reps`` CUDA-event timings of ``fn`` after
    ``warmup``: the range is the run's own spread."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), [min(times), max(times)]


def device_ms(torch, fn, fragments, calls=20, attempts=3):
    """Device time per call of ``fn``'s kernels whose names hold one of
    ``fragments``, under ``torch.profiler`` over ``calls`` calls after a
    warm-up: the kernels' own time, without the host's launch work that a
    CUDA-event timing of one call also holds.

    The profiler now and then returns a trace without these kernels; the
    trace is then taken again, up to ``attempts`` times. If a trace held
    other device work but never these kernels, their names are wrong and
    that fails. If every trace was empty, the time is that of ``calls``
    calls back to back between two CUDA events, divided by ``calls`` (the
    host's launch gaps included), and a ``device_time_fallback`` line says
    so."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    others = []
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = 0
        for e in prof.key_averages():
            t = getattr(e, "self_device_time_total", 0)
            if any(f in e.key for f in fragments):
                total += t
            elif t > 0:
                others.append(e.key)
        if total > 0:
            return total / calls / 1e3
        log("device_time_retry", fragments=list(fragments),
            others=sorted(set(others)))
    if others:
        raise AssertionError(f"the profiler saw no device time in "
                             f"{fragments}, only in {sorted(set(others))}")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / calls
    log("device_time_fallback", fragments=list(fragments), attempts=attempts,
        ms=ms)
    return ms


def bound_ms(nbytes, nops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def exact(torch, got, want, what):
    """Kernel outputs vs the plain version's, which run the same fp32
    operations in the same order: equal bit for bit, dtype and shape
    included. Returns the max abs difference of the first output (0.0)."""
    for name, g, w in zip(("fq", "scale", "zero"), got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"{what}: {name} {g.dtype} {tuple(g.shape)} "
                                 f"vs plain {w.dtype} {tuple(w.shape)}")
        if not torch.equal(g, w):
            err = float((g.float() - w.float()).abs().max())
            raise AssertionError(f"{what}: {name} differs from the plain "
                                 f"version (max abs {err})")
    return float((got[0].float() - want[0].float()).abs().max())


def main_path_gq_shapes(cfg):
    """The (K, N) shapes the main path gives ``group_quant``: ``fake_quant``
    flattens each stacked (L, K, N) leaf to (L·K, N). One RTN pass of the
    model is one launch per leaf: 4 attention weights, up, down."""
    L, D, F = cfg.n_layers, cfg.d_model, cfg.d_ff
    return (("attn wq/wk/wv/wo", (L * D, D), 4), ("mlp up", (L * D, F), 1),
            ("mlp down", (L * F, D), 1))


def make_pi(torch, kind, f, gen, dev):
    """A permutation of width f: identity, a partial shuffle (an eighth of
    the positions permuted among themselves) or a random one."""
    pi = torch.arange(f, device=dev)
    if kind == "partial":
        idx = torch.randperm(f, generator=gen, device=dev)[: f // 8]
        pi[idx] = idx[torch.randperm(idx.numel(), generator=gen, device=dev)]
    elif kind == "random":
        pi = torch.randperm(f, generator=gen, device=dev)
    return pi


def tq_bytes(K, N, group, f):
    """Bytes transform_quant must move: w read and fq written once, scale
    and zero written, pi (int64), s, cos and sin read once."""
    return 2 * K * N * 4 + 2 * (K // group) * N * 4 + f * (8 + 4) + f * 4


def phase_kernels(torch, ops, ref, gq, tq, cfg):
    """Kernel vs plain version at every listed shape/dtype/bits/group;
    returns the per-kernel timing rows at the main path's shapes."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1234)
    errs = {"group_quant": 0.0, "transform_quant": 0.0}
    main_shapes = main_path_gq_shapes(cfg)
    gq_cases = [((2048, 2048), torch.float32), ((2048, 2048), torch.bfloat16)]
    gq_cases += [(shape, torch.float32) for _, shape, _ in main_shapes]
    for shape, dt in gq_cases:
        w = (torch.randn(shape, generator=gen, device=dev) * 2.5).to(dt)
        for bits in BITS:
            for group in GROUPS:
                err = exact(torch, ops.group_quant(w, bits=bits, group=group),
                            ref.group_quant_ref(w, bits, group),
                            f"group_quant {shape} {dt} b{bits} g{group}")
                errs["group_quant"] = max(errs["group_quant"], err)
                log("kernel_check", kernel="group_quant", shape=list(shape),
                    dtype=str(dt), bits=bits, group=group, max_abs_err=err)
    D, F = 2048, 8192
    pi = torch.randperm(F, generator=gen, device=dev)
    sv = 1.0 + 0.05 * torch.randn(F, generator=gen, device=dev)
    phi = 1e-2 * torch.randn(F // 2, generator=gen, device=dev)
    w_tq = {"up": torch.randn((D, F), generator=gen, device=dev),
            "down": torch.randn((F, D), generator=gen, device=dev)}
    for mode, w in w_tq.items():
        for bits in BITS:
            for group in GROUPS:
                err = exact(torch, ops.transform_quant(
                    w, pi, sv, phi, bits=bits, group=group, mode=mode),
                    ref.transform_quant_ref(w, pi, sv, phi, bits=bits,
                                            group=group, mode=mode),
                    f"transform_quant {mode} b{bits} g{group}")
                errs["transform_quant"] = max(errs["transform_quant"], err)
                log("kernel_check", kernel="transform_quant", mode=mode,
                    shape=list(w.shape), bits=bits, group=group,
                    max_abs_err=err)
    for d, f in ZOO_FFN:   # every zoo FFN shape, 2-bit g32, a random pi
        zpi = torch.randperm(f, generator=gen, device=dev)
        zs = 1.0 + 0.05 * torch.randn(f, generator=gen, device=dev)
        zphi = 1e-2 * torch.randn(f // 2, generator=gen, device=dev)
        for mode in ("up", "down"):
            w = torch.randn((d, f) if mode == "up" else (f, d),
                            generator=gen, device=dev)
            err = exact(torch, ops.transform_quant(
                w, zpi, zs, zphi, bits=2, group=32, mode=mode),
                ref.transform_quant_ref(w, zpi, zs, zphi, bits=2, group=32,
                                        mode=mode),
                f"transform_quant {mode} {tuple(w.shape)} b2 g32")
            errs["transform_quant"] = max(errs["transform_quant"], err)
            log("kernel_check", kernel="transform_quant", mode=mode,
                shape=list(w.shape), bits=2, group=32, pi="random",
                plan=tq.plan(*w.shape, 32, mode)._asdict(), max_abs_err=err)
            del w
        torch.cuda.empty_cache()

    # timing at the main path's shapes (bits 2, group 32): raw launches into
    # preallocated outputs for the kernel, the plain version for plain_ms
    bits, group = 2, 32
    rows = {}
    per_shape = []
    for leaf, (K, N), n in main_shapes:
        w = torch.randn((K, N), generator=gen, device=dev)
        fq, s, z = torch.empty_like(w), *(
            torch.empty((K // group, N), device=dev) for _ in range(2))
        def run():
            gq.launch(w, fq, s, z, bits=bits, group=group)
        t = time_ms(torch, run)
        dm = device_ms(torch, run, ("group_quant",))
        p = time_ms(torch, lambda: ref.group_quant_ref(w, bits, group),
                    reps=10)
        b, by = bound_ms(2 * K * N * 4 + 2 * (K // group) * N * 4,
                         GQ_OPS * K * N)
        per_shape.append(dict(leaf=leaf, shape=[K, N], per_pass=n, ms=t,
                              device_ms=dm, plain_ms=p, bound_ms=b,
                              bound_by=by))
        log("kernel_time", kernel="group_quant", leaf=leaf, shape=[K, N],
            dtype="torch.float32", ms=t, device_ms=dm, plain_ms=p,
            bound_ms=b)
        del w, fq, s, z
    rows["group_quant"] = dict(
        ms=sum(r["ms"] * r["per_pass"] for r in per_shape),
        device_ms=sum(r["device_ms"] * r["per_pass"] for r in per_shape),
        plain_ms=sum(r["plain_ms"] * r["per_pass"] for r in per_shape),
        bound_ms=sum(r["bound_ms"] * r["per_pass"] for r in per_shape),
        bound_by="bytes" if all(r["bound_by"] == "bytes" for r in per_shape)
        else "operations",
        per="one RTN pass of opt-1.3b: 6 launches, one per stacked leaf",
        shapes=per_shape, dtype="float32")
    for shape, dt in gq_cases[:2]:
        w = torch.randn(shape, generator=gen, device=dev).to(dt)
        K, N = shape
        fq, s, z = torch.empty_like(w), *(torch.empty((K // group, N), device=dev)
                                           for _ in range(2))
        t = time_ms(torch, lambda: gq.launch(w, fq, s, z, bits=bits, group=group))
        p = time_ms(torch, lambda: ref.group_quant_ref(w, bits, group))
        nb = 2 * K * N * w.element_size() + 2 * (K // group) * N * 4
        b, _ = bound_ms(nb, GQ_OPS * K * N)
        log("kernel_time", kernel="group_quant", shape=list(shape),
            dtype=str(dt), ms=t, plain_ms=p, bound_ms=b)
    # transform_quant at opt-1.3b's shapes for each kind of pi: ms (CUDA
    # events, one call), device ms (the kernel alone, under the profiler),
    # bound and the share of it by device time; the kernels line carries
    # the random pi (the search's proposals)
    per_pi = {}
    for mode, w in w_tq.items():
        K, N = w.shape
        plan = tq.plan(K, N, group, mode)
        fq, s, z = torch.empty_like(w), *(torch.empty((K // group, N), device=dev)
                                           for _ in range(2))
        svec = sv if mode == "up" else 1.0 / sv
        cos, sin = torch.cos(phi), torch.sin(phi)
        b, _ = bound_ms(tq_bytes(K, N, group, F), TQ_OPS * K * N)
        for kind in PI_KINDS:
            kpi = make_pi(torch, kind, F, gen, dev)

            def run():
                tq.launch(w, kpi, svec, cos, sin, fq, s, z, bits=bits,
                          group=group, mode=mode, plan=plan)
            t, spread = time_stats(torch, run)
            dm = device_ms(torch, run, ("transform_quant",))
            p = time_ms(torch, lambda: ref.transform_quant_ref(
                w, kpi, sv, phi, bits=bits, group=group, mode=mode))
            per_pi[f"{mode}/{kind}"] = dict(
                ms=t, ms_range=spread, device_ms=dm, plain_ms=p, bound_ms=b,
                share_of_bound=b / dm)
            log("kernel_time", kernel="transform_quant", mode=mode, pi=kind,
                shape=[K, N], plan=plan._asdict(), ms=t, ms_range=spread,
                device_ms=dm, plain_ms=p, bound_ms=b, share_of_bound=b / dm)
    rand = [per_pi[f"{mode}/random"] for mode in w_tq]
    rows["transform_quant"] = dict(
        **{k: sum(r[k] for r in rand) for k in ("ms", "device_ms", "plain_ms",
                                                "bound_ms")},
        bound_by="bytes",
        per="one candidate at a random pi: up (2048, 8192) + down "
            "(8192, 2048)",
        plans={mode: tq.plan(*w.shape, group, mode)._asdict()
               for mode, w in w_tq.items()},
        per_pi=per_pi, dtype="float32")
    for name in rows:
        rows[name]["max_abs_err"] = errs[name]
    return rows


def histories_agree(ha, hb, what):
    """Compare two search histories (hb is the yardstick): losses rtol 1e-5
    and accept flags wherever |delta| > 1e-5 |loss|; a flip on a near tie
    ends the comparison (the trajectories legitimately part there).
    Returns (steps compared, step where they parted or None)."""
    cur = hb[0][1]
    compared = 0
    for (sa, la, _, _, aa), (sb, lb, _, _, ab) in zip(ha, hb):
        if sa != sb:
            raise AssertionError(f"{what}: history steps differ")
        if abs(la - lb) > 1e-5 * abs(lb):
            raise AssertionError(f"{what}: step {sb} loss {la} vs {lb}")
        if aa != ab:
            if abs(lb - cur) > 1e-5 * abs(lb):
                raise AssertionError(f"{what}: step {sb} accept flags differ")
            return compared, sb
        if sb > 0 and ab:
            cur = lb
        compared += 1
    return compared, None


def phase_small_reference(torch):
    """The main path on the card against the same path on the CPU, where
    every kernel wrapper runs its plain version: opt-tiny, same weights,
    same tokens, same proposals (drawn on the CPU, then moved)."""
    from repro_torch.configs import get_config
    from repro_torch.core import invariance as inv
    from repro_torch.core import rtn
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.quant import QuantConfig, fake_quant
    from repro_torch.core.search import SearchConfig
    from repro_torch.data.calib import calibration_tensor
    from repro_torch.models.model import init_params, quantizable_paths
    from repro_torch.search import run

    cfg = get_config("opt-tiny").reduced(n_kv_heads=4)
    qcfg = QuantConfig(bits=2, group_size=32)
    cpu_params = init_params(cfg, torch.Generator().manual_seed(7),
                             device="cpu")
    cpu_calib = calibration_tensor(cfg.vocab_size, n_seqs=2, seq_len=64,
                                   device="cpu")

    def to(tree, d):
        return {k: to(v, d) if isinstance(v, dict) else v.to(d)
                for k, v in tree.items()}

    class Proposals:          # CPU draws, handed over on the run's device
        def __init__(self, d):
            self.src, self.d = inv.NativeProposals(3, "cpu"), d

        def __call__(self, t_u, k, pcfg):
            t_cpu = inv.FFNTransform(*(x.cpu() for x in t_u))
            return [inv.FFNTransform(*(x.to(self.d) for x in c))
                    for c in self.src(t_cpu, k, pcfg)]

    runs = {}
    for d in (torch.device("cpu"), torch.device("cuda")):
        params = to(cpu_params, d)
        rtn_q = quantize_model(params, cfg, qcfg, "rtn", device=d).params_q
        base = rtn.map_quantizable(params, lambda w, p: fake_quant(w, qcfg),
                                   only=lambda p: p[-1] not in ("up", "down"))
        res = run(params, base, cfg, qcfg, cpu_calib.to(d),
                  SearchConfig(steps=LANE_STEPS, fused_kernel=True,
                               log_every=0), proposals=Proposals(d))
        runs[d.type] = (rtn_q, res.history)
    rtn_err = 0.0
    for path in quantizable_paths(cpu_params):
        card = rtn.get_by_path(runs["cuda"][0], path).cpu()
        cpu = rtn.get_by_path(runs["cpu"][0], path)
        if not torch.equal(card, cpu):   # same fp32 operations on both
            raise AssertionError(f"RTN {path}: card differs from the CPU "
                                 f"(max abs {float((card - cpu).abs().max())})")
        rtn_err = max(rtn_err, float((card - cpu).abs().max()))
    compared, parted = histories_agree(runs["cuda"][1], runs["cpu"][1],
                                       "card vs CPU")
    log("small_reference", arch="opt-tiny (reduced)", steps=LANE_STEPS,
        rtn_max_abs_err=rtn_err, compared=compared, parted_at=parted,
        card_losses=[h[1] for h in runs["cuda"][1]],
        cpu_losses=[h[1] for h in runs["cpu"][1]])


def profile_search(torch, params, cfg, qcfg, calib):
    """Device time by kernel family (``torch.profiler``) over one call of
    ``repro_torch.search.run`` with PROFILE_STEPS fused steps, its set-up
    included (FP reference forward, initial fake-quant stack and its
    evaluation), after a one-step warm-up. Attention weights are frozen at
    their RTN values, as ``quantize_model`` does."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import rtn
    from repro_torch.core.quant import fake_quant
    from repro_torch.core.search import SearchConfig
    from repro_torch.search import run

    base = rtn.map_quantizable(params, lambda w, p: fake_quant(w, qcfg),
                               only=lambda p: p[-1] not in ("up", "down"))

    def search(steps):
        return run(params, base, cfg, qcfg, calib,
                   SearchConfig(steps=steps, fused_kernel=True, log_every=0))

    search(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = search(PROFILE_STEPS)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_family = defaultdict(float)
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if t > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            low = ev.key.lower()
            fam = next((f for frag, f in FAMILIES if frag in low), "other")
            by_family[fam] += t / 1e3
    device_ms = sum(by_family.values())
    return dict(steps=PROFILE_STEPS,
                proposals_per_sec=res.stats["proposals_per_sec"],
                window_wall_ms=wall_ms, device_kernel_ms=device_ms,
                device_busy_share=device_ms / wall_ms,
                by_family_ms=dict(sorted(by_family.items(),
                                         key=lambda kv: -kv[1])))


# ---------------------------------------------------------------------------
# phase 5: paged serving
# ---------------------------------------------------------------------------

PD_TOL = dict(rtol=1e-5, atol=1e-5)
PD_ROUTES = ("paged_decode", "paged_decode_gqa", "paged_decode_gqa_mp")
PSZ = 16
SERVE = dict(max_batch=8, page_size=PSZ, n_pages=96, max_len=128)
TRACE = dict(n_tenants=8, per_tenant=3, page_size=PSZ, max_new=8)
NEAR_TIE = 1e-4          # relative top-2 logit gap under which tokens may part


def paged_case(torch, *, B, H, Hkv, Dh, P, lens, dtype, seed, psz=PSZ):
    """Card tensors for one paged-decode call: random pools (f32, bf16, or
    int8 + f32 scales), distinct block tables, lengths ``lens``."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    n_pages = B * P + 1
    q = torch.randn((B, H, Dh), generator=g, device=dev)
    kp = torch.randn((n_pages, psz, Hkv, Dh), generator=g, device=dev)
    vp = torch.randn((n_pages, psz, Hkv, Dh), generator=g, device=dev)
    ks = vs = None
    if dtype == torch.int8:
        c127 = torch.tensor(127.0, device=dev)
        ks = kp.abs().amax(-1) / c127 + 1e-8
        vs = vp.abs().amax(-1) / c127 + 1e-8
        kp = torch.round(kp / ks[..., None]).to(torch.int8)
        vp = torch.round(vp / vs[..., None]).to(torch.int8)
    else:
        kp, vp = kp.to(dtype), vp.to(dtype)
    bt = (torch.randperm(n_pages - 1, generator=g, device=dev)[: B * P]
          + 1).reshape(B, P).int()
    return [q, kp, vp, bt, torch.tensor(lens, dtype=torch.int32, device=dev),
            ks, vs]


def route_kw(route, mp=2):
    return {"paged_decode": dict(fused_gqa=False),
            "paged_decode_gqa": {},
            "paged_decode_gqa_mp": dict(gqa_pages_per_block=mp)}[route]


# 5a cases: (name, B, H, Hkv, Dh, psz, P, length sets, (route, MP) pairs).
# The first two are opt-1.3b's decode layout (MHA) and a full-width GQA one;
# "long-gqa" is a full-width GQA layout long enough that the planner splits
# the pages across CTAs on every route (runs past the 333-token sequence's
# end are empty, a zero-length sequence merges to exactly 0); the last two
# are the layouts 5d serves (opt-tiny reduced at max_batch 4, page size 8,
# max_len 64).
_GQA_ROUTES = (("paged_decode", 1), ("paged_decode_gqa", 1),
               ("paged_decode_gqa_mp", 2))
_LENS_8 = [0, 1, PSZ, 2 * PSZ + 5, 8 * PSZ, 37, 3 * PSZ, 100]
_LENS_SMALL = ([0, 1, 16, 64], [37, 8, 5, 63])
PD_LAYOUTS = (
    ("mha", 8, 32, 32, 64, PSZ, 8, (_LENS_8,), (("paged_decode", 1),)),
    ("gqa", 8, 32, 8, 128, PSZ, 8, (_LENS_8,),
     _GQA_ROUTES + (("paged_decode_gqa_mp", 4),)),
    ("long-gqa", 2, 32, 8, 128, PSZ, 64, ([1024, 333], [0, 1000]),
     (("paged_decode", 1), ("paged_decode_gqa", 1),
      ("paged_decode_gqa_mp", 2), ("paged_decode_gqa_mp", 4))),
    ("small-gqa", 4, 4, 2, 16, 8, 8, _LENS_SMALL, _GQA_ROUTES),
    ("small-mha", 4, 4, 4, 16, 8, 8, _LENS_SMALL, (("paged_decode", 1),)),
)


def n_split(torch, pd, route, B, H, Hkv, P, psz, mp):
    """Runs the planner cuts each sequence into (its CTAs span the query
    heads on the per-query-head route, the KV heads on the others)."""
    heads = H if route == "paged_decode" else Hkv
    return pd.plan(route, B, heads, P, psz, mp,
                   pd.sm_count(torch.device("cuda"))).n_split


def phase_paged_kernels(torch, ops, ref, pd):
    """5a: every route vs the plain version on the card at each layout of
    ``PD_LAYOUTS``. Returns the max abs error per route."""
    errs = dict.fromkeys(PD_ROUTES, 0.0)
    for name, B, H, Hkv, Dh, psz, P, lens_sets, routes in PD_LAYOUTS:
        shape = dict(B=B, H=H, Hkv=Hkv, Dh=Dh, P=P, psz=psz)
        splits = {(r, mp): n_split(torch, pd, r, B, H, Hkv, P, psz, mp)
                  for r, mp in routes}
        if name == "long-gqa" and min(splits.values()) < 2:
            raise AssertionError(f"{name}: the planner did not split {splits}")
        for lens in lens_sets:
            for dt in (torch.float32, torch.bfloat16, torch.int8):
                args = paged_case(torch, lens=lens, dtype=dt, seed=5, **shape)
                want = ref.paged_decode_ref(*args)
                want_p = ref.paged_decode_ref(*args, normalize=False)
                for route, mp in routes:
                    kw = route_kw(route, mp)
                    before = ops.LAUNCHES[route]
                    got = ops.paged_decode(*args, **kw)
                    got_p = ops.paged_decode(*args, normalize=False, **kw)
                    torch.cuda.synchronize()
                    if ops.LAUNCHES[route] != before + 2:
                        raise AssertionError(f"{route} did not launch")
                    err = 0.0
                    for g_, w_ in zip((got,) + tuple(got_p), (want,) + want_p):
                        torch.testing.assert_close(g_, w_, **PD_TOL)
                        err = max(err, float((g_ - w_).abs().max()))
                    if 0 in lens and got[lens.index(0)].any():
                        raise AssertionError(f"{route}: empty sequence not 0")
                    errs[route] = max(errs[route], err)
                    log("kernel_check", kernel=route, layout=name,
                        heads=[H, Hkv], head_dim=Dh, page_size=psz, batch=B,
                        dtype=str(dt), pages_per_block=mp, lens=lens,
                        n_split=splits[route, mp], max_abs_err=err)
            # NaN in every slot past each length (and the null page)
            args = paged_case(torch, lens=lens, dtype=torch.float32, seed=6,
                              **shape)
            want = ref.paged_decode_ref(*args)
            q, kp, vp, bt, ln = args[:5]
            pos = torch.arange(P * psz, device=q.device).reshape(P, psz)
            for b in range(B):
                dead = pos >= ln[b]
                for p in range(P):
                    kp[bt[b, p], dead[p]] = float("nan")
                    vp[bt[b, p], dead[p]] = float("nan")
            kp[0] = vp[0] = float("nan")
            for route, mp in routes:
                got = ops.paged_decode(*args, **route_kw(route, mp))
                if torch.isnan(got).any():
                    raise AssertionError(f"{route}: a poisoned slot was read")
                torch.testing.assert_close(got, want, **PD_TOL)
                err = float((got - want).abs().max())
                errs[route] = max(errs[route], err)
                log("kernel_check", kernel=route, layout=name,
                    case="nan-poisoned dead slots", page_size=psz,
                    pages_per_block=mp, lens=lens,
                    n_split=splits[route, mp], max_abs_err=err)
    return errs


def paged_bytes(q, kp, ks, lens, H, Hkv):
    """Bytes a paged decode must move: each live K/V row of each KV head
    (and its scales) read once, q read once, out + (m, l) written once."""
    Dh = q.shape[-1]
    live = int(sum(int(n) for n in lens))
    row = Hkv * Dh * kp.element_size() + (Hkv * 4 if ks is not None else 0)
    return (2 * live * row + q.numel() * 4 + q.numel() * 4
            + 2 * q.shape[0] * H * 4 + 4 * len(lens) * 2)


# 5b contexts: (name, B, lengths or None for the trace's decode lengths).
# "long-b1" is one user decoding a long context: the same live K/V bytes
# as "long", one sequence.
PD_CONTEXTS = (("decode", 8, None), ("long", 8, [1024] * 8),
               ("long-b1", 1, [8192]))


# device-kernel name fragments of every route's launch: the split pass and,
# where the planner splits, the merge
PD_KERNEL_NAMES = ("split_decode::split_kernel", "split_decode::merge_kernel")


def sdpa_takes_gqa(torch) -> bool:
    """Whether this torch's ``scaled_dot_product_attention`` has
    ``enable_gqa`` (torch 2.5 on)."""
    major, minor = (int(x) for x in torch.__version__.split(".")[:2])
    return (major, minor) >= (2, 5)


def phase_paged_times(torch, ops, ref, pd, decode_lens):
    """5b: CUDA-event medians (and the run's spread) of each route at the
    main path's decode shape (B 8, psz 16, the trace's lengths; MHA 32 heads
    Dh 64 for the per-query-head route, 32/8 heads Dh 128 for the GQA
    routes), at a long context (B 8 x 1024 tokens) and at one long
    sequence (B 1 x 8192), beside the bound, the plain version
    and two SDPA yardsticks on K/V already gathered contiguous: K/V
    repeated to H heads, and (where this torch takes ``enable_gqa``) K/V as
    they are; ``library_ms`` is the faster. Each raw ``pd.launch`` is the
    whole decode: split pass and merge, with the planner's ``n_split``.
    Beside the CUDA-event time of one
    call (host launch work included), ``device_ms`` is the route's kernels'
    own time under the profiler."""
    import torch.nn.functional as F
    rows = {}
    gqa_ok = sdpa_takes_gqa(torch)
    for route in PD_ROUTES:
        H, Hkv, Dh = (32, 32, 64) if route == "paged_decode" else (32, 8, 128)
        mp = 2 if route == "paged_decode_gqa_mp" else 1
        per = {}
        for ctx, B, lens in PD_CONTEXTS:
            lens = lens or decode_lens
            P = -(-max(lens) // PSZ)
            q, kp, vp, bt, ln, ks, vs = paged_case(
                torch, B=B, H=H, Hkv=Hkv, Dh=Dh, P=P, lens=lens,
                dtype=torch.float32, seed=7)
            out = torch.empty((B, H, Dh), device=q.device)
            m = torch.empty((B, H), device=q.device)
            l_ = torch.empty_like(m)
            t, spread = time_stats(torch, lambda: pd.launch(
                route, q, kp, vp, bt, ln, None, None, out, m, l_,
                normalize=True, pages_per_block=mp), reps=50)
            dev = device_ms(torch, lambda: pd.launch(
                route, q, kp, vp, bt, ln, None, None, out, m, l_,
                normalize=True, pages_per_block=mp), PD_KERNEL_NAMES)
            p = time_ms(torch, lambda: ref.paged_decode_ref(q, kp, vp, bt, ln),
                        reps=20)
            # yardsticks: SDPA over K/V already gathered contiguous (B, Hkv,
            # S, Dh) with a boolean length mask; gather and head repeat
            # excluded from the time
            S = P * PSZ
            kc = kp[bt.long()].reshape(B, S, Hkv, Dh).transpose(1, 2)
            vc = vp[bt.long()].reshape(B, S, Hkv, Dh).transpose(1, 2)
            mask = (torch.arange(S, device=q.device)[None, :]
                    < ln[:, None])[:, None, None, :]
            qs = q[:, :, None, :]
            lib_gqa = None
            if H > Hkv and gqa_ok:
                kg, vg = kc.contiguous(), vc.contiguous()
                lib_gqa = time_ms(torch, lambda: F.scaled_dot_product_attention(
                    qs, kg, vg, attn_mask=mask, enable_gqa=True), reps=50)
                del kg, vg
            kr = kc.repeat_interleave(H // Hkv, 1).contiguous()
            vr = vc.repeat_interleave(H // Hkv, 1).contiguous()
            lib_rep = time_ms(torch, lambda: F.scaled_dot_product_attention(
                qs, kr, vr, attn_mask=mask), reps=50)
            del kr, vr, kc, vc
            b, by = bound_ms(paged_bytes(q, kp, ks, lens, H, Hkv),
                             4 * H * Dh * sum(lens))
            per[ctx] = dict(
                ms=t, ms_range=spread, plain_ms=p,
                library_ms=min(x for x in (lib_rep, lib_gqa) if x is not None),
                sdpa_repeated_ms=lib_rep, sdpa_enable_gqa_ms=lib_gqa,
                bound_ms=b, bound_by=by, share_of_bound=b / t,
                device_ms=dev, device_share_of_bound=b / dev, batch=B,
                heads=[H, Hkv], head_dim=Dh, lens=lens, pages_per_block=mp,
                n_split=n_split(torch, pd, route, B, H, Hkv, P, PSZ, mp))
            log("kernel_time", kernel=route, context=ctx, **per[ctx])
            del q, kp, vp, bt, ln
        rows[route] = per
    return rows


# what the kernels line carries of each 5b context past the decode shape
PD_CTX_KEYS = ("ms", "ms_range", "device_ms", "plain_ms", "bound_ms",
               "library_ms", "sdpa_repeated_ms", "sdpa_enable_gqa_ms",
               "share_of_bound", "device_share_of_bound", "n_split")


def gqa_vs_sdpa(rows):
    """One line per GQA route and long context: the kernel's time against
    the faster SDPA yardstick of the same run, and its share of the bound
    (a report, not a check: times are no correctness bar)."""
    for route in PD_ROUTES[1:]:
        for ctx in ("long", "long-b1"):
            r = rows[route][ctx]
            log("gqa_vs_sdpa", kernel=route, context=ctx,
                **{k: r[k] for k in PD_CTX_KEYS},
                faster=r["ms"] < r["library_ms"])


def to_device(tree, dev):
    """A param tree (dict of tensors and QTensors) moved to ``dev``."""
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def check_greedy(torch, forward, dense, cfg, reqs, outs, what):
    """Hold each request's tokens to the greedy oracle (one full forward
    over prompt + generated tokens, dense weights): a token may differ from
    the oracle's argmax only where the oracle's top-2 gap is < NEAR_TIE of
    the top logit, and that request's comparison ends there. Returns the
    near ties met as (request, position, relative gap)."""
    ties = []
    V = cfg.vocab_size
    for i, (r, out) in enumerate(zip(reqs, outs)):
        seq = torch.tensor([list(r.prompt) + out[:-1]], device="cuda")
        logits = forward(dense, cfg, seq)[0, len(r.prompt) - 1:, :V]
        top2 = torch.topk(logits, 2, dim=-1).values
        gap = ((top2[:, 0] - top2[:, 1]) / top2[:, 0].abs()).tolist()
        pred = torch.argmax(logits, dim=-1).tolist()
        for j, (tok, want) in enumerate(zip(out, pred)):
            if tok != want:
                if gap[j] >= NEAR_TIE:
                    raise AssertionError(
                        f"{what}: request {i} token {j} = {tok}, oracle "
                        f"{want}, top-2 gap {gap[j]:.3g} (not a near tie)")
                ties.append((i, j, gap[j]))
                break
    return ties


def compare_runs(outs_a, outs_b, ties_ok, what):
    """Runs token-identical, or parting only at a near tie of the oracle
    (positions listed in ``ties_ok``)."""
    parts = []
    for i, (a, b) in enumerate(zip(outs_a, outs_b)):
        if a == b:
            continue
        j = next(k for k, (x, y) in enumerate(zip(a, b)) if x != y)
        if (i, j) not in ties_ok:
            raise AssertionError(f"{what}: request {i} parts at token {j} "
                                 f"without a near tie")
        parts.append((i, j))
    return parts


# device-kernel name fragments -> family for the serving profile (first
# match wins); the paged routes run the kernel body of
# csrc/split_decode.cuh; cuBLAS takes GEMV kernels at B <= 8
SERVE_FAMILIES = (("split_decode", "paged_decode (port kernel)"),
                  ("paged_decode", "paged_decode (port kernel)"),
                  ("gemv", "matmul (cuBLAS)"),
                  ("index", "indexing (gather, K/V write)"),
                  ("memcpy", "copies"), ("memset", "copies")) + FAMILIES


def _family(name, families):
    low = name.lower()
    return next((f for frag, f in families if frag in low), "other")


def _inside(ev, name):
    """Whether profiler event ``ev`` lies inside a range called ``name``."""
    ev = ev.cpu_parent
    while ev is not None:
        if ev.name == name:
            return True
        ev = ev.cpu_parent
    return False


def profile_serving(torch, obs, server, reqs):
    """Device time of one serving run (``server.generate(reqs)``) under
    ``torch.profiler``, with the batcher's spans as profiler ranges. A
    device kernel belongs to the decode step or prefill span whose
    device-side range (the profiler's copy of the span on the GPU's clock,
    from its first kernel to its last) holds its start; without those, to
    the span's host range (each decode step ends in a host sync, so its
    kernels run inside it). The per-layer dequant is the device time of the
    kernels launched inside the ``serve.dequant`` ranges of the decode
    steps. Returns (report, the run's outputs)."""
    from torch.profiler import ProfilerActivity, profile

    spans = ("serve.decode_step", "serve.prefill")
    torch.cuda.synchronize()
    obs.enable_profiler(True)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            outs = server.generate(reqs)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        obs.enable_profiler(False)
    host = {n: [] for n in spans}
    device = {n: [] for n in spans}
    kernels = []
    dequant_us = 0.0
    for ev in prof.events():
        rng = (ev.time_range.start, ev.time_range.end)
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            if ev.name in device:
                device[ev.name].append(rng)
            elif not ev.name.startswith("serve."):
                kernels.append((rng[0], rng[1] - rng[0], ev.name))
        elif ev.name in host:
            host[ev.name].append(rng)
        elif ev.name == "serve.dequant" and _inside(ev, spans[0]):
            dequant_us += ev.device_time_total
    out = {}
    for n in spans:
        ws = device[n] or host[n]
        by_family = defaultdict(float)
        n_kernels = 0
        for start, dur, name in kernels:
            if any(a <= start <= b for a, b in ws):
                by_family[_family(name, SERVE_FAMILIES)] += dur / 1e3
                n_kernels += 1
        out[n] = dict(spans=len(host[n]),
                      windows="device" if device[n] else "host",
                      host_ms=sum(b - a for a, b in host[n]) / 1e3,
                      device_ms=sum(by_family.values()), kernels=n_kernels,
                      by_family_ms=dict(sorted(by_family.items(),
                                               key=lambda kv: -kv[1])))
    out["serve.decode_step"]["dequant_device_ms"] = dequant_us / 1e3
    return dict(wall_ms=wall_ms,
                device_ms=sum(d for _, d, _ in kernels) / 1e3, **out), outs


def packed_opt(torch, cfg):
    """Random-init ``cfg`` packed at 2 bits / group 32 on the card (the
    weights phases 5c and 6c serve), and the seconds it took."""
    from repro_torch.core.quant import QuantConfig
    from repro_torch.models.model import init_params
    from repro_torch.quantized.qmodel import pack_model

    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    params_q = pack_model(params, QuantConfig(bits=2, group_size=32))
    del params
    torch.cuda.synchronize()
    return params_q, time.perf_counter() - t0


def phase_serving(torch, ops, kernel_rows, cfg, params_q, setup_s):
    """5c: PagedServer on 2-bit opt-1.3b over the 8-tenant trace, prefix
    sharing off then on."""
    from repro_torch import obs
    from repro_torch.launch.serve import PagedServer, Request
    from repro_torch.models.model import dequant_tree, forward
    from repro_torch.quantized.qmodel import dense_bytes, packed_bytes
    from repro_torch.serving import build_trace

    trace = build_trace(cfg.vocab_size, **TRACE)
    reqs = [Request(**t) for t in trace]
    reg = obs.get_registry()
    runs = {}
    for sharing in (False, True):
        server = PagedServer(params_q, cfg, prefix_cache=sharing,
                             device="cuda", **SERVE)
        reg.reset()
        torch.cuda.synchronize()
        live_before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        outs = server.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        st = dict(server.batcher.stats)
        alloc = server.cache.allocator
        if alloc.num_free != alloc.n_pages - alloc.reserved:
            raise AssertionError(f"sharing={sharing}: leaked pages")
        if counts["paged_decode"] != cfg.n_layers * st["steps"] or \
                counts["paged_decode_gqa"] or counts["paged_decode_gqa_mp"]:
            raise AssertionError(f"paged-decode launches {counts} != "
                                 f"{cfg.n_layers} x {st['steps']} steps")
        snap = reg.snapshot()

        def total(name):
            return sum(s.get("value", s.get("count", 0))
                       for s in snap[name]["series"])

        obs_vs_stats = {
            "serving_prefill_tokens_total": st["prefill_tokens"],
            "serving_prefill_tokens_saved_total": st["prefill_tokens_saved"],
            "serving_aliased_pages_total": st["aliased_pages"],
            "serving_dedup_admits_total": st["dedup_admits"],
            "serving_cow_forks_total": st["cow_forks"],
            "serving_decode_steps_total": st["steps"],
            "serving_preemptions_total": st["evictions"],
            "serving_ttft_seconds": len(reqs)}
        for name, want in obs_vs_stats.items():
            got = total(name) if name in snap else 0
            if got != want:
                raise AssertionError(f"obs {name} = {got} != {want}")
        tpot = snap["serving_tpot_seconds"]["series"][0]
        rep = server.sharing_report()
        runs[sharing] = dict(outs=outs, wall=wall, counts=counts, stats=st,
                             report=rep, step_ms=1e3 * tpot["sum"] / tpot["count"],
                             peak=torch.cuda.max_memory_allocated(),
                             live_before=live_before,
                             pool=server.cache.pool_bytes(),
                             tokens=sum(len(o) for o in outs))
        del server
    dense = dequant_tree(params_q)             # the oracle's weights
    ties = {s: check_greedy(torch, forward, dense, cfg, reqs, runs[s]["outs"],
                            f"sharing={s} vs oracle") for s in runs}
    parted = compare_runs(runs[False]["outs"], runs[True]["outs"],
                          {(i, j) for t in ties.values() for i, j, _ in t},
                          "sharing off vs on")
    if runs[True]["report"]["saved_frac"] < 0.5:
        raise AssertionError(f"saved_frac {runs[True]['report']['saved_frac']}")
    del dense
    # where one decode step's time goes: a third sharing-on run of the
    # trace under torch.profiler, read against the unprofiled run's steps
    on = runs[True]
    prof, prof_outs = profile_serving(torch, obs, PagedServer(
        params_q, cfg, prefix_cache=True, device="cuda", **SERVE), reqs)
    prof["outputs_as_sharing_on"] = prof_outs == on["outs"]
    dec = prof["serve.decode_step"]
    n = dec["spans"]
    pd_ms = dec["by_family_ms"].get("paged_decode (port kernel)", 0.0) / n
    deq_ms = dec["dequant_device_ms"] / n
    dev_ms = dec["device_ms"] / n
    split = dict(
        step_ms=on["step_ms"], profiled_step_ms=dec["host_ms"] / n,
        device_ms=dev_ms, dequant_ms=deq_ms,
        dequant_per_layer_ms=deq_ms / cfg.n_layers, paged_decode_ms=pd_ms,
        other_device_ms=dev_ms - deq_ms - pd_ms,
        device_idle_ms=on["step_ms"] - dev_ms,
        device_busy_share=dev_ms / on["step_ms"],
        by_family_ms={k: v / n for k, v in dec["by_family_ms"].items()},
        steps=n, kernel_5b_ms=kernel_rows["paged_decode"]["decode"]["ms"])
    log("serving_profile", **prof)
    for s, r in runs.items():
        log("serving", arch=cfg.name, prefix_cache=s, requests=len(reqs),
            tokens=r["tokens"], wall_s=r["wall"],
            tokens_per_s=r["tokens"] / r["wall"],
            ttft_p50_s=r["report"]["ttft_p50_s"],
            ttft_p99_s=r["report"]["ttft_p99_s"],
            saved_frac=r["report"]["saved_frac"], stats=r["stats"],
            launches=r["counts"], step_ms=r["step_ms"], peak_bytes=r["peak"],
            live_bytes_at_start=r["live_before"],
            pool_bytes=r["pool"], near_ties=ties[s])
    log("serving_check", parted_at=parted, packed_bytes=packed_bytes(params_q),
        dense_bytes=dense_bytes(params_q), setup_s=setup_s,
        outputs_identical=not parted)
    log("decode_step_split", **split)
    return on["counts"], split


def phase_small_serving(torch, ops):
    """5d: the serving CLI's default config (opt-tiny reduced: GQA 4/2),
    the same with 2 pages per update, and an MHA variant, on the card and
    on the CPU with the same packed weights and requests."""
    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.launch.serve import PagedServer, Request
    from repro_torch.models.model import init_params
    from repro_torch.quantized.qmodel import pack_model
    from repro_torch.serving import build_trace

    launches = {}
    for name, over, mp, route in (
            ("gqa", {}, 1, "paged_decode_gqa"),
            ("gqa-mp2", {}, 2, "paged_decode_gqa_mp"),
            ("mha", dict(n_kv_heads=4), 1, "paged_decode")):
        cfg = get_config("opt-tiny").reduced(**over)
        params_q = pack_model(init_params(
            cfg, torch.Generator().manual_seed(3), device="cpu"),
            QuantConfig(bits=2, group_size=32))
        trace = build_trace(cfg.vocab_size, n_tenants=4, per_tenant=2,
                            page_size=8, max_new=6)
        res = {}
        for dev in ("cpu", "cuda"):
            server = PagedServer(to_device(params_q, dev), cfg, max_batch=4,
                                 page_size=8, n_pages=64, max_len=64,
                                 gqa_pages_per_block=mp, device=dev)
            ops.reset_launch_counts()
            outs = server.generate([Request(**t) for t in trace])
            res[dev] = (outs, dict(server.batcher.stats), dict(ops.LAUNCHES))
        if res["cuda"][0] != res["cpu"][0]:
            raise AssertionError(f"{name}: card tokens differ from the CPU's")
        if res["cuda"][1] != res["cpu"][1]:
            raise AssertionError(f"{name}: batcher stats differ")
        counts = res["cuda"][2]
        if counts[route] != cfg.n_layers * res["cuda"][1]["steps"] or \
                any(counts[r] for r in PD_ROUTES if r != route) or \
                any(res["cpu"][2].values()):
            raise AssertionError(f"{name}: launches {counts}")
        launches[route] = counts[route]
        log("small_serving", config=name, heads=[cfg.n_heads, cfg.n_kv_heads],
            pages_per_block=mp, stats=res["cuda"][1], launches=counts,
            tokens_identical=True)
    return launches


# ---------------------------------------------------------------------------
# phase 6: contiguous-cache serving (BatchedServer) and quant_matmul
# ---------------------------------------------------------------------------

FD_TOL = dict(rtol=2e-4, atol=2e-4)   # tests/test_kernels.py flash_decode bar
QM_TOL = dict(rtol=5e-4, atol=5e-4)   # tests/test_kernels.py quant_matmul bar
LEGACY = dict(batch_size=8, max_len=128)
FD_TILE = 64                          # csrc/flash_decode.cu kTile
# 6a layouts: (name, B, H, Hkv, Dh, S): opt-1.3b's decode layout in 6c's
# 128-row cache, a full-width GQA one, and the layouts 6d serves
FD_LAYOUTS = (("mha", 8, 32, 32, 64, 128), ("gqa", 8, 32, 8, 128, 128),
              ("small-gqa", 4, 4, 2, 16, 64), ("small-mha", 4, 4, 4, 16, 64))


def flash_case(torch, *, B, S, H, Hkv, Dh, dtype, seed):
    """Card tensors for one flash-decode call: q and a random contiguous
    cache (f32, bf16, or int8 + f32 scales)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, H, Dh), generator=g, device=dev)
    k = torch.randn((B, S, Hkv, Dh), generator=g, device=dev)
    v = torch.randn((B, S, Hkv, Dh), generator=g, device=dev)
    ks = vs = None
    if dtype == torch.int8:
        c127 = torch.tensor(127.0, device=dev)
        ks = k.abs().amax(-1) / c127 + 1e-8
        vs = v.abs().amax(-1) / c127 + 1e-8
        k = torch.round(k / ks[..., None]).to(torch.int8)
        v = torch.round(v / vs[..., None]).to(torch.int8)
    else:
        k, v = k.to(dtype), v.to(dtype)
    return [q, k, v, ks, vs]


def phase_flash_kernels(torch, ops, ref):
    """6a: flash_decode vs its plain version at every layout of
    ``FD_LAYOUTS``, f32 / bf16 / int8 caches, kv_len 0, 1, a tile boundary,
    a ragged value and S, then NaN in every slot at or past kv_len (in the
    scales for int8). Returns the max abs error."""
    worst = 0.0
    for name, B, H, Hkv, Dh, S in FD_LAYOUTS:
        shape = dict(B=B, S=S, H=H, Hkv=Hkv, Dh=Dh)
        lens = (0, 1, FD_TILE, S // 2 + 7, S)
        for dt in (torch.float32, torch.bfloat16, torch.int8):
            args = flash_case(torch, dtype=dt, seed=8, **shape)
            err = 0.0
            for n in lens:
                want = ref.flash_decode_ref(*args, kv_len=n)
                before = ops.LAUNCHES["flash_decode"]
                got = ops.flash_decode(*args, kv_len=n)
                torch.cuda.synchronize()
                if ops.LAUNCHES["flash_decode"] != before + 1:
                    raise AssertionError("flash_decode did not launch")
                torch.testing.assert_close(got, want, **FD_TOL)
                if n == 0 and got.any():
                    raise AssertionError("flash_decode: kv_len 0 not 0")
                err = max(err, float((got - want).abs().max()))
            worst = max(worst, err)
            log("kernel_check", kernel="flash_decode", layout=name,
                heads=[H, Hkv], head_dim=Dh, batch=B, cache_rows=S,
                dtype=str(dt), kv_lens=list(lens), max_abs_err=err)
        for n in (1, S // 2 + 7):
            for dt in (torch.float32, torch.int8):
                args = flash_case(torch, dtype=dt, seed=9, **shape)
                want = ref.flash_decode_ref(*args, kv_len=n)
                poison = (3, 4) if dt == torch.int8 else (1, 2)
                for i in poison:       # int8 holds no NaN: poison the scales
                    args[i][:, n:] = float("nan")
                got = ops.flash_decode(*args, kv_len=n)
                if torch.isnan(got).any():
                    raise AssertionError("flash_decode read a slot past "
                                         "kv_len")
                torch.testing.assert_close(got, want, **FD_TOL)
                err = float((got - want).abs().max())
                worst = max(worst, err)
                log("kernel_check", kernel="flash_decode", layout=name,
                    case="nan past kv_len", dtype=str(dt), kv_len=n,
                    max_abs_err=err)
    return worst


def phase_flash_times(torch, ref, fd, decode_len):
    """6b: CUDA-event medians of the kernel (raw launches into a
    preallocated output) at 6c's decode shape (B 8, MHA 32 heads, Dh 64,
    f32, ``decode_len`` live rows of a 128-row cache) and at B 8 x 2048
    rows (opt-1.3b's max_seq_len), beside its bound, its plain version and
    ``scaled_dot_product_attention`` over the same cache (a transposed
    view, no copy) with a boolean length mask."""
    import torch.nn.functional as F
    rows = {}
    B, H, Hkv, Dh = 8, 32, 32, 64
    for ctx, S, n in (("decode", LEGACY["max_len"], decode_len),
                      ("long", 2048, 2048)):
        q, k, v, _, _ = flash_case(torch, B=B, S=S, H=H, Hkv=Hkv, Dh=Dh,
                                   dtype=torch.float32, seed=10)
        out = torch.empty((B, H, Dh), device=q.device)
        t, spread = time_stats(torch, lambda: fd.launch(
            q, k, v, None, None, out, kv_len=n), reps=50)
        dev = device_ms(torch, lambda: fd.launch(
            q, k, v, None, None, out, kv_len=n), ("decode_attention::",))
        p = time_ms(torch, lambda: ref.flash_decode_ref(q, k, v, kv_len=n),
                    reps=20)
        mask = (torch.arange(S, device=q.device) < n)[None, None, None, :]
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)
        lib = time_ms(torch, lambda: F.scaled_dot_product_attention(
            q[:, :, None, :], kt, vt, attn_mask=mask), reps=50)
        nbytes = 2 * B * n * Hkv * Dh * 4 + 2 * q.numel() * 4
        b, by = bound_ms(nbytes, 4 * B * H * Dh * n)
        rows[ctx] = dict(ms=t, ms_range=spread, device_ms=dev, plain_ms=p,
                         library_ms=lib, bound_ms=b, bound_by=by, batch=B,
                         heads=[H, Hkv], head_dim=Dh, cache_rows=S, kv_len=n)
        log("kernel_time", kernel="flash_decode", context=ctx, **rows[ctx])
    return rows


def padded_requests(Request, reqs, B):
    """What ``BatchedServer.generate`` feeds the model for ``reqs``: each
    batch of B left-padded with token 0 to its longest prompt."""
    import numpy as np
    out = []
    for i in range(0, len(reqs), B):
        chunk = reqs[i:i + B]
        plen = max(len(r.prompt) for r in chunk)
        out += [Request(prompt=np.pad(r.prompt, (plen - len(r.prompt), 0)),
                        max_new=r.max_new) for r in chunk]
    return out


LEGACY_FAMILIES = (("decode_attention", "flash_decode (port kernel)"),
                   ) + SERVE_FAMILIES


def legacy_step_profile(torch, server, params_q, padded, steps):
    """Host ms per decode step of ``server`` on its first batch (prefill,
    then ``steps`` steps ending in one synchronize), then the same window
    under ``torch.profiler``: device ms by kernel family over the prefill
    and the steps."""
    from torch.profiler import ProfilerActivity, profile

    B = server.B
    plen = len(padded[0].prompt)
    toks = torch.tensor([list(r.prompt) for r in padded[:B]], device="cuda")

    def run():
        logits, cache = server.prefill_fn(params_q, {"tokens": toks})
        tok = torch.argmax(logits[:, -1, :server.cfg.vocab_size],
                           dim=-1)[:, None]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(steps):
            tok, cache = server.step_fn(params_q, tok, cache, plen + t)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps

    step_ms = run()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    by_family = defaultdict(float)
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if t > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            by_family[_family(ev.key, LEGACY_FAMILIES)] += t / 1e3
    return step_ms, dict(sorted(by_family.items(), key=lambda kv: -kv[1]))


def phase_legacy_serving(torch, ops, cfg, params_q):
    """6c: BatchedServer on 2-bit opt-1.3b (full width and depth) over
    phase 5's 24-request trace, use_flash_decode off then on. Returns the
    flag-on run's flash_decode launches."""
    import dataclasses

    from repro_torch.launch.serve import BatchedServer, Request
    from repro_torch.models.model import dequant_tree, forward, init_cache
    from repro_torch.quantized.qmodel import cache_bytes
    from repro_torch.serving import build_trace

    reqs = [Request(**t) for t in build_trace(cfg.vocab_size, **TRACE)]
    B = LEGACY["batch_size"]
    padded = padded_requests(Request, reqs, B)
    n_batches = -(-len(reqs) // B)
    steps = n_batches * (TRACE["max_new"] - 1)
    cache = init_cache(cfg, B, LEGACY["max_len"], device="cuda")
    kv_bytes = cache_bytes(cache)
    del cache
    runs = {}
    for flash in (False, True):
        server = BatchedServer(params_q, dataclasses.replace(
            cfg, use_flash_decode=flash), device="cuda", **LEGACY)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        live_before = torch.cuda.memory_allocated()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        outs = server.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        want = cfg.n_layers * steps if flash else 0
        if counts["flash_decode"] != want or \
                any(v for k, v in counts.items() if k != "flash_decode"):
            raise AssertionError(f"use_flash_decode={flash}: launches "
                                 f"{counts}, expected flash_decode {want}")
        peak = torch.cuda.max_memory_allocated()
        step_ms, family = legacy_step_profile(torch, server, params_q,
                                              padded, TRACE["max_new"] - 1)
        runs[flash] = dict(outs=outs, wall=wall, counts=counts, peak=peak,
                           live_before=live_before, step_ms=step_ms,
                           family=family, tokens=sum(len(o) for o in outs))
        del server
    dense = dequant_tree(params_q)
    ties = {f: check_greedy(torch, forward, dense, cfg, padded,
                            runs[f]["outs"], f"use_flash_decode={f} vs "
                            f"oracle") for f in runs}
    del dense
    parted = compare_runs(runs[False]["outs"], runs[True]["outs"],
                          {(i, j) for t in ties.values() for i, j, _ in t},
                          "flash off vs on")
    for f, r in runs.items():
        log("serving_legacy", arch=cfg.name, use_flash_decode=f,
            requests=len(reqs), batches=n_batches, decode_steps=steps,
            tokens=r["tokens"], wall_s=r["wall"],
            tokens_per_s=r["tokens"] / r["wall"], step_ms=r["step_ms"],
            launches=r["counts"], cache_bytes=kv_bytes, peak_bytes=r["peak"],
            live_bytes_at_start=r["live_before"], near_ties=ties[f],
            profile_ms_by_family=r["family"],
            profile_window=f"prefill + {TRACE['max_new'] - 1} decode steps "
                           f"of batch 0")
    log("serving_legacy_check", parted_at=parted, outputs_identical=not parted,
        oracle="full forward over the dequantized weights on the "
               "left-padded prompts")
    return runs[True]["counts"]["flash_decode"]


def phase_small_legacy(torch, ops):
    """6d: BatchedServer on opt-tiny reduced (GQA 4/2 and MHA 4/4), compute
    and int8 KV, use_flash_decode on, on the card and on the CPU with the
    same packed weights and requests."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.launch.serve import BatchedServer, Request
    from repro_torch.models.model import init_params
    from repro_torch.quantized.qmodel import pack_model
    from repro_torch.serving import build_trace

    for n_kv in (2, 4):
        for kv_dtype in ("compute", "int8"):
            cfg = dataclasses.replace(
                get_config("opt-tiny").reduced(n_kv_heads=n_kv),
                kv_cache_dtype=kv_dtype, use_flash_decode=True)
            params_q = pack_model(init_params(
                cfg, torch.Generator().manual_seed(3), device="cpu"),
                QuantConfig(bits=2, group_size=32))
            trace = build_trace(cfg.vocab_size, n_tenants=4, per_tenant=2,
                                page_size=8, max_new=6)
            res = {}
            for dev in ("cpu", "cuda"):
                server = BatchedServer(to_device(params_q, dev), cfg,
                                       batch_size=4, max_len=64, device=dev)
                ops.reset_launch_counts()
                outs = server.generate([Request(**t) for t in trace])
                res[dev] = (outs, dict(ops.LAUNCHES))
            if res["cuda"][0] != res["cpu"][0]:
                raise AssertionError(f"opt-tiny {n_kv} KV heads {kv_dtype}: "
                                     f"card tokens differ from the CPU's")
            want = cfg.n_layers * 2 * (6 - 1)     # 2 batches of 5 steps
            counts = res["cuda"][1]
            if counts["flash_decode"] != want or \
                    any(v for k, v in counts.items() if k != "flash_decode") \
                    or any(res["cpu"][1].values()):
                raise AssertionError(f"small legacy launches {counts}")
            log("small_legacy", heads=[cfg.n_heads, n_kv], kv_cache=kv_dtype,
                launches=counts, tokens_identical=True)


# 6e cases: (name, M, K, N, bits, group)
QM_SHAPES = (
    ("kernel_bench 8x2048x2048 b2 g128", 8, 2048, 2048, 2, 128),
    ("kernel_bench 8x2048x2048 b4 g128", 8, 2048, 2048, 4, 128),
    ("kernel_bench 128x1024x1024 b2 g64", 128, 1024, 1024, 2, 64),
    ("opt-1.3b attn 2048->2048 b2 g32", 8, 2048, 2048, 2, 32),
    ("opt-1.3b up 2048->8192 b2 g32", 8, 2048, 8192, 2, 32),
    ("opt-1.3b down 8192->2048 b2 g32", 8, 8192, 2048, 2, 32),
    ("3-bit, K padded 2048->2080, b3 g32", 8, 2048, 2048, 3, 32),
)
QM_MAIN = "opt-1.3b up 2048->8192 b2 g32"
# what the kernels line carries of every 6e case
QM_CASE_KEYS = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "library_device_ms", "device_share_of_bound",
                "faster_than_library", "plan")


def phase_quant_matmul(torch, ops, ref, qm):
    """6e: quant_matmul vs its plain version at every ``QM_SHAPES`` case,
    x in f32 and bf16; times (f32 x, raw launches: the split pass and the
    sum of its partials) beside the bound, the plain version and
    ``torch.matmul`` with W already dequantised to dense f32, each as the
    CUDA-event time of one call (``ms``, ``library_ms``) and as its kernels'
    own time under the profiler (``device_ms``, ``library_device_ms``);
    then the public op once per case, counts set to 0 just before.
    Returns (rows, max abs error, public-op launches)."""
    from repro_torch.core.quant import QuantConfig, quantize_tensor

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(12)
    worst = 0.0
    rows = {}
    cases = []
    for name, M, K, N, bits, group in QM_SHAPES:
        qt = quantize_tensor(torch.randn((K, N), generator=gen, device=dev),
                             QuantConfig(bits=bits, group_size=group))
        x = torch.randn((M, K), generator=gen, device=dev)
        w = (qt.packed, qt.scale, qt.zero)
        k_pad = qt.packed.shape[0] * (32 // bits)
        cases.append((name, x, w, bits, group))
        for dt in (torch.float32, torch.bfloat16):
            xd = x.to(dt)
            got = ops.quant_matmul(xd, *w, bits=bits, group=group)
            want = ref.quant_matmul_ref(xd, *w, bits, group)
            torch.testing.assert_close(got, want, **QM_TOL)
            err = float((got - want).abs().max())
            worst = max(worst, err)
            log("kernel_check", kernel="quant_matmul", case=name,
                shape=[M, K, N], k_pad=k_pad, bits=bits, group=group,
                dtype=str(dt), max_abs_err=err)
        out = torch.empty((M, N), device=dev)

        def run():
            qm.launch(x, *w, out, bits=bits, group=group)
        t = time_ms(torch, run, reps=50)
        dev_t = device_ms(torch, run, ("quant_matmul",), calls=30)
        p = time_ms(torch, lambda: ref.quant_matmul_ref(x, *w, bits, group),
                    reps=20)
        dense = ref.dequant_ref(*w, bits, group, K)
        lib = time_ms(torch, lambda: torch.matmul(x, dense), reps=50)
        # every kernel the library call runs (cuBLAS names them by shape)
        lib_dev = device_ms(torch, lambda: torch.matmul(x, dense), ("",),
                            calls=30)
        nbytes = (x.numel() * 4 + qt.packed.numel() * 4
                  + 2 * qt.scale.numel() * 4 + M * N * 4)
        b, by = bound_ms(nbytes, 2 * M * K * N + 2 * k_pad * N)
        sp = qm.plan(M, N, qt.packed.shape[0], bits, group,
                     qm.sm_count(dev))
        rows[name] = dict(ms=t, device_ms=dev_t, plain_ms=p, library_ms=lib,
                          library_device_ms=lib_dev, bound_ms=b,
                          bound_by=by, device_share_of_bound=b / dev_t,
                          faster_than_library=dev_t < lib_dev,
                          shape=[M, K, N], bits=bits, group=group,
                          plan=sp._asdict(), dense_weight_bytes=K * N * 4)
        log("kernel_time", kernel="quant_matmul", case=name, **rows[name])
        del dense
    ops.reset_launch_counts()
    for name, x, w, bits, group in cases:
        out = ops.quant_matmul(x, *w, bits=bits, group=group)
        if tuple(out.shape) != (x.shape[0], w[0].shape[1]) or \
                not bool(torch.isfinite(out).all()):
            raise AssertionError(f"quant_matmul {name}: bad output")
    launches = ops.LAUNCHES["quant_matmul"]
    if launches != len(cases):
        raise AssertionError(f"quant_matmul public op launched {launches} "
                             f"times for {len(cases)} calls")
    return rows, worst, launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import get_config
    from repro_torch.core.objective import activation_mse, calib_ce
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.quant import QuantConfig
    from repro_torch.core.search import DenseFFNAdapter, SearchConfig
    from repro_torch.core import invariance as inv
    from repro_torch.data.calib import calibration_tensor
    from repro_torch.kernels import build, ops, ref
    # kernel-binding modules (their names are shadowed by the wrappers that
    # repro_torch.kernels re-exports)
    gq = importlib.import_module("repro_torch.kernels.group_quant")
    tq = importlib.import_module("repro_torch.kernels.transform_quant")
    from repro_torch.models.model import forward, init_params, lm_loss

    smi = nvidia_smi_line()
    print(smi, flush=True)
    log("env", torch=torch.__version__, cuda=torch.version.cuda,
        python=sys.version.split()[0], device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count())

    # ---- build: one nvcc per source, started together --------------------
    t0 = time.perf_counter()
    build.build_all()
    log("build", seconds=time.perf_counter() - t0,
        dir=str(build.build_dir().relative_to(ROOT)))
    for name in build.KERNELS:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas[{name}]: {line.strip()}", flush=True)

    # ---- phase 1: kernels vs plain versions ------------------------------
    cfg = get_config("opt-1.3b")
    rows = phase_kernels(torch, ops, ref, gq, tq, cfg)
    phase_small_reference(torch)

    # ---- phase 2: main path on opt-1.3b ----------------------------------
    dev = torch.device("cuda")
    qcfg = QuantConfig(bits=2, group_size=32)
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = init_params(cfg, gen, device="cuda")
    calib = calibration_tensor(cfg.vocab_size, n_seqs=4, seq_len=512,
                               seed=99, device="cuda")
    held = calibration_tensor(cfg.vocab_size, n_seqs=4, seq_len=512,
                              seed=123, device="cuda")
    torch.cuda.synchronize()
    log("setup", arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        d_ff=cfg.d_ff, vocab=cfg.vocab_size, calib=list(calib.shape),
        seconds=time.perf_counter() - t0)

    def ppl(p):
        logits = forward(p, cfg, held)
        return math.exp(float(lm_loss(logits[:, :-1], held[:, 1:],
                                      cfg.vocab_size)))

    ppl_fp = ppl(params)
    scfg = SearchConfig(steps=STEPS, fused_kernel=True, log_every=0)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rtn = quantize_model(params, cfg, qcfg, "rtn", device="cuda")
    res = quantize_model(params, cfg, qcfg, "rtn", calib, scfg, device="cuda")
    torch.cuda.synchronize()
    counts = dict(ops.LAUNCHES)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    sr = res.search
    ppl_rtn = ppl(rtn.params_q)
    ppl_search = ppl(res.params_q)
    losses = [h[1] for h in sr.history]
    log("main_path", method=res.method, ppl_fp32=ppl_fp, ppl_rtn=ppl_rtn,
        ppl_rtn_search=ppl_search, initial_loss=sr.initial_loss,
        final_loss=sr.final_loss, accept_rate=sr.accept_rate,
        proposals_per_sec=sr.stats["proposals_per_sec"], steps=STEPS,
        peak_bytes=peak, wall_s=wall, launches=counts)
    nums = [ppl_fp, ppl_rtn, ppl_search, sr.initial_loss, sr.final_loss,
            sr.stats["proposals_per_sec"]] + losses
    if not all(math.isfinite(x) for x in nums):
        raise AssertionError(f"non-finite main-path numbers: {nums}")
    if not sr.final_loss <= sr.initial_loss:
        raise AssertionError("search final loss above its initial loss")
    if counts["group_quant"] <= 0:
        raise AssertionError("group_quant never launched on the main path")
    if counts["transform_quant"] != 2 * STEPS * scfg.population:
        raise AssertionError(
            f"transform_quant launches {counts['transform_quant']} != "
            f"2 x {STEPS} steps x K={scfg.population}")
    for path in (("blocks", "mlp", "up"), ("blocks", "attn", "wq")):
        t = res.params_q
        for k in path:
            t = t[k]
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"non-finite weights at {path}")
    del rtn

    # ---- phase 3: fused lane vs unfused lane -----------------------------
    lanes = {}
    for fused in (True, False):
        ops.reset_launch_counts()
        r = quantize_model(params, cfg, qcfg, "rtn", calib,
                           SearchConfig(steps=LANE_STEPS, fused_kernel=fused,
                                        log_every=0), device="cuda")
        lanes[fused] = (r.search.history, dict(ops.LAUNCHES))
        del r
    compared, parted = histories_agree(lanes[True][0], lanes[False][0],
                                       "fused vs unfused")
    if lanes[False][1]["transform_quant"] != 0 or \
            lanes[False][1]["group_quant"] < 2 * LANE_STEPS:
        raise AssertionError(f"unfused lane launches {lanes[False][1]}")
    log("lanes", steps=LANE_STEPS, compared=compared, parted_at=parted,
        fused_losses=[h[1] for h in lanes[True][0]],
        unfused_losses=[h[1] for h in lanes[False][0]],
        fused_launches=lanes[True][1], unfused_launches=lanes[False][1])

    # ---- phase 4: where one search step's time goes ----------------------
    adapter = DenseFFNAdapter(cfg)
    base = adapter.base_stack(params)
    t_id = inv.identity_transform(cfg.d_ff, dev)
    cand = inv.propose(torch.Generator(device=dev).manual_seed(5), t_id,
                       inv.ProposalConfig())

    def eval_once():   # one candidate evaluation's operations (their cost
        # does not depend on the weights' values)
        logits, hidden = forward(params, cfg, calib, collect_hidden=True)
        return calib_ce(logits, calib, cfg.vocab_size), \
            activation_mse(hidden, hidden, 10)

    def fused_build():
        return adapter.transform_quant_unit(base, cand, 0, qcfg)

    split = dict(
        forward_objective_ms=time_ms(torch, eval_once, warmup=1, reps=5),
        fused_build_ms=time_ms(torch, fused_build, reps=10),
        # the two transform_quant kernels' own time in one fused build
        fused_build_kernels_device_ms=device_ms(
            torch, fused_build, ("transform_quant",), calls=10),
        unfused_build_ms=time_ms(torch, lambda: adapter.quant_unit(
            adapter.transform_unit(base, cand, 0), qcfg), reps=10),
        step_ms=1e3 / sr.stats["proposals_per_sec"])
    log("step_split", **split)
    del base
    log("profile", **profile_search(torch, params, cfg, qcfg, calib))
    del params, res, sr, t, calib, held, adapter   # sr and t hold model leaves
    torch.cuda.empty_cache()

    # ---- phase 5: paged serving ------------------------------------------
    from repro_torch.serving import build_trace
    pd = importlib.import_module("repro_torch.kernels.paged_decode")
    pd_errs = phase_paged_kernels(torch, ops, ref, pd)
    decode_lens = [len(t["prompt"]) + TRACE["max_new"] // 2
                   for t in build_trace(cfg.vocab_size, **TRACE)[:8]]
    pd_rows = phase_paged_times(torch, ops, ref, pd, decode_lens)
    gqa_vs_sdpa(pd_rows)
    params_q, setup_s = packed_opt(torch, cfg)
    serve_counts, split = phase_serving(torch, ops, pd_rows, cfg, params_q,
                                        setup_s)
    small_counts = phase_small_serving(torch, ops)

    # ---- phase 6: contiguous-cache serving, quant_matmul -----------------
    fd = importlib.import_module("repro_torch.kernels.flash_decode")
    qm = importlib.import_module("repro_torch.kernels.quant_matmul")
    fd_err = phase_flash_kernels(torch, ops, ref)
    trace0 = build_trace(cfg.vocab_size, **TRACE)[:LEGACY["batch_size"]]
    fd_rows = phase_flash_times(torch, ref, fd, max(
        len(t["prompt"]) for t in trace0) + TRACE["max_new"] // 2)
    fd_launches = phase_legacy_serving(torch, ops, cfg, params_q)
    del params_q
    torch.cuda.empty_cache()
    phase_small_legacy(torch, ops)
    qm_rows, qm_err, qm_launches = phase_quant_matmul(torch, ops, ref, qm)

    kernels = []
    for name, source, replaces in (
            ("group_quant", "src/repro_torch/csrc/group_quant.cu",
             "src/repro/kernels/group_quant.py:40"),
            ("transform_quant", "src/repro_torch/csrc/transform_quant.cu",
             "src/repro/kernels/transform_quant.py:102")):
        row = rows[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": counts[name],
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
            "library_note": "no PyTorch call computes group fake-quant with "
                            "these closed-form scale/zero",
            **{k: row[k] for k in ("device_ms", "per", "shapes", "plans",
                                   "per_pi", "dtype") if k in row}})
    for route in PD_ROUTES:
        main_row, long_row = pd_rows[route]["decode"], pd_rows[route]["long"]
        b1_row = pd_rows[route].get("long-b1")
        kernels.append({
            "name": route, "route": "cuda",
            "source": "src/repro_torch/csrc/paged_decode.cu",
            "replaces": {"paged_decode": "src/repro/kernels/paged_decode.py:111",
                         "paged_decode_gqa":
                             "src/repro/kernels/paged_decode.py:289",
                         "paged_decode_gqa_mp":
                             "src/repro/kernels/paged_decode.py:369"}[route],
            "launches": (serve_counts if route == "paged_decode"
                         else small_counts)[route],
            "launches_on": ("opt-1.3b serving, sharing on" if route ==
                            "paged_decode" else "opt-tiny reduced serving"),
            "max_abs_err": pd_errs[route],
            **{k: main_row[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")},
            "library_note": "torch scaled_dot_product_attention on K/V "
                            "already gathered contiguous, boolean length "
                            "mask, the faster of K/V repeated to H heads and "
                            "(GQA routes) enable_gqa on K/V as they are; "
                            "gather and head repeat not timed",
            "shape": {k: main_row[k] for k in ("heads", "head_dim", "lens",
                                               "pages_per_block")},
            "device_ms": main_row["device_ms"],
            "n_split": main_row["n_split"],
            "long_context": {k: long_row[k] for k in PD_CTX_KEYS},
            **({"long_context_b1": {k: b1_row[k] for k in PD_CTX_KEYS}}
               if b1_row else {}),
            "dtype": "float32"})
    main_row, long_row = fd_rows["decode"], fd_rows["long"]
    kernels.append({
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode.py:64",
        "launches": fd_launches,
        "launches_on": "opt-1.3b BatchedServer, use_flash_decode on",
        "max_abs_err": fd_err,
        **{k: main_row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")},
        "library_note": "torch scaled_dot_product_attention over the same "
                        "contiguous cache (a transposed view) with a boolean "
                        "length mask",
        "shape": {k: main_row[k] for k in ("batch", "heads", "head_dim",
                                           "cache_rows", "kv_len")},
        "ms_range": main_row["ms_range"],
        "device_ms": main_row["device_ms"],
        "long_context": {k: long_row[k] for k in (
            "ms", "ms_range", "device_ms", "plain_ms", "bound_ms",
            "library_ms", "cache_rows", "kv_len")},
        "dtype": "float32"})
    qrow = qm_rows[QM_MAIN]
    kernels.append({
        "name": "quant_matmul", "route": "cuda",
        "source": "src/repro_torch/csrc/quant_matmul.cu",
        "replaces": "src/repro/kernels/quant_matmul.py:49",
        "launches": qm_launches,
        "launches_on": "the public op kernels.quant_matmul, once per 6e "
                       "case; no serving path calls it (the reference "
                       "dequantises each layer)",
        "max_abs_err": qm_err,
        **{k: qrow[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                "library_ms")},
        "library_note": "torch.matmul(x, W) with W already dequantised to "
                        "dense f32: no single PyTorch call computes "
                        "dequant + matmul",
        "shape": {"case": QM_MAIN, "mkn": qrow["shape"], "bits": qrow["bits"],
                  "group": qrow["group"]},
        **{k: qrow[k] for k in ("device_ms", "library_device_ms", "plan")},
        "cases": {n: {k: r[k] for k in QM_CASE_KEYS}
                  for n, r in qm_rows.items()},
        "dtype": "float32"})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
