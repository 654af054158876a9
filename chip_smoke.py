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
   groups 32/128; times each with CUDA events beside its bound; then the
   main path at a small size (opt-tiny) on the card against the same path
   on the CPU, where the wrappers run their plain versions;
2. the main path: ``quantize_model`` RTN and RTN + 16 fused InvarExplore
   steps on random-init opt-1.3b at full width and depth, with held-out
   perplexity for fp32 / RTN / RTN+search and the kernels' launch counts;
3. fused lane vs unfused lane for 6 steps from the same seed;
4. where one search step's time goes (candidate build vs forward), and
   device time by kernel family under ``torch.profiler`` over a 4-step
   fused search, its set-up included.

Prints the ``nvidia-smi`` name/power-limit line, a ``{"kernels": [...]}``
line, and last ``{"ok": true, "device": {...}}``. Any failed check raises,
so the script exits non-zero without that last line; it also exits
non-zero when no CUDA card is present or the port's sources are missing.
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
    return statistics.median(times)


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

    # timing at the main path's shapes (bits 2, group 32): raw launches into
    # preallocated outputs for the kernel, the plain version for plain_ms
    bits, group = 2, 32
    rows = {}
    per_shape = []
    for leaf, (K, N), n in main_shapes:
        w = torch.randn((K, N), generator=gen, device=dev)
        fq, s, z = torch.empty_like(w), *(
            torch.empty((K // group, N), device=dev) for _ in range(2))
        t = time_ms(torch, lambda: gq.launch(w, fq, s, z, bits=bits,
                                             group=group))
        p = time_ms(torch, lambda: ref.group_quant_ref(w, bits, group),
                    reps=10)
        b, by = bound_ms(2 * K * N * 4 + 2 * (K // group) * N * 4,
                         GQ_OPS * K * N)
        per_shape.append(dict(leaf=leaf, shape=[K, N], per_pass=n, ms=t,
                              plain_ms=p, bound_ms=b, bound_by=by))
        log("kernel_time", kernel="group_quant", leaf=leaf, shape=[K, N],
            dtype="torch.float32", ms=t, plain_ms=p, bound_ms=b)
        del w, fq, s, z
    rows["group_quant"] = dict(
        ms=sum(r["ms"] * r["per_pass"] for r in per_shape),
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
    tq_ms = tq_plain = tq_bound = 0.0
    for mode, w in w_tq.items():
        K, N = w.shape
        fq, s, z = torch.empty_like(w), *(torch.empty((K // group, N), device=dev)
                                           for _ in range(2))
        svec = sv if mode == "up" else 1.0 / sv
        cos, sin = torch.cos(phi), torch.sin(phi)
        t = time_ms(torch, lambda: tq.launch(w, pi, svec, cos, sin, fq, s, z,
                                             bits=bits, group=group, mode=mode))
        p = time_ms(torch, lambda: ref.transform_quant_ref(
            w, pi, sv, phi, bits=bits, group=group, mode=mode))
        nb = 2 * K * N * 4 + 2 * (K // group) * N * 4 + F * (8 + 4) + F * 4
        b, _ = bound_ms(nb, TQ_OPS * K * N)
        log("kernel_time", kernel="transform_quant", mode=mode,
            shape=[K, N], ms=t, plain_ms=p, bound_ms=b)
        tq_ms += t
        tq_plain += p
        tq_bound += b
    rows["transform_quant"] = dict(
        ms=tq_ms, plain_ms=tq_plain, bound_ms=tq_bound, bound_by="bytes",
        per="one candidate: up (2048, 8192) + down (8192, 2048)",
        dtype="float32")
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

    split = dict(
        forward_objective_ms=time_ms(torch, eval_once, warmup=1, reps=5),
        fused_build_ms=time_ms(torch, lambda: adapter.transform_quant_unit(
            base, cand, 0, qcfg), reps=10),
        unfused_build_ms=time_ms(torch, lambda: adapter.quant_unit(
            adapter.transform_unit(base, cand, 0), qcfg), reps=10),
        step_ms=1e3 / sr.stats["proposals_per_sec"])
    log("step_split", **split)
    del base
    log("profile", **profile_search(torch, params, cfg, qcfg, calib))

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
            **{k: row[k] for k in ("per", "shapes", "dtype") if k in row}})
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
