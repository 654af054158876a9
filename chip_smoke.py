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
   peak memory; then a third sharing-on run, over the trace's first 8
   requests (a cut: reading the profiler's events costs ≈ 0.2 ms each),
   under ``torch.profiler``:
   device time by kernel family in the decode steps and prefills, and the
   decode step split into per-layer dequant, the paged-decode kernel, the
   other device work and device idle time; (d) the serving CLI's small configs
   (GQA 4/2, GQA with 2 pages per block, MHA) on the card and on the CPU:
   identical greedy tokens and stats, all three routes launched;
6. contiguous-cache serving and the dequant-matmul: (a) ``flash_decode`` vs
   its plain version at rtol = atol = 2e-4, the reference's bar
   (``tests/test_kernels.py``), at opt-1.3b's head layout, a full-width GQA
   one, the small configs' and one long sequence (B 1 x 2048, MHA and GQA:
   the planner splits its rows across CTAs), on f32, bf16 and int8 caches,
   kv_len 0, 1, a tile boundary, a run boundary, ragged and S, and NaN in
   every slot past kv_len; (b) its time (one call, and device time under
   the profiler) at 6c's decode shape, at B 8 x 2048 rows and at B 1 x 2048
   beside its bound, its plain version and ``scaled_dot_product_attention``
   with a length mask (one call, and device time);
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
   dequantised weights, then the public op once per case;
7. the calibrated base methods and the other objectives: (a) on opt-1.3b
   at full width, 4 of its 24 layers (a cut: 12 from phase 12, 4 since
   phase 15; GPTQ's row loop is host-bound), seed 0, and phase 2's
   calibration and held-out sets, ``quantize_model`` with ``gptq``, ``awq`` and
   ``omniquant`` (OmniQuant cut to 20 Adam steps a block from 200), each
   alone and then with 16 fused search steps: ppl for fp32 / base /
   base+search, the search's initial and final loss and accept rate,
   seconds for the taps (timed on their own), the method and the search,
   peak memory and the launch counts, with ``group_quant`` held to
   ``base_method_gq_launches`` and ``transform_quant`` to 2 × steps;
   (b) a 4-step fused search after RTN with ``objective="swd_actmatch"``
   and ``"saliency_ce"``; (c) on opt-tiny reduced, each method on the card
   against the CPU (weights within ``group_quant``'s bar, GPTQ's output
   within its own and parting after the pipeline's fake-quant only at
   round-half ties, AWQ's α and clip picks equal or parted at a printed
   near tie) and each 7b objective's search with the same proposals and
   SWD directions (``histories_agree``);
8. the rest of the search engine, through ``repro_torch.search.run`` on
   phase 2's opt-1.3b weights and calibration set (fused lane): (a) K 2
   for 6 steps with one island, two islands without migration (island 0
   must equal the single chain exactly) and two migrating every 2 steps;
   (b) ``shard_calib`` over two islands of 2 sequences each; (c) K 8 for 3
   steps with ``install="unit"`` and ``"stack"`` and ``measure_memory``
   (identical histories, or the reference's install bar; stack bytes equal,
   candidate batch bytes K units against K stacks, a ratio of exactly 24,
   from the shapes; the unit peak below the stack peak); (d) the tabu
   memory with a state-deterministic proposal source (identical histories
   with and without it, at least one hit; two annealed runs identical, π
   still permutations). After every run the registry's search counters
   must equal the stats, and the ``group_quant`` / ``transform_quant``
   launches ``search_launches``. (e) The search CLI on the card (islands;
   memory rows for both install modes) into ``build/smoke/``; (f)
   opt-tiny reduced on the card against the CPU: islands with migration,
   tabu and ``shard_calib``, the same with ``install="stack"``, and a warm
   annealed tabu run whose cached moves are accepted and rebuilt;
9. training and checkpoints: (a) ``repro_torch.launch.train.train`` on
   opt-1.3b (full width and depth, ≈ 1.42 B params, untied head) from
   phase 2's seed for 10 steps at batch 4 × 512 (the mean loss of the last
   third must fall below the first third's; loss, lr and grad_norm
   finite), then 3 timed steady steps of the same train step (step ms,
   tokens/s, 6·N·tokens TFLOP/s and its share of the fp32 peak, peak
   allocator bytes), device time by kernel family under ``torch.profiler``
   over two steps, the optimizer alone beside its bound, and
   ``accum_steps=2`` on the same batch against the full batch (loss within
   1e-4, params within the reference's rtol 2e-3 / atol 2e-4); (b) that
   train state (params, m and v, ≈ 17 GB f32) through an async
   ``CheckpointManager`` into build/smoke/ckpt/ (deleted afterwards): 3
   uninterrupted steps, against 1 step, a save, and ``run_resilient`` from
   step 1 with a failure injected at its first step, which restores the
   save (every restored leaf ``torch.equal`` to the saved one, dtype kept;
   a ``("restored", 1)`` event) and runs the last 2 steps (losses within
   rtol 1e-5 of the uninterrupted ones: the embedding backward accumulates
   with atomics); the host's disk and memory, bytes, save / wait / restore
   seconds and peak RSS; (c) ``repro_torch.bench.table1_main.run`` on the
   bench model that the port trains itself (400 steps, into
   build/smoke/bench_model/): every row's held-out ppl, seconds, accept
   rate and launches (``group_quant`` held to ``base_method_gq_launches``,
   ``transform_quant`` to 2 × 400 on each +IE row), with
   ``table1_main``'s claims; (d) opt-tiny reduced, the same init and
   batches, 5 steps of ``train()`` on the card against the CPU (losses
   within 1e-5 relative, params within (a)'s bar);
10. the dense zoo (RoPE, qk-norm, gated SwiGLU, GQA): (a) Qwen3-4B
   (``configs/qwen3_4b.py``: 36 layers, d 2560, 32/8 heads, Dh 128, d_ff
   9728, vocab 151936) at full width, 12 of its 36 layers, random-init, in
   fp32 (phase 14 runs it in its own bf16 at full depth): ``quantize_model`` RTN and AWQ,
   each alone and with 16 fused steps (``transform_quant``'s gate call
   included), on 4 x 512 calibration tokens: held-out ppl, losses, accept
   rate, seconds, peak memory, launches held to ``base_method_gq_launches``
   and ``search_launches`` (3 x 16 a search), and one candidate's forward
   beside its operations (``forward_flops``); (b) the same weights packed
   at 2 bits through ``PagedServer`` over phase 5's trace with sharing
   off, on, and on with 2 pages per block, as 5c (the GQA routes, 36 x
   decode steps each, tokens held to the oracle and to each other, 0
   leaked pages, saved_frac >= 0.5, the step split); (c) through
   ``BatchedServer`` with ``use_flash_decode`` off and on, as 6c; (d) the
   four dense configs' ``reduced()`` sizes on the card against the CPU:
   logits of the forward and of prefill + 3 decode steps, RTN + 4 fused
   steps (``histories_agree``), the base methods at 7c's bars, 5 train
   steps at 9d's, PagedServer's greedy tokens identical;
11. the MoE family: (a) Phi-3.5-MoE (``configs/phi3_5_moe.py``: d 4096,
   32/8 heads × 128, 16 experts top-2, d_ff 6400, LayerNorm, vocab 32064)
   at full width, 3 of its 32 layers deep (the cut), random-init, in its
   own bf16: ``group_quant`` (``round_range``) held to its plain version at
   every shape the model gives it, ``transform_quant`` at one expert and
   the GQA paged routes and flash_decode at its heads on bf16 caches
   (``tq_check``, ``attn_kernels_at``), then ``quantize_model`` RTN
   alone and with 16 fused steps over the 48 expert units (launches held
   to ``base_method_gq_launches`` and ``search_launches``), held-out ppl,
   losses, accept rate, peak memory, and one candidate's forward beside
   its operations over the E·C slots of the dispatch buffer
   (``moe_forward_flops``); (b) the packed model through ``PagedServer``
   with sharing off, on, and on with 2 pages per block (both GQA routes,
   3 x decode steps each), each run served again with every decode step
   held to the same step through the paged decode's plain version on the
   same pools (``StepCheck``: MoE capacity follows each prefill chunk's S,
   so a full forward is not the served computation, and in bf16 a
   rounding swaps experts at a router near tie), with the step split; (c)
   ``BatchedServer`` with ``use_flash_decode`` off (no independent
   oracle: a full forward routes at another capacity) and on
   (``StepCheck`` against blocked attention); then the bf16-vs-fp32 accept decisions (``family_accepts``,
   as 14c); (d) phi3.5-moe and Moonlight (E 64, top-6) reduced on the card
   against the CPU: forward, prefill + decode, RTN + 4 fused steps, 5
   train steps, PagedServer's tokens, and in bf16 (``phase_small_bf16``);
12. the SSM and hybrid families: (a) Mamba2-2.7B
   (``configs/mamba2_2_7b.py``: 64 blocks, d 2560, d_inner 5120, 80 SSD
   heads x 64, d_state 128, chunk 128, vocab 50280) at full width and
   depth, random-init, in its own bf16:
   ``group_quant`` held to its plain version at the stacked Mamba shapes
   and one block's, then ``quantize_model`` RTN alone and with 16 steps,
   the fused flag asked for (the Mamba adapter has no fused build: one
   warning, the unfused lane), on 4 x 512 calibration tokens: held-out
   ppl, losses (each phase's accepted losses falling strictly), peak
   memory, launches held to ``ssm_quantize_launches``, and one
   candidate's forward beside its operations, the SSD scan's included
   (``ssm_forward_flops``); (b) the packed model through ``BatchedServer``
   over the trace's first 8 requests: each served step's logits held,
   teacher-forced, to the full forward's (``hold_served_logits``: in bf16
   one-ulp partings grow over 64 blocks past any token tie), tokens/s,
   step ms, device ms per decode step by family (dequant, GEMM, the SSD
   state update, idle), ``PagedServer`` refusing the config, and the same
   server on the RTN model in fp32, its greedy tokens held to the
   full-forward oracle at NEAR_TIE; (c) Zamba2-7B
   (``configs/zamba2_7b.py``: d 3584, 32/32 heads x 112, d_ff 14336, SSM
   d_state 64) at full width, 13 of its 81 blocks (hybrid layout (11,
   2)), bf16, after ``transform_quant`` at its shared FFN and flash_decode
   at Dh 112 on a bf16 cache: as (a), with the two-phase search (8
   unfused Mamba steps,
   then 8 fused shared-FFN steps: 24 ``transform_quant``), then
   ``BatchedServer`` with ``use_flash_decode`` off and on (logits held as
   in (b); flash_decode launched 2 x decode steps), and both again on the
   RTN model in fp32 (tokens held to the oracle and to each other);
   the bf16-vs-fp32 accept decisions of both; (d) both configs reduced on
   the card against the CPU: forward and taps, prefill + 3 decode steps,
   RTN + 4 steps on the same CPU-drawn proposals (``histories_agree`` per
   phase), BatchedServer's tokens, and in bf16;
13. the encoder-decoder and vision families, at full width and depth in
   their own bf16, after ``group_quant`` is held to its plain version at
   every stacked shape both models give it (``encdec_gq_shapes``) and
   timed at the largest, and ``transform_quant`` and flash_decode at
   Seamless's decoder: (a) SeamlessM4T-medium
   (``configs/seamless_m4t_medium.py``: 12 encoder + 12 decoder layers, d
   1024, 16/16 heads x 64, ReLU d_ff 4096, biases, LayerNorm, learned
   positions, vocab 256206 -> 256256), random-init: ``quantize_model`` RTN
   alone and with 16 fused steps on 4 x 512 calibration tokens with 4 x
   4096 stub encoder frames through ``forward_kwargs`` (the encoder's FFN
   leaves unchanged by the search, changed by RTN; launches held to
   ``encdec_quantize_launches``), held-out ppl, losses, accept rate, peak
   memory, one candidate's forward beside its operations
   (``encdec_forward_flops``: the encoder runs at every evaluation), and
   GPTQ / AWQ / OmniQuant refusing the stack; (b) the packed model through
   ``make_prefill_step`` + ``make_serve_step`` (B 8 of the trace's prompts,
   8 x 4096 frames, 16 greedy tokens) with ``use_flash_decode`` off and on:
   tokens held to a full-forward oracle and to each other, the cross
   cache's bytes, flash_decode launched 12 x 15 times with the flag on, a
   decode step's device time by family and idle share; PagedServer and
   BatchedServer raising; (c) InternVL2-1B (``configs/internvl2_1b.py``: 24
   layers, d 896, 14/2 heads x 64 (GQA rep 7), SwiGLU d_ff 4864, qkv
   biases, RoPE 1e6, tied embeddings, vocab 151655): RTN and AWQ, each
   alone and with 16 fused steps, on text (as 10a); the packed model
   through the steps with 8 x 256 stub patches (decode from P+S, tokens
   held to the full forward with the same patches, flash_decode at rep 7);
   PagedServer over the trace with sharing off, on and MP 2 and
   BatchedServer flag off / on (as 10b-c); the two GQA paged routes and
   flash_decode at (B 8, 14/2, Dh 64) against their plain versions at the
   trace's lengths and at 1024 (f32, int8 and bf16 caches), timed on bf16
   beside their bounds, ``transform_quant`` at its FFN; the CE search with
   patches raising ValueError; then the bf16-vs-fp32 accept decisions of
   both; (d) 4 train steps of each in its own bf16 at B 2 x 512 tokens
   (512 frames; 256 patches), lr 1e-4 after one warm-up step: finite
   losses, step ms (median of the last 3), TFLOP/s, peak bytes against
   the reckoning, the optimizer's time beside its bytes bound
   (``run_train_steps``); (e) both reduced configs on the card against the
   CPU: forward and taps, prefill + 3 decode steps, RTN + 4 fused steps
   (``histories_agree``), 3 train steps, and in bf16 (with 3 bf16 train
   steps held to the CPU's own spread);
14. Qwen3-4B in its config's own bf16 at full width and depth,
   random-init, with ``torch.backends.cuda.matmul.
   allow_bf16_reduced_precision_reduction`` off: (a) ``transform_quant``'s
   bf16 branch up (2560, 9728) and down (9728, 2560) and ``group_quant``
   (``round_range``, as ``fake_quant`` calls it) at every stacked
   attention and FFN shape, each held to its plain version with ``torch.equal`` and
   timed (ms, device ms) beside its bound; (b) as 10a in bf16: RTN and AWQ
   alone and with 16 fused steps, ppl, losses, launches held to the
   formulas, peaks, a forward's ms and TFLOP/s; (c) from the same bf16
   weights, 16 fused steps in bf16 and 16 in fp32 (the weights widened)
   on the same CPU-drawn proposals: the accept decisions that differ; (d)
   the RTN weights packed at 2 bits, cut to their first 6 layers (12 since
   phase 15, 6 since phase 16), through ``PagedServer`` (sharing off,
   on, MP 2) and ``BatchedServer`` (flag off, on) as 10b-c, on bf16 pools
   and caches, tokens held to a bf16 greedy oracle (a bf16 near tie: the
   served token's oracle logit within NEAR_TIE_BF16 of the top logit; each
   check logs the share of positions whose top-2 gap is under the bar);
   (e) the bf16 train step at full width, 12 of the 36 layers (1.99 B
   parameters: the out-of-place step holds 24 B each, 106 GB at full
   depth): B 4 x 512 tokens, 5 steps at lr 1e-4 after one warm-up step,
   losses finite and falling, the share of bf16 elements moved, step ms,
   TFLOP/s, peak bytes against the reckoning, the optimizer beside its
   bytes bound (``phase_train_bf16``); then Qwen3-4B reduced in bf16 card
   against the CPU (``phase_small_bf16``), its last train state saved on
   the card in formats 1 and 2 and restored bit for bit;
15. more than one process (``torch.distributed``; each rank a process of
   its own, started with ``spawn`` after the kernels are built, on the one
   card): first the sequential engine on opt-1.3b (full width and depth,
   phase 2's seed and calibration set): RTN + 8 fused steps with 1 island,
   and with 2 islands migrating every 4 steps (step ms, peak bytes); then
   (a) a real NCCL group of one: the NCCL version, the barrier,
   ``repro_torch.launch.dist_smoke``'s checks on the card (opt-tiny mapped
   parity, the merged metrics, a format-2 checkpoint re-meshed),
   ``argmin_allgather`` / ``elite_broadcast`` / ``compressed_psum`` on card
   tensors (the last within its bound and one quantization step of the same
   call on the CPU), the mapped search with 1 island equal to the
   sequential run bit for bit (histories, losses, migrations, π, s, φ),
   and the sequence-sharded paged decode
   (``dist.sharded_paged_decode_attention``: the CUDA kernel's
   ``normalize=False`` partials, merged across ranks) on the whole cache
   at opt-1.3b's 32/32 x 64 and 32/8 x 128 (MP 1 and 2), B 8 x 1024, held
   to the kernel on the whole cache and to the plain version at PD_TOL;
   (b) two ranks on the card over gloo (``backend="gloo"`` passed
   explicitly: NCCL refuses two ranks on one device): the same, with the
   mapped search's 2 islands equal to the sequential 2-island run bit for
   bit, each rank's pools holding half of every sequence, and the merged
   ``dist_snapshot`` byte-identical on both ranks; each rank's peak bytes
   and a search step's ms beside the sequential run's;
16. the tooling held against the card: (a) the achieved figures beside
   ``launch.roofline.HW``: a bf16 and an f32 (TF32 off) ``torch.matmul``
   at 8192³ (median of 20) and HBM bandwidth from a 4 GiB device-to-device
   copy; (b) opt-1.3b (full width and depth) at phase 9a's 4 x 512 train
   step with remat off, "full" and "dots_all": loss and gradients equal to
   remat off's bit for bit (else held to 9d's bars, and said), step ms,
   ``max_memory_allocated`` (of the step, and of its forward and backward
   alone, where remat acts), the FLOPs ``FlopCounterMode`` counts on the
   card's run equal to the dry run's fake trace of the same step, and the
   fake trace's live peak within 0.9-1.1 x the measured one; (c) every
   shape the launch-budget checker (``repro_torch.analysis``) passes —
   each zoo arch's up (gate is the same shape) and down, f32 and its own
   dtype — through ``ops.transform_quant`` equal to its plain version, and
   every shape it refuses raising ``ValueError`` in the wrapper.

Prints the ``nvidia-smi`` name/power-limit line, a ``{"kernels": [...]}``
line (all seven ported kernels), and last ``{"ok": true, "device":
{...}}``. Any failed check raises, so the script exits non-zero without
that last line; it also exits non-zero when no CUDA card is present or the
port's sources are missing.
"""
from __future__ import annotations

import dataclasses
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
BF16_OPS_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense
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

# kernel-name fragments -> family for the profile (first match wins);
# cuBLAS's Hopper GEMMs for bf16 are "nvjet_*" kernels, which name no gemm
FAMILIES = (
    ("transform_quant", "transform_quant (port kernel)"),
    ("group_quant", "group_quant (port kernel)"),
    ("gemm", "matmul (cuBLAS)"),
    ("cutlass", "matmul (cuBLAS)"),
    ("nvjet", "matmul (cuBLAS)"),
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


def trace_ms(events, fragments, calls):
    """From a profiler's ``key_averages()`` over ``calls`` calls: (device ms
    per call of the kernels whose names hold one of ``fragments``, or None
    when the trace is incomplete; their event counts by name; the names of
    the other events with device time). A trace is complete when it holds
    these kernels and each was counted a whole multiple of ``calls`` times:
    after long traces the profiler drops some kernels' events (12-19 of 20)
    and then reads 10-40 % low (PERF.md §7)."""
    total, counts, others = 0, {}, []
    for e in events:
        t = getattr(e, "self_device_time_total", 0)
        if t <= 0:
            continue
        if any(f in e.key for f in fragments):
            total += t
            counts[e.key] = counts.get(e.key, 0) + e.count
        else:
            others.append(e.key)
    whole = all(n > 0 and n % calls == 0 for n in counts.values())
    ms = total / calls / 1e3 if counts and whole else None
    return ms, counts, others


def queued_ms(torch, fn, calls=20):
    """Time per call of ``calls`` calls of ``fn`` between two CUDA events,
    queued while the card sleeps (``torch.cuda._sleep``), so the card runs
    them back to back without waiting for the host: device time with the
    card's own gaps between launches (about 1-2 us each), without the
    profiler. A ``fn`` that syncs with the host waits out the sleep once
    and is then timed with its host gaps."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)     # ~25 ms, longer than queuing the calls
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def device_ms(torch, fn, fragments, calls=20, attempts=3):
    """Device time per call of ``fn``'s kernels whose names hold one of
    ``fragments``, under ``torch.profiler`` over ``calls`` calls after a
    warm-up: the kernels' own time, without the host's launch work that a
    CUDA-event timing of one call also holds.

    The profiler now and then returns a trace without these kernels, or
    (after long traces) with some of their events dropped (``trace_ms``);
    the trace is then taken again, up to ``attempts`` times. If a trace
    held other device work but never these kernels, their names are wrong
    and that fails. If no trace was complete, the time is ``queued_ms``'s
    and a ``device_time_fallback`` line says so."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    others, seen = [], False
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ms, counts, other = trace_ms(prof.key_averages(), fragments, calls)
        if ms is not None:
            return ms
        seen = seen or bool(counts)
        others += other
        log("device_time_retry", fragments=list(fragments), calls=calls,
            counts=counts, others=sorted(set(other)))
    if others and not seen:
        raise AssertionError(f"the profiler saw no device time in "
                             f"{fragments}, only in {sorted(set(others))}")
    ms = queued_ms(torch, fn, calls)
    log("device_time_fallback", fragments=list(fragments), attempts=attempts,
        ms=ms)
    return ms


def peak_share(flops, ms, elem):
    """{"share_of_<dtype>_peak": the rate ``flops`` in ``ms`` reach, over
    the card's peak for 4-byte (fp32) or 2-byte (bf16) operands}."""
    name, rate = ("share_of_fp32_peak", FP32_OPS_PER_S) if elem == 4 else \
        ("share_of_bf16_peak", BF16_OPS_PER_S)
    return {name: flops / ms / 1e-3 / rate}


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


def tq_bytes(K, N, group, f, elem=4):
    """Bytes transform_quant must move: w read and fq written once
    (``elem`` bytes a value), scale and zero written (f32), pi (int64), s,
    cos and sin read once."""
    return 2 * K * N * elem + 2 * (K // group) * N * 4 + f * (8 + 4) + f * 4


def gq_bytes(K, N, group, elem=4):
    """Bytes group_quant must move: w read and fq written once, scale and
    zero (f32) written once."""
    return 2 * K * N * elem + 2 * (K // group) * N * 4


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


def histories_agree(ha, hb, what, rtol=1e-5):
    """Compare two search histories (hb is the yardstick): losses within
    ``rtol`` and accept flags wherever |delta| > rtol |loss|; a flip on a
    near tie ends the comparison (the trajectories legitimately part
    there). Returns (steps compared, step where they parted or None)."""
    cur = hb[0][1]
    compared = 0
    for (sa, la, _, _, aa), (sb, lb, _, _, ab) in zip(ha, hb):
        if sa != sb:
            raise AssertionError(f"{what}: history steps differ")
        if abs(la - lb) > rtol * abs(lb):
            raise AssertionError(f"{what}: step {sb} loss {la} vs {lb}")
        if aa != ab:
            if abs(lb - cur) > rtol * abs(lb):
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

    runs = {}
    for d in (torch.device("cpu"), torch.device("cuda")):
        params = to(cpu_params, d)
        rtn_q = quantize_model(params, cfg, qcfg, "rtn", device=d).params_q
        base = rtn.map_quantizable(params, lambda w, p: fake_quant(w, qcfg),
                                   only=lambda p: p[-1] not in ("up", "down"))
        res = run(params, base, cfg, qcfg, cpu_calib.to(d),
                  SearchConfig(steps=LANE_STEPS, fused_kernel=True,
                               log_every=0),
                  proposals=CpuProposals(inv, 3, d))
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
NEAR_TIE = 1e-4          # relative logit gap under which tokens may part
# the same in a bf16 model (a cached decode and a full forward round 36
# layers' outputs differently): 2^-5 of the top logit, 4-8 bf16 ulps,
# 2.1x the largest gap seen at a parting on Qwen3-4B (0.0149)
NEAR_TIE_BF16 = 2.0 ** -5
SPREAD_FRAC = 1e-3     # share of the embedding table moved by one bf16 ulp


def near_tie(cfg) -> float:
    return NEAR_TIE if cfg.compute_dtype == "float32" else NEAR_TIE_BF16


def embed_moved(torch, params, seed, frac=SPREAD_FRAC):
    """``params`` (a shallow copy) with ``frac`` of its bf16 token
    embedding's nonzero elements moved by one ulp, away from or towards 0 at
    random (the model's own spread under one-ulp input changes)."""
    t = params["embed"]["tok"]
    g = torch.Generator(device=t.device).manual_seed(seed)
    pick = torch.rand(t.shape, generator=g, device=t.device) < frac
    step = torch.where(torch.rand(t.shape, generator=g, device=t.device)
                       < 0.5, 1, -1).to(torch.int16)
    bits = t.view(torch.int16)
    tok = torch.where(pick & (t != 0), bits + step, bits).view(t.dtype)
    return {**params, "embed": {**params["embed"], "tok": tok}}


def oracle_weights(params_q, cfg):
    """The greedy oracle's dense weights: the packed ones dequantised to
    the compute dtype (a bf16 model's oracle forward runs in bf16)."""
    import torch

    from repro_torch.models.model import dequant_tree
    return dequant_tree(params_q, getattr(torch, cfg.compute_dtype))


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


def check_greedy(torch, forward, dense, cfg, reqs, outs, what, kw=None,
                 device="cuda"):
    """Hold each request's tokens to the greedy oracle (one full forward
    over prompt + generated tokens, dense weights, and with the request's
    row of the frontend input ``kw``, whose P vision patches come first):
    every token is held to the oracle's argmax after the run's own earlier
    tokens (the forward is causal), and may differ from it only where the
    oracle's logit of the token served is within ``near_tie(cfg)`` of its
    top logit, relative (a near tie: the token is the oracle's runner-up
    or as close, not any token). Logs how many positions were held, how
    many of them have a top-2 gap under the bar (the share the rule could
    excuse) and how many parted; a token off the oracle at no near tie
    fails the check after every request is held (the line lists them all).
    Returns every near tie met as (request, position, relative gap of the
    token served): two runs that part first at (i, j) share their earlier
    tokens, so one of them left the oracle there and (i, j) is in the list
    (``compare_runs``)."""
    kw = kw or {}
    P = kw["vision_embeds"].shape[1] if "vision_embeds" in kw else 0
    ties, bad, n_pos, n_under = [], [], 0, 0
    V, bar = cfg.vocab_size, near_tie(cfg)
    for i, (r, out) in enumerate(zip(reqs, outs)):
        seq = torch.tensor([list(r.prompt) + out[:-1]], device=device)
        row = {k: v[i:i + 1] for k, v in kw.items()}
        logits = forward(dense, cfg, seq, **row)[0, P + len(r.prompt) - 1:,
                                                 :V].float()
        top2 = torch.topk(logits, 2, dim=-1).values
        gap2 = (top2[:, 0] - top2[:, 1]) / top2[:, 0].abs()
        served = logits.gather(1, torch.tensor(out, device=logits.device)[
            :, None])[:, 0]
        gap = ((top2[:, 0] - served) / top2[:, 0].abs()).tolist()
        pred = torch.argmax(logits, dim=-1).tolist()
        n_pos += len(out)
        n_under += int((gap2 < bar).sum())
        for j, (tok, want) in enumerate(zip(out, pred)):
            if tok != want:
                (ties if gap[j] < bar else bad).append((i, j, gap[j]))
    log("greedy_oracle", what=what, near_tie=bar, positions=n_pos,
        top2_under_bar=n_under, share_under_bar=n_under / max(n_pos, 1),
        parted=len(ties), largest_parted_gap=max((t[2] for t in ties),
                                                 default=None),
        refused=bad)
    if bad:
        i, j, g = bad[0]
        raise AssertionError(f"{what}: request {i} token {j}, its gap to the "
                             f"top {g:.3g} (not a near tie; {len(bad)} such)")
    return ties


def generate_with_logits(torch, server, reqs):
    """``server.generate(reqs)`` (a BatchedServer, one batch) keeping each
    step's logits: returns (outs, (B, steps, V) f32 logits: the prefill's
    last position, then each decode step's). The step is the server's own
    (``decode_step`` and its greedy argmax), the server left as it was."""
    from repro_torch.models.model import decode_step

    cfg, kept = server.cfg, []
    V = cfg.vocab_size
    prefill, step_fn = server.prefill_fn, server.step_fn

    def pre(p, batch):
        logits, cache = prefill(p, batch)
        kept.append(logits[:, -1, :V].float())
        return logits, cache

    def step(p, tok, cache, index):
        logits, cache = decode_step(p, cfg, tok, cache, index)
        kept.append(logits[:, -1, :V].float())
        return torch.argmax(logits[:, -1, :V], dim=-1)[:, None], cache

    server.prefill_fn, server.step_fn = pre, step
    try:
        outs = server.generate(reqs)
    finally:
        server.prefill_fn, server.step_fn = prefill, step_fn
    return outs, torch.stack(kept, 1)


SERVED_SPREADS = 2     # the served logits' bar, in the model's own spreads
SERVED_SPREAD_FRAC = 1.0   # ... with every embedding element moved one ulp
POWER_SHARE = 0.9      # control rows the bar must refuse for the check to hold


def _rel_rms(torch, got, want):
    """Per row: RMS of (got - want) over RMS of want, each centred over
    the vocabulary (a constant shift of a row changes no token)."""
    d = got - want
    d = d - d.mean(-1, keepdim=True)
    w = want - want.mean(-1, keepdim=True)
    return (d.pow(2).mean(-1) / w.pow(2).mean(-1)).sqrt()


def hold_served_logits(torch, forward, dense, cfg, reqs, outs, served, what,
                       device="cuda"):
    """A bf16 SSM or hybrid stack's served logits held, teacher-forced, to
    the full forward over the same tokens: per position, the distance
    ``_rel_rms(served, forward)`` within SERVED_SPREADS x the model's own
    spread (the largest ``_rel_rms`` between the forward and the same
    forward with every element of the token embedding moved by one ulp,
    ``embed_moved`` at SERVED_SPREAD_FRAC: the reduced Mamba2 and Zamba2
    on the CPU part from their forward by 0.013 and 0.036, their spreads
    are 0.053 and 0.070, the off-by-one control 1.3). Over its depth such a stack turns one-ulp partings
    into logit moves wider than any token tie (Mamba2's 64 blocks: 0.105
    of the top logit), so tokens cannot be held to the oracle, but a step
    that computes something else moves the whole row. The bar's power is
    read from a control: each served row against the forward's row one
    position later (an off-by-one step); fewer than POWER_SHARE of the
    control rows above the bar fails the check. Logs the distances, the
    spread, the bar and the control."""
    V = cfg.vocab_size
    moved = embed_moved(torch, dense, 1, SERVED_SPREAD_FRAC)
    dist, spread, control = [], [], []
    for i, (r, out) in enumerate(zip(reqs, outs)):
        seq = torch.tensor([list(r.prompt) + out[:-1]], device=device)
        at = len(r.prompt) - 1
        want = forward(dense, cfg, seq)[0, at:, :V].float()
        other = forward(moved, cfg, seq)[0, at:, :V].float()
        got = served[i, :len(out)].to(want.device)
        dist.append(_rel_rms(torch, got, want))
        spread.append(_rel_rms(torch, other, want))
        control.append(_rel_rms(torch, got[:-1], want[1:]))
    del moved
    dist, spread, control = (torch.cat(x) for x in (dist, spread, control))
    bar = SERVED_SPREADS * float(spread.max())
    over = int((dist > bar).sum())
    power = float((control > bar).float().mean())
    log("served_logits_oracle", what=what, positions=int(dist.numel()),
        largest=float(dist.max()), median=float(dist.median()),
        spread=float(spread.max()), bar=bar, over_bar=over,
        control_min=float(control.min()),
        control_median=float(control.median()), control_over_bar=power,
        oracle="full forward over the dequantized weights, teacher-forced "
               "on the served tokens")
    if over:
        raise AssertionError(f"{what}: {over} served rows farther than "
                             f"{bar:.3g} from the forward (largest "
                             f"{float(dist.max()):.3g})")
    if power < POWER_SHARE:
        raise AssertionError(f"{what}: the bar {bar:.3g} refuses only "
                             f"{power:.0%} of the off-by-one control rows")
    return float(dist.max()), bar


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


def other_kernels(named_ms, families, family="other", n=6):
    """The ``n`` kernels (by total ms over (name, ms) pairs) that
    ``families`` puts in ``family``: by default those no fragment names."""
    tot = defaultdict(float)
    for name, ms in named_ms:
        if _family(name, families) == family:
            tot[name[:120]] += ms
    return dict(sorted(tot.items(), key=lambda kv: -kv[1])[:n])


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
        n_kernels, inside = 0, []
        for start, dur, name in kernels:
            if any(a <= start <= b for a, b in ws):
                by_family[_family(name, SERVE_FAMILIES)] += dur / 1e3
                inside.append((name, dur / 1e3))
                n_kernels += 1
        out[n] = dict(spans=len(host[n]),
                      other_kernels_ms=other_kernels(inside, SERVE_FAMILIES),
                      matmul_kernels_ms=other_kernels(
                          inside, SERVE_FAMILIES, "matmul (cuBLAS)", 3),
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


SERVE_VARIANTS = (("off", False, 1), ("on", True, 1))   # 5c: label, sharing, MP


def phase_serving(torch, ops, kernel_rows, cfg, params_q, setup_s,
                  variants=SERVE_VARIANTS, tag="", profile_requests=None,
                  oracle=None):
    """5c (and 10b): PagedServer on a packed model over the 8-tenant trace,
    one run per variant (label, prefix sharing, gqa_pages_per_block), then
    a profiled run of the second variant over the first
    ``profile_requests`` requests (all by default: the profiler's Python
    side takes ≈ 0.2 ms an event, ≈ 120 s for the whole trace on a 36-layer
    model). Each run's outputs are held to the greedy oracle and to the
    first run's; each launches only the paged-decode route its heads and MP
    choose, n_layers x decode steps times. Returns (each run's launch
    counts by label, the step split).

    ``oracle(reqs, runs) -> (near ties by label, the oracle's name,
    the labels each run may be held to)`` replaces the greedy full-forward
    oracle: an MoE model routes each prefill chunk with the chunk's own
    capacity, so a full forward over prompt + output (one S) is not the
    served computation, and sharing changes the chunks (phase 11b holds
    each decode step to its plain route instead, ``stepwise_oracle``)."""
    from repro_torch import obs
    from repro_torch.launch.serve import PagedServer, Request
    from repro_torch.models.model import forward
    from repro_torch.quantized.qmodel import dense_bytes, packed_bytes
    from repro_torch.serving import build_trace

    trace = build_trace(cfg.vocab_size, **TRACE)
    reqs = [Request(**t) for t in trace]
    reg = obs.get_registry()
    runs = {}
    for label, sharing, mp in variants:
        route = ops.paged_decode_route(cfg.n_heads, cfg.n_kv_heads,
                                       gqa_pages_per_block=mp)
        server = PagedServer(params_q, cfg, prefix_cache=sharing,
                             gqa_pages_per_block=mp, device="cuda", **SERVE)
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
            raise AssertionError(f"{label}: leaked pages")
        if counts[route] != cfg.n_layers * st["steps"] or \
                any(counts[r] for r in PD_ROUTES if r != route):
            raise AssertionError(f"{label}: paged-decode launches {counts} != "
                                 f"{route} {cfg.n_layers} x {st['steps']} "
                                 f"steps")
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
        if sharing and rep["saved_frac"] < 0.5:
            raise AssertionError(f"{label}: saved_frac {rep['saved_frac']}")
        runs[label] = dict(outs=outs, wall=wall, counts=counts, stats=st,
                           report=rep, route=route, sharing=sharing, mp=mp,
                           step_ms=1e3 * tpot["sum"] / tpot["count"],
                           peak=torch.cuda.max_memory_allocated(),
                           live_before=live_before,
                           pool=server.cache.pool_bytes(),
                           tokens=sum(len(o) for o in outs))
        del server
    if oracle is None:
        dense = oracle_weights(params_q, cfg)
        ties = {k: check_greedy(torch, forward, dense, cfg, reqs, r["outs"],
                                f"{k} vs oracle") for k, r in runs.items()}
        del dense
        oracle_name = "full forward over the dequantized weights"
        peers = {k: variants[0][0] for k in runs}
    else:
        ties, oracle_name, peers = oracle(reqs, runs)
    parted = {k: compare_runs(runs[peers[k]]["outs"], r["outs"],
                              {(i, j) for t in ties.values() for i, j, _ in t},
                              f"{peers[k]} vs {k}")
              for k, r in runs.items() if peers[k] != k}
    # where one decode step's time goes: the second variant again under
    # torch.profiler, read against its unprofiled run's steps
    label, sharing, mp = variants[1]
    on = runs[label]
    preqs = reqs[:profile_requests]
    t0 = time.perf_counter()
    prof, prof_outs = profile_serving(torch, obs, PagedServer(
        params_q, cfg, prefix_cache=sharing, gqa_pages_per_block=mp,
        device="cuda", **SERVE), preqs)
    prof[f"outputs_as_{label}"] = prof_outs == on["outs"][:len(preqs)]
    prof["requests"] = len(preqs)
    prof["seconds"] = time.perf_counter() - t0
    dec = prof["serve.decode_step"]
    n = dec["spans"]
    pd_ms = dec["by_family_ms"].get("paged_decode (port kernel)", 0.0) / n
    deq_ms = dec["dequant_device_ms"] / n
    dev_ms = dec["device_ms"] / n
    split = dict(
        arch=cfg.name, run=label, step_ms=on["step_ms"],
        profiled_step_ms=dec["host_ms"] / n,
        device_ms=dev_ms, dequant_ms=deq_ms,
        dequant_per_layer_ms=deq_ms / cfg.n_layers, paged_decode_ms=pd_ms,
        other_device_ms=dev_ms - deq_ms - pd_ms,
        device_idle_ms=on["step_ms"] - dev_ms,
        device_busy_share=dev_ms / on["step_ms"],
        by_family_ms={k: v / n for k, v in dec["by_family_ms"].items()},
        steps=n, kernel_5b_ms=kernel_rows[on["route"]]["decode"]["ms"])
    log(tag + "serving_profile", **prof)
    for k, r in runs.items():
        log(tag + "serving", arch=cfg.name, run=k, prefix_cache=r["sharing"],
            pages_per_block=r["mp"], route=r["route"], requests=len(reqs),
            tokens=r["tokens"], wall_s=r["wall"],
            tokens_per_s=r["tokens"] / r["wall"],
            ttft_p50_s=r["report"]["ttft_p50_s"],
            ttft_p99_s=r["report"]["ttft_p99_s"],
            saved_frac=r["report"]["saved_frac"], stats=r["stats"],
            launches=r["counts"], step_ms=r["step_ms"], peak_bytes=r["peak"],
            live_bytes_at_start=r["live_before"],
            pool_bytes=r["pool"], near_ties=ties[k])
    log(tag + "serving_check", parted_at=parted,
        packed_bytes=packed_bytes(params_q), dense_bytes=dense_bytes(params_q),
        setup_s=setup_s, outputs_identical=not any(parted.values()),
        oracle=oracle_name, compared_with=peers)
    log(tag + "decode_step_split", **split)
    return {k: r["counts"] for k, r in runs.items()}, split


def serve_on_devices(torch, ops, cfg, params_q, mp, devs):
    """5d's run on each of ``devs``: PagedServer (4 slots, 8-token pages,
    64 pages, max_len 64) with ``mp`` pages per block over a 4-tenant
    trace, from the same packed weights. Returns one (outputs, stats,
    launch counts) per device."""
    from repro_torch.launch.serve import PagedServer, Request
    from repro_torch.serving import build_trace

    trace = build_trace(cfg.vocab_size, n_tenants=4, per_tenant=2,
                        page_size=8, max_new=6)
    res = []
    for dev in devs:
        server = PagedServer(to_device(params_q, dev), cfg, max_batch=4,
                             page_size=8, n_pages=64, max_len=64,
                             gqa_pages_per_block=mp, device=dev)
        ops.reset_launch_counts()
        outs = server.generate([Request(**t) for t in trace])
        res.append((outs, dict(server.batcher.stats), dict(ops.LAUNCHES)))
    return res


def phase_small_serving(torch, ops):
    """5d: the serving CLI's default config (opt-tiny reduced: GQA 4/2),
    the same with 2 pages per update, and an MHA variant, on the card and
    on the CPU with the same packed weights and requests."""
    from repro_torch.configs import get_config
    from repro_torch.core.quant import QuantConfig
    from repro_torch.models.model import init_params
    from repro_torch.quantized.qmodel import pack_model

    launches = {}
    for name, over, mp, route in (
            ("gqa", {}, 1, "paged_decode_gqa"),
            ("gqa-mp2", {}, 2, "paged_decode_gqa_mp"),
            ("mha", dict(n_kv_heads=4), 1, "paged_decode")):
        cfg = get_config("opt-tiny").reduced(**over)
        params_q = pack_model(init_params(
            cfg, torch.Generator().manual_seed(3), device="cpu"),
            QuantConfig(bits=2, group_size=32))
        cpu, card = serve_on_devices(torch, ops, cfg, params_q, mp,
                                     ("cpu", "cuda"))
        if card[0] != cpu[0]:
            raise AssertionError(f"{name}: card tokens differ from the CPU's")
        if card[1] != cpu[1]:
            raise AssertionError(f"{name}: batcher stats differ")
        counts = card[2]
        if counts[route] != cfg.n_layers * card[1]["steps"] or \
                any(counts[r] for r in PD_ROUTES if r != route) or \
                any(cpu[2].values()):
            raise AssertionError(f"{name}: launches {counts}")
        launches[route] = counts[route]
        log("small_serving", config=name, heads=[cfg.n_heads, cfg.n_kv_heads],
            pages_per_block=mp, stats=card[1], launches=counts,
            tokens_identical=True)
    return launches


# ---------------------------------------------------------------------------
# phase 6: contiguous-cache serving (BatchedServer) and quant_matmul
# ---------------------------------------------------------------------------

FD_TOL = dict(rtol=2e-4, atol=2e-4)   # tests/test_kernels.py flash_decode bar
QM_TOL = dict(rtol=5e-4, atol=5e-4)   # tests/test_kernels.py quant_matmul bar
LEGACY = dict(batch_size=8, max_len=128)
# 6a layouts: (name, B, H, Hkv, Dh, S): opt-1.3b's decode layout in 6c's
# 128-row cache, a full-width GQA one, the layouts 6d serves, one
# sequence of opt-1.3b's max_seq_len rows, MHA and GQA (split across CTAs),
# and the decode layout 12c serves (Zamba2-7B's shared attention, Dh 112)
FD_LAYOUTS = (("mha", 8, 32, 32, 64, 128), ("gqa", 8, 32, 8, 128, 128),
              ("small-gqa", 4, 4, 2, 16, 64), ("small-mha", 4, 4, 4, 16, 64),
              ("long-mha", 1, 32, 32, 64, 2048),
              ("long-gqa", 1, 32, 8, 128, 2048),
              ("zamba2", 8, 32, 32, 112, 128))
# 6b contexts, MHA 32 heads of 64: (name, B, S, live rows or None for 6c's
# decode length)
FD_CONTEXTS = (("decode", 8, LEGACY["max_len"], None), ("long", 8, 2048, 2048),
               ("long-b1", 1, 2048, 2048))


def flash_decode_len(vocab_size: int) -> int:
    """Live rows of 6c's first decode batch halfway through its steps:
    the longest prompt of the trace's first batch + max_new // 2."""
    from repro_torch.serving import build_trace
    trace0 = build_trace(vocab_size, **TRACE)[:LEGACY["batch_size"]]
    return max(len(t["prompt"]) for t in trace0) + TRACE["max_new"] // 2


def flash_lens(fd, B, H, Hkv, S, sms):
    """6a's kv_len values of a layout: 0, 1, a tile boundary, the end of
    the first run at S (where the planner splits), ragged, S."""
    run = fd.plan(B, H, Hkv, S, sms).run_pages
    return tuple(sorted({0, 1, fd.TILE_ROWS, min(run, S), S // 2 + 7, S}))


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


def phase_flash_kernels(torch, ops, ref, fd):
    """6a: flash_decode vs its plain version at every layout of
    ``FD_LAYOUTS``, f32 / bf16 / int8 caches, kv_len 0, 1, a tile boundary,
    a run boundary, a ragged value and S, then NaN in every slot at or past
    kv_len (in the scales for int8). The long layouts must split at S.
    Returns the max abs error."""
    worst = 0.0
    sms = fd.sm_count(torch.device("cuda"))
    for name, B, H, Hkv, Dh, S in FD_LAYOUTS:
        shape = dict(B=B, S=S, H=H, Hkv=Hkv, Dh=Dh)
        lens = flash_lens(fd, B, H, Hkv, S, sms)
        splits = [fd.plan(B, H, Hkv, n, sms).n_split for n in lens]
        if name.startswith("long") and splits[-1] < 2:
            raise AssertionError(f"flash_decode {name}: the planner did not "
                                 f"split {dict(zip(lens, splits))}")
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
                dtype=str(dt), kv_lens=list(lens), n_split=splits,
                max_abs_err=err)
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
                    n_split=fd.plan(B, H, Hkv, n, sms).n_split,
                    max_abs_err=err)
    return worst


def phase_flash_times(torch, ref, fd, decode_len):
    """6b: CUDA-event medians of the kernel (raw launches into a
    preallocated output: the split pass and, where the planner splits, the
    merge) at each ``FD_CONTEXTS`` shape (MHA 32 heads, Dh 64, f32: 6c's
    decode shape with ``decode_len`` live rows of a 128-row cache, B 8 x
    2048 rows (opt-1.3b's max_seq_len) and B 1 x 2048), with their device
    time under the profiler, beside the bound, the plain version and
    ``scaled_dot_product_attention`` over the same cache (a transposed
    view, no copy) with a boolean length mask, that too as one call and as
    device time."""
    import torch.nn.functional as F
    rows = {}
    H, Hkv, Dh = 32, 32, 64
    sms = fd.sm_count(torch.device("cuda"))
    for ctx, B, S, n in FD_CONTEXTS:
        n = n or decode_len
        q, k, v, _, _ = flash_case(torch, B=B, S=S, H=H, Hkv=Hkv, Dh=Dh,
                                   dtype=torch.float32, seed=10)
        out = torch.empty((B, H, Dh), device=q.device)

        def run():
            fd.launch(q, k, v, None, None, out, kv_len=n)
        t, spread = time_stats(torch, run, reps=50)
        dev = device_ms(torch, run, PD_KERNEL_NAMES)
        p = time_ms(torch, lambda: ref.flash_decode_ref(q, k, v, kv_len=n),
                    reps=20)
        mask = (torch.arange(S, device=q.device) < n)[None, None, None, :]
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)

        def sdpa():
            return F.scaled_dot_product_attention(q[:, :, None, :], kt, vt,
                                                  attn_mask=mask)
        lib = time_ms(torch, sdpa, reps=50)
        # every kernel the library call runs
        lib_dev = device_ms(torch, sdpa, ("",))
        nbytes = 2 * B * n * Hkv * Dh * 4 + 2 * q.numel() * 4
        b, by = bound_ms(nbytes, 4 * B * H * Dh * n)
        rows[ctx] = dict(ms=t, ms_range=spread, device_ms=dev, plain_ms=p,
                         library_ms=lib, library_device_ms=lib_dev,
                         bound_ms=b, bound_by=by,
                         device_share_of_bound=b / dev, batch=B,
                         heads=[H, Hkv], head_dim=Dh, cache_rows=S, kv_len=n,
                         n_split=fd.plan(B, H, Hkv, n, sms).n_split)
        log("kernel_time", kernel="flash_decode", context=ctx, **rows[ctx])
    return rows


# what the kernels line carries of each 6b context past the decode shape
FD_CTX_KEYS = ("ms", "ms_range", "device_ms", "plain_ms", "bound_ms",
               "library_ms", "library_device_ms", "device_share_of_bound",
               "batch", "cache_rows", "kv_len", "n_split")


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


# no paged route runs in 6c: the split-KV kernels there are flash_decode's
LEGACY_FAMILIES = (("split_decode", "flash_decode (port kernel)"),
                   ) + SERVE_FAMILIES


def legacy_step_profile(torch, server, params_q, padded, steps,
                        profile=True):
    """Host ms per decode step of ``server`` on its first batch (prefill,
    then ``steps`` steps ending in one synchronize), then, with
    ``profile``, the same window under ``torch.profiler``: device ms by
    kernel family over the prefill and the steps."""
    from torch.profiler import ProfilerActivity

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
    if not profile:
        return step_ms, {}
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        run()
    by_family = defaultdict(float)
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if t > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            by_family[_family(ev.key, LEGACY_FAMILIES)] += t / 1e3
    return step_ms, dict(sorted(by_family.items(), key=lambda kv: -kv[1]))


def phase_legacy_serving(torch, ops, cfg, params_q, profile=True,
                         full_forward_oracle=True, ref=None):
    """6c (and 10c, 11c): BatchedServer on a 2-bit model (opt-1.3b;
    Qwen3-4B; Phi-3.5-MoE) over phase 5's 24-request trace,
    use_flash_decode off then on; with ``profile``, device time by kernel
    family over batch 0's prefill and steps. Both runs are held to the
    greedy full-forward oracle and to each other, or, without
    ``full_forward_oracle`` (MoE: the prefill routes at the prompt's
    capacity, not the oracle's): the flag-on run served again under
    ``StepCheck`` (each decode step held to blocked attention, the flag-off
    route, on the same cache); the flag-off run has no independent oracle.
    Returns the flag-on run's flash_decode launches."""
    import dataclasses

    from repro_torch.launch.serve import BatchedServer, Request
    from repro_torch.models.model import forward, init_cache
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
                                              padded, TRACE["max_new"] - 1,
                                              profile)
        runs[flash] = dict(outs=outs, wall=wall, counts=counts, peak=peak,
                           live_before=live_before, step_ms=step_ms,
                           family=family, tokens=sum(len(o) for o in outs))
        del server
    if full_forward_oracle:
        dense = oracle_weights(params_q, cfg)
        ties = {f: check_greedy(torch, forward, dense, cfg, padded,
                                runs[f]["outs"], f"use_flash_decode={f} vs "
                                f"oracle") for f in runs}
        del dense
        oracle = ("full forward over the dequantized weights on the "
                  "left-padded prompts")
        parted = compare_runs(runs[False]["outs"], runs[True]["outs"],
                              {(i, j) for t in ties.values()
                               for i, j, _ in t}, "flash off vs on")
    else:
        ties = {False: []}
        check = StepCheck(torch, ref, cfg)
        server = BatchedServer(params_q, dataclasses.replace(
            cfg, use_flash_decode=True), device="cuda", **LEGACY)
        with check:
            outs = check.watch_batched(server, cfg).generate(reqs)
        if outs != runs[True]["outs"]:
            raise AssertionError("the checked flag-on run's tokens are not "
                                 "the timed run's")
        ties[True] = check.parted
        log("step_check", arch=cfg.name, run="BatchedServer flag on",
            **check.counts())
        parted = [i for i, (a, b) in enumerate(zip(runs[False]["outs"],
                                                    runs[True]["outs"]))
                  if a != b]
        oracle = ("flag off: none (a full forward routes at another "
                  "capacity); flag on: each decode step again with blocked "
                  "attention on the same cache (StepCheck)")
    for f, r in runs.items():
        log("serving_legacy", arch=cfg.name, use_flash_decode=f,
            requests=len(reqs), batches=n_batches, decode_steps=steps,
            tokens=r["tokens"], wall_s=r["wall"],
            tokens_per_s=r["tokens"] / r["wall"], step_ms=r["step_ms"],
            launches=r["counts"], cache_bytes=kv_bytes, peak_bytes=r["peak"],
            live_bytes_at_start=r["live_before"], near_ties=ties[f],
            profile_ms_by_family=r["family"],
            profile_window=(f"prefill + {TRACE['max_new'] - 1} decode steps "
                            f"of batch 0" if profile else None))
    log("serving_legacy_check", arch=cfg.name, parted_at=parted,
        outputs_identical=not parted, oracle=oracle)
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


# ---------------------------------------------------------------------------
# phase 7: the calibrated base methods and the other search objectives
# ---------------------------------------------------------------------------

BASE_METHODS = ("gptq", "awq", "omniquant")
# 7a / 7b's depth: 4 of opt-1.3b's 24 layers (a cut: GPTQ's host-bound row
# loop, run twice, took 124 s of the script's 570-710 s at full depth and
# 49 s at 12 layers, the depth from phase 12 until phase 15 was added)
BASE_LAYERS = 4
# 7a's OmniQuant runs 20 Adam steps a block, not the default 200 (cut: the
# per-step ms is logged; 7c runs the default on opt-tiny)
OMNI_STEPS = 20
OBJ_STEPS = 4
BASE_OBJECTIVES = ("swd_actmatch", "saliency_ce")
CHOICE_TIE = 1e-6     # relative loss gap under which AWQ's grid picks may part


def base_method_gq_launches(method, cfg):
    """``group_quant`` launches of one ``quantize_model(method)`` call on a
    dense ``cfg``, with or without the fused search (the same count: the
    search's initial stack quantizes the stacked FFN leaves that the plain
    FFN fake-quant would):

    - the attention freeze: one launch per stacked leaf (wq, wk, wv, wo): 4;
    - the FFN: one per stacked leaf (up, down, and gate where there is one);
    - AWQ, per layer: 20 α × (up, down[, gate]) plus 10 clip ratios × the
      clipped weights (up, down, wq, wk, wv, wo[, gate]): 20 × 2 + 10 × 6 =
      100 on opt;
    - GPTQ and OmniQuant round with their own code, never ``group_quant``.
    """
    from repro_torch.core.awq import ALPHA_GRID, CLIP_GRID

    n_ffn = 3 if cfg.gated_mlp else 2
    n = 4 + n_ffn
    if method == "awq":
        n += cfg.n_layers * (ALPHA_GRID * n_ffn + CLIP_GRID * (n_ffn + 4))
    return n


def choices_agree(card, cpu, rel_gap=CHOICE_TIE):
    """AWQ's per-layer grid choices on the card against the CPU's
    (``PTQResult.base["choices"]``). Returns the partings, each with its
    relative loss gap on the CPU; raises if a pick parts at a gap of
    ``rel_gap`` or more (not a near tie)."""
    parted = []
    for i, (a, b) in enumerate(zip(card, cpu)):
        grids = [("alpha", a["alpha"], b["alpha"])] + [
            (f"clip {k}", a["clip"][k], b["clip"][k]) for k in sorted(b["clip"])]
        for what, ga, gb in grids:
            if ga.index == gb.index:
                continue
            lo = gb.losses[gb.index]
            gap = abs(gb.losses[ga.index] - lo) / max(abs(lo), 1e-30)
            parted.append({"layer": i, "grid": what, "card": ga.index,
                           "cpu": gb.index, "rel_gap": gap})
            if gap >= rel_gap:
                raise AssertionError(
                    f"AWQ layer {i} {what}: the card picks {ga.index}, the "
                    f"CPU {gb.index}, {gap:.3g} apart (not a near tie)")
    return parted


def within_one_step(got, want, bits, group, atol=None):
    """The ``group_quant`` bar (``tests/test_kernels.py``'s
    ``_assert_within_one_step``) on weights (..., K, N): at most one
    quantization step apart, and a step apart (more than half a step) on
    < 0.1 % of elements; with ``atol``, the GPTQ bar: more than ``atol``
    apart on < 0.1 %. The step of each group is its range over q_max in
    ``want``. Returns the fraction of elements apart."""
    import numpy as np
    got = got.detach().cpu().double().numpy()
    want = want.detach().cpu().double().numpy()
    K, N = want.shape[-2:]
    g = want.reshape(-1, K // group, group, N)
    step = np.broadcast_to((g.max(2, keepdims=True) - g.min(2, keepdims=True))
                           / ((1 << bits) - 1), g.shape)
    diff = np.abs(got.reshape(g.shape) - g)
    if np.any(diff > step * 1.001 + 1e-6):
        raise AssertionError("weights differ by more than one step")
    frac = float(np.mean(diff > (0.5 * step if atol is None else atol)))
    if frac >= 1e-3:
        raise AssertionError(f"{frac:.3%} of the weights are a step apart")
    return frac


def parts_only_at_ties(got, want, base, bits, group):
    """GPTQ's final weights: its output sits on a subset of each group's
    levels, so the pipeline's fake-quant re-rounds several % of it at exact
    round-half ties, where an ulp decides. ``got``/``want`` may part by
    one step there, and by 1e-3 at most elsewhere; ``base`` is the GPTQ
    output ``want`` was quantized from. Returns the fraction parted."""
    import numpy as np
    got = got.detach().cpu().double().numpy()
    want = want.detach().cpu().double().numpy()
    base = base.detach().cpu().float().numpy()
    K, N = want.shape[-2:]
    g = base.reshape(-1, K // group, group, N)
    mx, mn = g.max(2, keepdims=True), g.min(2, keepdims=True)
    scale = np.maximum((mx - mn) / np.float32((1 << bits) - 1), 1e-8)
    t = (g / scale + np.clip(np.round(-mn / scale), 0, (1 << bits) - 1))
    tie = np.abs(t - np.floor(t) - 0.5) < 1e-4
    diff = np.abs(got.reshape(g.shape) - want.reshape(g.shape))
    if np.any(diff[~tie] > 1e-3):
        raise AssertionError("GPTQ weights part away from a round-half tie")
    if np.any(diff > np.broadcast_to(scale, g.shape) * 1.001 + 1e-6):
        raise AssertionError("GPTQ weights part by more than one step")
    return float(np.mean(diff > 1e-3))


def phase_base_methods(torch, ops, cfg, qcfg):
    """7a and 7b on random-init ``cfg`` (opt-1.3b at full width,
    BASE_LAYERS deep), seed 0, with phase 2's calibration and held-out
    sets. Returns 7a's launch counts by kernel and run ("awq",
    "awq+search", ...)."""
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.search import SearchConfig
    from repro_torch.core.taps import capture_dense_taps
    from repro_torch.data.calib import calibration_tensor
    from repro_torch.models.model import forward, init_params, lm_loss

    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    calib = calibration_tensor(cfg.vocab_size, n_seqs=4, seq_len=512,
                               seed=99, device="cuda")
    held = calibration_tensor(cfg.vocab_size, n_seqs=4, seq_len=512,
                              seed=123, device="cuda")

    def ppl(p):
        logits = forward(p, cfg, held)
        return math.exp(float(lm_loss(logits[:, :-1], held[:, 1:],
                                      cfg.vocab_size)))

    def timed(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (out, time.perf_counter() - t0, dict(ops.LAUNCHES),
                torch.cuda.max_memory_allocated())

    ppl_fp = ppl(params)
    taps, taps_s, _, taps_peak = timed(
        lambda: capture_dense_taps(params, cfg, calib))
    taps_bytes = sum(t.numel() * t.element_size() for t in taps.values())
    del taps
    log("taps", arch=cfg.name, calib=list(calib.shape), seconds=taps_s,
        bytes=taps_bytes, peak_bytes=taps_peak)
    scfg = SearchConfig(steps=STEPS, fused_kernel=True, log_every=0)
    launches = {"group_quant": {}, "transform_quant": {}}
    # GPTQ's rows a layer: the K of wq, wk, wv, wo, up (gate), down
    rows_per_layer = (4 + cfg.gated_mlp) * cfg.d_model + cfg.d_ff \
        + cfg.n_heads * cfg.resolved_head_dim
    for method in BASE_METHODS:
        alone, base_s, counts, peak = timed(lambda: quantize_model(
            params, cfg, qcfg, method, calib, omniquant_steps=OMNI_STEPS,
            device="cuda"))
        ppl_base = ppl(alone.params_q)
        info, label = alone.base, alone.method
        del alone
        res, wall_s, counts_s, peak_s = timed(lambda: quantize_model(
            params, cfg, qcfg, method, calib, scfg,
            omniquant_steps=OMNI_STEPS, device="cuda"))
        sr, label_search = res.search, res.method
        ppl_search = ppl(res.params_q)
        del res
        want_gq = base_method_gq_launches(method, cfg)
        extra = {}
        if method == "awq":
            extra = {"alpha_index": [c["alpha"].index for c in info["choices"]],
                     "clip_index": {k: [c["clip"][k].index
                                        for c in info["choices"]]
                                    for k in info["choices"][0]["clip"]}}
        elif method == "omniquant":
            losses = info["losses"]
            extra = {"block_loss_first": float(losses[:, 0].mean()),
                     "block_loss_last": float(losses[:, -1].mean()),
                     "omni_steps": OMNI_STEPS, "omni_steps_cut_from": 200,
                     "step_ms_approx": 1e3 * (base_s - taps_s)
                     / (cfg.n_layers * OMNI_STEPS)}
            if not bool(torch.isfinite(losses).all()):
                raise AssertionError("non-finite OmniQuant block losses")
        elif method == "gptq":
            extra = {"rows": cfg.n_layers * rows_per_layer,
                     "row_ms_approx": 1e3 * (base_s - taps_s)
                     / (cfg.n_layers * rows_per_layer)}
        log("base_method", method=label, method_search=label_search,
            ppl_fp32=ppl_fp, ppl_base=ppl_base, ppl_base_search=ppl_search,
            initial_loss=sr.initial_loss, final_loss=sr.final_loss,
            accept_rate=sr.accept_rate, steps=STEPS,
            taps_s=taps_s, base_wall_s=base_s, method_s=base_s - taps_s,
            search_s=STEPS / sr.stats["proposals_per_sec"],
            search_wall_s=wall_s, peak_bytes=peak, peak_bytes_search=peak_s,
            launches=counts, launches_search=counts_s,
            group_quant_expected=want_gq, **extra)
        nums = [ppl_fp, ppl_base, ppl_search, sr.initial_loss, sr.final_loss] \
            + [h[1] for h in sr.history]
        if not all(math.isfinite(x) for x in nums):
            raise AssertionError(f"{method}: non-finite numbers {nums}")
        if not sr.final_loss <= sr.initial_loss:
            raise AssertionError(f"{method}: search final loss above initial")
        for what, c in (("alone", counts), ("search", counts_s)):
            if c["group_quant"] != want_gq:
                raise AssertionError(f"{method} {what}: group_quant launches "
                                     f"{c['group_quant']} != {want_gq}")
        if counts["transform_quant"] != 0 or \
                counts_s["transform_quant"] != 2 * STEPS * scfg.population:
            raise AssertionError(f"{method}: transform_quant launches "
                                 f"{counts['transform_quant']} / "
                                 f"{counts_s['transform_quant']}")
        for kernel in launches:
            launches[kernel][method] = counts[kernel]
            launches[kernel][method + "+search"] = counts_s[kernel]

    # 7b: the other two objectives, a fused search after RTN
    for objective in BASE_OBJECTIVES:
        res, wall_s, counts, peak = timed(lambda: quantize_model(
            params, cfg, qcfg, "rtn", calib,
            SearchConfig(steps=OBJ_STEPS, fused_kernel=True,
                         objective=objective, log_every=0), device="cuda"))
        sr = res.search
        del res
        log("objective_search", objective=objective,
            stats_objective=sr.stats["objective"], steps=OBJ_STEPS,
            initial_loss=sr.initial_loss, final_loss=sr.final_loss,
            losses=[h[1] for h in sr.history], accept_rate=sr.accept_rate,
            wall_s=wall_s, peak_bytes=peak, launches=counts)
        if sr.stats["objective"] != objective:
            raise AssertionError(f"stats objective {sr.stats['objective']}")
        if not all(math.isfinite(h[1]) for h in sr.history) or \
                not sr.final_loss <= sr.initial_loss:
            raise AssertionError(f"{objective}: losses {sr.history}")
        if counts["transform_quant"] != 2 * OBJ_STEPS:
            raise AssertionError(f"{objective}: launches {counts}")
    del params, calib, held
    torch.cuda.empty_cache()
    return launches


OMNI_AGREE_STEPS = 10   # tests/test_baselines.py: 10 block-loss steps at rtol 1e-3


def ulp_moved(torch, tree, gen):
    """``tree`` with every float element moved one ulp up, down or not, at
    random (``gen``, a CPU generator)."""
    if isinstance(tree, dict):
        return {k: ulp_moved(torch, v, gen) for k, v in tree.items()}
    u = torch.randint(-1, 2, tree.shape, generator=gen).to(tree.device)
    up = torch.nextafter(tree, torch.full_like(tree, math.inf))
    down = torch.nextafter(tree, torch.full_like(tree, -math.inf))
    return torch.where(u > 0, up, torch.where(u < 0, down, tree))


def omni_partings(torch, card, ref, params, cfg, calib, qcfg, draws=2):
    """OmniQuant's runs (``PTQResult``s) on the device under test and on the
    yardstick's device, from the same weights. A layer whose block losses
    part by more than 1e-5 relative at some step went down another
    trajectory after a code flipped at a near tie in the rounding STE
    (ROADMAP.md parity notes). Then the first OMNI_AGREE_STEPS steps must
    agree at rtol 1e-3, and the quantized models' calibration CE within
    twice the yardstick's own spread under one-ulp changes of its input
    weights, or 1e-3 relative, the larger (the bars of
    ``tests/test_torch_baselines.py``). ``params`` and ``calib`` are on the
    yardstick's device. Returns the parted layers, each with its first
    parting step, and the CE comparison (empty without a parting)."""
    from repro_torch.core.objective import calib_ce
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.models.model import forward

    lc = card.base["losses"].cpu().double()
    lr = ref.base["losses"].cpu().double()
    rel = (lc - lr).abs() / lr.abs().clamp_min(1e-30)
    parted = [{"layer": i, "first_step": int(torch.nonzero(rel[i] > 1e-5)[0, 0])}
              for i in range(rel.shape[0]) if bool((rel[i] > 1e-5).any())]
    if not parted:
        return {}
    head = slice(0, OMNI_AGREE_STEPS)
    within(torch, [lc[:, head]], [lr[:, head]], rtol=1e-3, atol=0.0,
           what="OmniQuant block losses, first steps")

    def ce(params_q):
        toks = calib.to(params_q["embed"]["tok"].device)
        return float(calib_ce(forward(params_q, cfg, toks), toks,
                              cfg.vocab_size))

    ce_ref, ce_card = ce(ref.params_q), ce(card.params_q)
    gen = torch.Generator().manual_seed(0)
    spread = max(abs(ce(quantize_model(
        ulp_moved(torch, params, gen), cfg, qcfg, "omniquant", calib,
        device=calib.device).params_q) - ce_ref) for _ in range(draws))
    bar = max(1e-3 * abs(ce_ref), 2 * spread)
    if abs(ce_card - ce_ref) > bar:
        raise AssertionError(f"OmniQuant: calibration CE {ce_card} vs "
                             f"{ce_ref}, beyond {bar:.3g}")
    return {"layers": parted, "ce": ce_card, "ce_ref": ce_ref,
            "ulp_spread": spread, "bar": bar}


def within_one_step_but(got, want, bits, group, spared):
    """``within_one_step`` over every layer of (L, K, N) weights; where that
    fails, over the layers not in ``spared`` (held by another bar, which
    the caller has checked). Returns (the fraction apart, the layers the
    weight bar left to the other one)."""
    try:
        return within_one_step(got, want, bits, group), []
    except AssertionError:
        keep = [i for i in range(want.shape[0]) if i not in spared]
        if len(keep) == want.shape[0]:
            raise
        frac = within_one_step(got[keep], want[keep], bits, group) \
            if keep else 0.0
        return frac, sorted(spared)


def small_base_methods(torch, cfg, params, calib, devs, label):
    """GPTQ, AWQ and OmniQuant (200 steps a block) on ``devs`` (the
    yardstick's device, then the device under test) from the same
    weights and tokens: weights within ``group_quant``'s bar, GPTQ's output
    within its own and parting after the pipeline's fake-quant only at
    round-half ties, AWQ's α and clip picks equal or parted at a printed
    near tie (those layers' weights not compared), OmniQuant's up / down
    within the weight bar, or, where that fails, all but the layers that
    ``omni_partings`` found parted and held by the calibration CE."""
    from repro_torch.core import rtn
    from repro_torch.core.gptq import gptq_process_dense
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.quant import QuantConfig
    from repro_torch.models.model import quantizable_paths

    qcfg = QuantConfig(bits=2, group_size=32)
    ref_dev, dev = (torch.device(d) for d in devs)
    for method in BASE_METHODS:
        runs = [quantize_model(to_device(params, d), cfg, qcfg, method,
                               calib.to(d), device=d) for d in (ref_dev, dev)]
        ref_run, dev_run = runs
        parted, omni = [], {}
        if method == "awq":
            parted = choices_agree(dev_run.base["choices"],
                                   ref_run.base["choices"])
        if method == "gptq":
            bases = [gptq_process_dense(to_device(params, d), cfg,
                                        calib.to(d), qcfg)
                     for d in (ref_dev, dev)]
        if method == "omniquant":
            omni = omni_partings(torch, dev_run, ref_run,
                                 to_device(params, ref_dev), cfg,
                                 calib.to(ref_dev), qcfg)
        fracs, by_ce = {}, {}
        for path in quantizable_paths(params):
            card = rtn.get_by_path(dev_run.params_q, path)
            cpu = rtn.get_by_path(ref_run.params_q, path)
            name = path[-1]
            layers = [i for i in range(cfg.n_layers)
                      if not any(p["layer"] == i and p["grid"] in
                                 ("alpha", f"clip {name}") for p in parted)]
            if method == "omniquant" and name in ("up", "down"):
                fracs[name], by_ce[name] = within_one_step_but(
                    card, cpu, 2, 32,
                    {o["layer"] for o in omni.get("layers", ())})
            elif method == "gptq":
                within_one_step(rtn.get_by_path(bases[1], path),
                                rtn.get_by_path(bases[0], path), 2, 32,
                                atol=1e-3)
                fracs[name] = parts_only_at_ties(
                    card, cpu, rtn.get_by_path(bases[0], path), 2, 32)
            elif layers:
                fracs[name] = within_one_step(card[layers], cpu[layers], 2, 32)
        log("small_base_method", method=method, arch=label,
            devices=list(devs), parted_frac=fracs, choices_parted=parted,
            omniquant_parted=omni, layers_held_by_ce=by_ce)


def phase_small_base_methods(torch, devs=("cpu", "cuda")):
    """7c: each base method and each of 7b's objectives on opt-tiny reduced,
    on the card and on the CPU (where ``fake_quant`` runs its plain
    version), from the same weights, tokens, proposals and SWD directions."""
    from repro_torch.configs import get_config
    from repro_torch.core import invariance as inv
    from repro_torch.core import rtn
    from repro_torch.core.objective import SWDActMatchObjective
    from repro_torch.core.quant import QuantConfig, fake_quant
    from repro_torch.core.search import SearchConfig
    from repro_torch.data.calib import calibration_tensor
    from repro_torch.models.model import init_params
    from repro_torch.search import run

    cfg = get_config("opt-tiny").reduced()
    qcfg = QuantConfig(bits=2, group_size=32)
    params = init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    calib = calibration_tensor(cfg.vocab_size, n_seqs=4, seq_len=64,
                               device="cpu")
    small_base_methods(torch, cfg, params, calib, devs, "opt-tiny (reduced)")
    devs = [torch.device(d) for d in devs]

    # SWD's directions drawn once on the CPU: a generator on the card draws
    # other numbers
    dirs = torch.randn((cfg.d_model, 64),
                       generator=torch.Generator().manual_seed(0))
    for objective in BASE_OBJECTIVES:
        hist = []
        for d in devs:
            p = to_device(params, d)
            base = rtn.map_quantizable(p, lambda w, _: fake_quant(w, qcfg),
                                       only=lambda q: q[-1] not in ("up",
                                                                    "down"))
            objv = SWDActMatchObjective(dirs=dirs) \
                if objective == "swd_actmatch" else objective
            res = run(p, base, cfg, qcfg, calib.to(d),
                      SearchConfig(steps=LANE_STEPS, fused_kernel=True,
                                   log_every=0),
                      objective=objv, proposals=CpuProposals(inv, 3, d))
            if res.stats["objective"] != objective:
                raise AssertionError(f"stats objective {res.stats}")
            hist.append(res.history)
        compared, parted = histories_agree(hist[1], hist[0],
                                           f"{objective} card vs CPU")
        log("small_objective", objective=objective, steps=LANE_STEPS,
            compared=compared, parted_at=parted,
            card_losses=[h[1] for h in hist[1]],
            cpu_losses=[h[1] for h in hist[0]])


# ---------------------------------------------------------------------------
# phase 8: the rest of the search engine
# ---------------------------------------------------------------------------

ISL_STEPS = 6
MEM_K = 8
MEM_STEPS = 3
TABU_STEPS = 8
SEARCH_KERNELS = ("group_quant", "transform_quant")
SMOKE_OUT = "build/smoke"      # the CLI's rows and metrics (git-ignored)
COUNTERS = ("search_proposals_total", "search_accepts_total",
            "search_migrations_total")


def search_launches(cfg, scfg, stats):
    """``group_quant`` and ``transform_quant`` launches of one
    ``repro_torch.search.run`` call. Each built unit quantizes its 2-D
    weights (up, down, and gate on a gated model), one launch each:
    ``transform_quant`` on the fused lane, ``group_quant`` on the unfused
    one. The initial stack takes one ``group_quant`` per weight; K units
    are built on each island step the tabu memory did not skip, and one
    more on each accepted cached move (``stats["tabu_skips"]``,
    ``stats["tabu_rebuilds"]``)."""
    n_w = 2 + int(cfg.gated_mlp)
    K = max(int(scfg.population), 1)
    built = scfg.steps * max(int(scfg.islands), 1) - stats["tabu_skips"]
    units = K * built + stats["tabu_rebuilds"]
    fused = bool(scfg.fused_kernel)
    return {"group_quant": n_w + (0 if fused else n_w * units),
            "transform_quant": n_w * units if fused else 0}


class StateProposals:
    """A state-deterministic proposal source: the K candidates depend only
    on (t_u, k), drawn on the CPU from a generator re-seeded with ``seed``
    at every call, then handed over on ``device`` — the counterpart of the
    reference's ``_ConstProposalAdapter`` (``tests/test_search_v2.py``).
    An unaccepted state therefore re-proposes the same points."""

    def __init__(self, torch, inv, device, seed=7):
        self.torch, self.inv, self.device, self.seed = torch, inv, device, seed

    def __call__(self, t_u, k, pcfg):
        gen = self.torch.Generator().manual_seed(self.seed)
        t_cpu = self.inv.FFNTransform(*(x.cpu() for x in t_u))
        return [self.inv.FFNTransform(*(x.to(self.device) for x in
                                        self.inv.propose(gen, t_cpu, pcfg)))
                for _ in range(k)]


class CpuProposals:
    """Island ``index``'s native source drawn on the CPU (with ``proposer``,
    ``inv.propose`` by default), handed over on ``device`` (as phase 1's
    card-against-CPU run does)."""

    def __init__(self, inv, seed, device, proposer=None):
        self.src, self.inv, self.device = inv.NativeProposals(
            seed, "cpu", proposer), inv, device

    def __call__(self, t_u, k, pcfg):
        t_cpu = self.inv.FFNTransform(*(x.cpu() for x in t_u))
        return [self.inv.FFNTransform(*(x.to(self.device) for x in c))
                for c in self.src(t_cpu, k, pcfg)]


def histories_identical(ha, hb, what):
    """True when two histories are equal as Python floats; else log where
    they part and by how much, and hold them to the reference's own bar for
    install modes (``tests/test_search_v2.py``: same steps and accept
    flags, losses within atol 1e-5)."""
    if ha == hb:
        return True
    first = next(i for i, (a, b) in enumerate(zip(ha, hb)) if a != b)
    diff = max(abs(x - y) for a, b in zip(ha, hb) for x, y in
               zip(a[1:4], b[1:4]))
    log("histories_part", what=what, first_step=ha[first][0],
        max_abs_diff=diff)
    for a, b in zip(ha, hb):
        if a[0] != b[0] or a[4] != b[4] or \
                max(abs(x - y) for x, y in zip(a[1:4], b[1:4])) > 1e-5:
            raise AssertionError(f"{what}: step {b[0]} {a} vs {b}")
    return False


def phase_search_engine(torch, ops, cfg, qcfg):
    """8a-8d on random-init opt-1.3b at full width and depth (phase 2's
    weights, seed 0, and its 4 x 512 calibration tokens), through
    ``repro_torch.search.run`` after RTN froze the attention weights, as
    ``quantize_model`` does; 8e the search CLI. Returns the launch counts
    by kernel and run."""
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.core import invariance as inv
    from repro_torch.core import rtn
    from repro_torch.core.quant import fake_quant
    from repro_torch.core.search import SearchConfig
    from repro_torch.data.calib import calibration_tensor
    from repro_torch.models.model import init_params
    from repro_torch.search import run

    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    calib = calibration_tensor(cfg.vocab_size, n_seqs=4, seq_len=512,
                               seed=99, device="cuda")
    base = rtn.map_quantizable(params, lambda w, p: fake_quant(w, qcfg),
                               only=lambda p: p[-1] not in ("up", "down"))
    reg = obs.get_registry()
    launches = {k: {} for k in SEARCH_KERNELS}

    def search(label, proposals=None, **kw):
        scfg = SearchConfig(fused_kernel=True, log_every=0,
                            **{"population": 2, **kw})
        before = {n: reg.counter(n).total() for n in COUNTERS}
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = run(params, base, cfg, qcfg, calib, scfg, proposals=proposals)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = {k: ops.LAUNCHES[k] for k in SEARCH_KERNELS}
        delta = {n: reg.counter(n).total() - before[n] for n in COUNTERS}
        st = res.stats
        accepts = sum(h[4] for hist in res.island_histories
                      for h in hist[1:])
        want = {"search_proposals_total": st["proposals"],
                "search_accepts_total": accepts,
                "search_migrations_total": st["migrations"]}
        if delta != want:
            raise AssertionError(f"{label}: registry deltas {delta} != "
                                 f"stats {want}")
        if counts != search_launches(cfg, scfg, st):
            raise AssertionError(f"{label}: launches {counts} != "
                                 f"{search_launches(cfg, scfg, st)}")
        hists = res.island_histories
        if not all(math.isfinite(h[1]) for hist in hists for h in hist):
            raise AssertionError(f"{label}: non-finite losses {hists}")
        if not res.final_loss <= min(hist[0][1] for hist in hists) or \
                res.initial_loss not in [hist[0][1] for hist in hists]:
            raise AssertionError(f"{label}: initial {res.initial_loss} / "
                                 f"final {res.final_loss} vs {hists}")
        for k in SEARCH_KERNELS:
            launches[k][label] = counts[k]
        return res, seconds, counts

    def row(label, res, seconds, counts, **extra):
        st = res.stats
        log("search_engine", run=label, seconds=seconds,
            proposals_per_sec=st["proposals_per_sec"],
            initial_loss=res.initial_loss, final_loss=res.final_loss,
            accept_rate=res.accept_rate,
            island_losses=[[h[1] for h in hist]
                           for hist in res.island_histories],
            island_accepts=[[int(h[4]) for h in hist[1:]]
                            for hist in res.island_histories],
            launches=counts,
            stats={k: v for k, v in st.items() if k != "proposals_per_sec"},
            **extra)

    # 8a: islands, migration and island 0's independence of the count
    one = search("islands=1", steps=ISL_STEPS)
    row("islands=1", *one)
    two = search("islands=2,migrate_every=0", steps=ISL_STEPS, islands=2,
                 migrate_every=0)
    row("islands=2,migrate_every=0", *two)
    if two[0].island_histories[0] != one[0].history:
        raise AssertionError("island 0 of 2 walked another path than the "
                             "single chain")
    mig = search("islands=2,migrate_every=2", steps=ISL_STEPS, islands=2,
                 migrate_every=2)
    row("islands=2,migrate_every=2", *mig,
        migrations=mig[0].stats["migrations"])
    del one, two, mig

    # 8b: each island climbs on its own 2 sequences
    shd = search("shard_calib", steps=4, islands=2, population=1,
                 shard_calib=True)
    hists = shd[0].island_histories
    row("shard_calib", *shd, step0_losses=[h[0][1] for h in hists],
        island_final=[min(x[1] for x in h if x[4]) for h in hists])
    if hists[0][0][1] == hists[1][0][1]:
        raise AssertionError("both calibration slices gave one step-0 loss")
    del shd

    # 8c: the two install modes with the allocator's peak
    mem = {}
    for mode in ("unit", "stack"):
        res, seconds, counts = search(
            f"install={mode}", steps=MEM_STEPS, population=MEM_K,
            install=mode, measure_memory=True)
        row(f"install={mode}", res, seconds, counts)
        mem[mode] = (res.history, res.stats)
        del res
        torch.cuda.empty_cache()
    unit_bytes = 4 * (2 * cfg.d_model * cfg.d_ff + cfg.d_ff)
    want = {"unit": MEM_K * unit_bytes,
            "stack": MEM_K * cfg.n_layers * unit_bytes}
    su, ss = mem["unit"][1], mem["stack"][1]
    identical = histories_identical(mem["unit"][0], mem["stack"][0],
                                    "install unit vs stack")
    log("install_modes", identical=identical,
        stack_bytes=su["stack_bytes"], stack_bytes_expected=cfg.n_layers
        * unit_bytes, candidate_batch_bytes={"unit": su[
            "candidate_batch_bytes"], "stack": ss["candidate_batch_bytes"]},
        expected=want, ratio=ss["candidate_batch_bytes"]
        / su["candidate_batch_bytes"],
        peak_live_bytes={"unit": su["peak_live_bytes"],
                         "stack": ss["peak_live_bytes"]})
    if su["stack_bytes"] != ss["stack_bytes"] or \
            su["stack_bytes"] != cfg.n_layers * unit_bytes:
        raise AssertionError(f"stack bytes {su['stack_bytes']} / "
                             f"{ss['stack_bytes']}")
    if {"unit": su["candidate_batch_bytes"],
            "stack": ss["candidate_batch_bytes"]} != want or \
            ss["candidate_batch_bytes"] != \
            cfg.n_layers * su["candidate_batch_bytes"]:
        raise AssertionError("candidate batch bytes off the memory model")
    if not su["peak_live_bytes"] < ss["peak_live_bytes"]:
        raise AssertionError("unit install peak not below stack install")
    del mem

    # 8d: the tabu memory, with larger scale moves than the paper's (σ_s
    # 0.5, not 0.01). On these weights the greedy chain rejects steps 6 and
    # 7, and seed 0's unit picks revisit unit 0 (step 6) at step 8 with the
    # state unchanged, so the memory replays that whole step.
    wide = inv.ProposalConfig(sigma_s=0.5)
    src = StateProposals(torch, inv, torch.device("cuda"))
    plain = search("tabu=0", src, steps=TABU_STEPS, proposal=wide)
    row("tabu=0", *plain)
    tabu = search("tabu=64", src, steps=TABU_STEPS, proposal=wide, tabu=64)
    row("tabu=64", *tabu)
    if tabu[0].history != plain[0].history:
        raise AssertionError("the tabu memory changed the history")
    if not tabu[0].stats["tabu_hits"] > 0:
        raise AssertionError("no tabu hit")
    hot = [search(f"tabu=64,T=5#{i}", src, steps=TABU_STEPS, tabu=64,
                  temperature=5.0, anneal="constant") for i in (1, 2)]
    row("tabu=64,T=5", *hot[0])
    if hot[0][0].history != hot[1][0].history:
        raise AssertionError("annealed tabu run not deterministic")
    pi = hot[0][0].transforms.pi
    if not torch.equal(torch.sort(pi, dim=1).values,
                       torch.arange(cfg.d_ff, device=pi.device).expand_as(pi)):
        raise AssertionError("a pi is no longer a permutation")
    del plain, tabu, hot, params, base, calib
    torch.cuda.empty_cache()

    # 8e: the search CLI on the card (its .reduced() config)
    from repro_torch.launch.search import main as search_main
    out = f"{SMOKE_OUT}/BENCH_search.json"
    common = ["--out", out, "--metrics-out", f"{SMOKE_OUT}/metrics.json"]
    rows = {}
    for name, argv in (
            ("islands", ["--islands", "2", "--population", "2", "--steps",
                         "8", "--fused"]),
            ("mem-unit", ["--measure-mem", "--install", "unit",
                          "--population", "8", "--steps", "4"]),
            ("mem-stack", ["--measure-mem", "--install", "stack",
                           "--population", "8", "--steps", "4"])):
        ops.reset_launch_counts()
        search_main(argv + common, device="cuda")
        rows[name] = json.loads(Path(out).read_text())[-1]
        log("search_cli", argv=argv, row=rows[name],
            launches={k: ops.LAUNCHES[k] for k in SEARCH_KERNELS})
    u, s = rows["mem-unit"], rows["mem-stack"]
    n_units = get_config("opt-tiny").reduced().n_layers
    if not u["peak_live_bytes"] < s["peak_live_bytes"] or \
            u["stack_bytes"] != s["stack_bytes"] or \
            s["candidate_batch_bytes"] != n_units * u["candidate_batch_bytes"]:
        raise AssertionError(f"CLI memory rows {u} / {s}")
    if "migrations=" not in rows["islands"]["derived"]:
        raise AssertionError(f"CLI row {rows['islands']}")
    return launches


def phase_small_search_engine(torch, devs=("cpu", "cuda")):
    """8f: opt-tiny reduced on the card against the CPU, with the same
    proposals drawn on the CPU: islands with migration, tabu and sharded
    calibration; the same with ``install="stack"``; and a warm annealed
    tabu run with the state-deterministic source, where cached moves are
    accepted and rebuilt (on the CPU, by the run's data, at least once).
    ``devs``: the yardstick's device, then the device under test."""
    from repro_torch.configs import get_config
    from repro_torch.core import invariance as inv
    from repro_torch.core import rtn
    from repro_torch.core.quant import QuantConfig, fake_quant
    from repro_torch.core.search import SearchConfig
    from repro_torch.data.calib import calibration_tensor
    from repro_torch.models.model import init_params
    from repro_torch.search import run
    from repro_torch.search.islands import island_seed

    cfg = get_config("opt-tiny").reduced(n_kv_heads=4)
    qcfg = QuantConfig(bits=2, group_size=32)
    params = init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    calib = calibration_tensor(cfg.vocab_size, n_seqs=2, seq_len=64,
                               device="cpu")
    isl = dict(steps=LANE_STEPS, population=2, islands=2, migrate_every=2,
               tabu=16, shard_calib=True, seed=3)
    # T 3e-3 against Δ ≈ 2e-3 here: replayed (rejected) moves are accepted
    # about half the time
    cases = (("islands+tabu+shard", isl, "native"),
             ("islands+tabu+shard,stack", dict(isl, install="stack"),
              "native"),
             ("tabu,warm", dict(steps=16, population=2, tabu=16, seed=0,
                                temperature=3e-3, anneal="constant"),
              "state"))
    for label, kw, kind in cases:
        out = []
        for d in map(torch.device, devs):
            p = to_device(params, d)
            base = rtn.map_quantizable(p, lambda w, _: fake_quant(w, qcfg),
                                       only=lambda q: q[-1] not in ("up",
                                                                    "down"))
            n = kw.get("islands", 1)
            srcs = ([CpuProposals(inv, island_seed(kw["seed"], i), d)
                     for i in range(n)] if kind == "native"
                    else [StateProposals(torch, inv, d)])
            out.append(run(p, base, cfg, qcfg, calib.to(d),
                           SearchConfig(fused_kernel=True, log_every=0,
                                        **kw), proposals=srcs))
        cpu, card = out
        parted = []
        for i, (hc, hp) in enumerate(zip(card.island_histories,
                                         cpu.island_histories)):
            parted.append(histories_agree(hc, hp, f"{label} island {i}"))
        keys = ("migrations", "tabu_hits", "tabu_skips", "tabu_rebuilds")
        if all(p[1] is None for p in parted) and \
                any(card.stats[k] != cpu.stats[k] for k in keys):
            raise AssertionError(f"{label}: stats {card.stats} vs "
                                 f"{cpu.stats}")
        if kind == "state" and not cpu.stats["tabu_rebuilds"] > 0:
            raise AssertionError(f"{label}: no cached move was accepted")
        log("small_search_engine", run=label, parted=parted,
            **{k: [card.stats[k], cpu.stats[k]] for k in keys},
            card_losses=[[h[1] for h in hist]
                         for hist in card.island_histories],
            cpu_losses=[[h[1] for h in hist]
                        for hist in cpu.island_histories])


# ---------------------------------------------------------------------------
# phase 9: training and checkpoints, Table 1 on a port-trained model
# ---------------------------------------------------------------------------

TRAIN = dict(batch=4, seq=512)       # 9a: 2,048 tokens a step
# 9a's train() run: at lr 3e-4 (5 warm-up steps) the loss falls by ≈ 0.1 a
# few steps, under a step-to-step spread of ≈ 0.2 across batches (PERF.md
# §6, PR 20), so the first and last thirds are compared
TRAIN_STEPS = 10
TIMED_STEPS = 3                      # 9a's timed steady steps (2 profiled)
RESUME_STEPS = 3                     # 9b: 1 step, save, restore, 2 steps
ACCUM_TOL = dict(rtol=2e-3, atol=2e-4)   # tests/test_substrate.py's bar
RESUME_RTOL = 1e-5
SMALL_TRAIN_STEPS = 5
# device-kernel name fragments -> family for the train-step profile (first
# match wins)
TRAIN_FAMILIES = (("gemm", "matmul (cuBLAS)"), ("gemv", "matmul (cuBLAS)"),
                  ("cutlass", "matmul (cuBLAS)"), ("nvjet", "matmul (cuBLAS)"),
                  ("softmax", "softmax / log_softmax"),
                  ("index", "indexing (embedding gather, scatter-add)"),
                  ("scatter", "indexing (embedding gather, scatter-add)"),
                  ("reduce", "reductions"), ("memcpy", "copies"),
                  ("memset", "copies"), ("copy", "copies"),
                  ("elementwise", "elementwise"))


def state_leaves(state):
    """Every tensor of a (params, opt_state) train state, in a fixed order."""
    from repro_torch.optim.adamw import tree_leaves
    return [x for part in state for x in tree_leaves(part)]


def within(torch, got, want, rtol, atol, what):
    """Raises unless |got - want| <= atol + rtol |want| everywhere, over two
    lists of tensors; returns the largest |got - want|."""
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        diff = (a.float() - b.float()).abs()
        excess = float((diff - (atol + rtol * b.float().abs())).max())
        if excess > 0:
            raise AssertionError(f"{what}: leaf {i} {tuple(a.shape)} off the "
                                 f"bar by {excess}")
        worst = max(worst, float(diff.max()))
    return worst


def mem_available() -> int:
    """The host's MemAvailable (bytes, /proc/meminfo)."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    raise AssertionError("no MemAvailable in /proc/meminfo")


def phase_train(torch, cfg):
    """9a: ``train()`` on opt-1.3b (full width and depth) from phase 2's
    seed at batch 4 × 512; then TIMED_STEPS steady steps of the same train
    step with device time by family over two of them under the profiler,
    the optimizer alone, and ``accum_steps=2`` against the full batch.
    Returns (state, step_fn, tokens_at) for 9b."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import DataConfig, make_pipeline
    from repro_torch.launch.steps import _value_and_grad, make_train_step
    from repro_torch.launch.train import train
    from repro_torch.models import model as M
    from repro_torch.optim.adamw import (AdamWConfig, adamw_init,
                                         adamw_update, tree_leaves)

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params, losses, _ = train(steps=TRAIN_STEPS, lr=3e-4, cfg=cfg, seed=0,
                              log_every=1, device="cuda", **TRAIN)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    third = TRAIN_STEPS // 3
    if not all(math.isfinite(x) for x in losses) or \
            not statistics.mean(losses[-third:]) < statistics.mean(losses[:third]):
        raise AssertionError(f"9a: losses {losses} are not finite or do not "
                             f"fall")
    n_params = sum(x.numel() for x in tree_leaves(params))
    tokens = TRAIN["batch"] * TRAIN["seq"]
    # train()'s optimizer settings
    opt_cfg = AdamWConfig(lr=3e-4, total_steps=TRAIN_STEPS,
                          warmup_steps=max(TRAIN_STEPS // 20, 5))
    step_fn = make_train_step(cfg, opt_cfg)
    batch_at = make_pipeline(DataConfig(seq_len=TRAIN["seq"],
                                        global_batch=TRAIN["batch"],
                                        vocab_size=cfg.vocab_size))

    def tokens_at(s):
        return torch.from_numpy(batch_at(s).astype(np.int64)).to(dev)

    batch = {"tokens": tokens_at(0)}
    state = [(params, adamw_init(params))]
    del params
    metrics = []

    def one():
        p, o, m = step_fn(*state[0], batch)
        state[0] = (p, o)
        metrics.append(m)

    one()                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(TIMED_STEPS):
        t0 = time.perf_counter()
        one()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            one()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    by_family, by_kernel = defaultdict(float), {}
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", 0.0)
        if t > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            by_family[_family(ev.key, TRAIN_FAMILIES)] += t / 1e3 / 2
            by_kernel[ev.key[:100]] = (t / 1e3 / 2, ev.count // 2)
    if not by_family:
        raise AssertionError("9a: the profiler saw no device time")
    for m in metrics:
        if not all(math.isfinite(float(m[k])) for k in ("loss", "lr",
                                                         "grad_norm")):
            raise AssertionError(f"9a: non-finite metrics {m}")
    step_s = statistics.median(times)

    # the optimizer alone, on this state's gradients
    p, o = state[0]
    lossf = lambda pp, tt: M.lm_loss(M.forward(pp, cfg, tt)[:, :-1],  # noqa: E731
                                     tt[:, 1:], cfg.vocab_size)
    _, grads = _value_and_grad(lossf, p, batch["tokens"])
    opt_ms = time_ms(torch, lambda: adamw_update(p, grads, o, opt_cfg),
                     warmup=1, reps=5)
    del grads
    opt_bound, opt_by = bound_ms(optimizer_bytes(p), 0)

    # accum_steps=2 on the same batch against the full batch
    p1, o1, m1 = step_fn(p, o, batch)
    del o1
    p2, o2, m2 = make_train_step(cfg, opt_cfg, accum_steps=2)(p, o, batch)
    del o2
    loss_diff = abs(float(m1["loss"]) - float(m2["loss"]))
    if not loss_diff < 1e-4:
        raise AssertionError(f"9a: accum_steps=2 loss parts by {loss_diff}")
    param_diff = within(torch, tree_leaves(p2), tree_leaves(p1),
                        what="9a accum", **ACCUM_TOL)
    del p1, p2
    flops = 6 * n_params * tokens
    log("train", arch=cfg.name, n_params=n_params, batch=TRAIN["batch"],
        seq=TRAIN["seq"], train_steps=TRAIN_STEPS, train_wall_s=train_s,
        losses=losses, step_ms=step_s * 1e3,
        step_ms_range=[min(times) * 1e3, max(times) * 1e3],
        tokens_per_s=tokens / step_s, tflops=flops / step_s / 1e12,
        share_of_fp32_peak=flops / step_s / FP32_OPS_PER_S,
        peak_bytes=peak, profile_window_ms=window_ms / 2,
        device_ms_by_family=dict(sorted(by_family.items(),
                                        key=lambda kv: -kv[1])),
        top_kernels_ms_launches=sorted(by_kernel.items(),
                                       key=lambda kv: -kv[1][0])[:12],
        optimizer_ms=opt_ms, optimizer_bound_ms=opt_bound,
        optimizer_bound_by=opt_by,
        steady_losses=[float(m["loss"]) for m in metrics],
        accum2_loss_diff=loss_diff, accum2_max_abs_param_diff=param_diff)
    metrics.clear()
    return state[0], step_fn, tokens_at


def phase_ckpt(torch, obs, state, step_fn, tokens_at):
    """9b: the train state (params, m, v) through ``CheckpointManager``
    (async, format 1) into build/smoke/ckpt/, deleted afterwards:
    RESUME_STEPS uninterrupted steps, then from the same state 1 step, a
    save, and ``run_resilient`` from step 1 with a failure injected at its
    first step: it restores the save (every restored leaf must equal the
    saved one) and runs the last 2 steps, whose losses must equal the
    uninterrupted ones within RESUME_RTOL."""
    import resource
    import shutil

    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.dist.fault import run_resilient

    root = ROOT / "build" / "smoke"
    root.mkdir(parents=True, exist_ok=True)
    df = subprocess.run(["df", "-B1", str(root)], capture_output=True,
                        text=True, timeout=60, check=True).stdout
    log("host", df=df.strip().splitlines()[-1], mem_available=mem_available())

    class TimedManager(CheckpointManager):
        """Seconds of each save (the synchronous host snapshot), each wait
        that joined a write, and each restore."""
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.seconds = defaultdict(list)

        def save(self, *a, **kw):
            self.wait()
            t0 = time.perf_counter()
            super().save(*a, **kw)
            self.seconds["save"].append(time.perf_counter() - t0)

        def wait(self):
            joined = self._thread is not None
            t0 = time.perf_counter()
            super().wait()
            if joined:
                self.seconds["wait"].append(time.perf_counter() - t0)

        def restore(self, *a, **kw):
            self.wait()
            t0 = time.perf_counter()
            out = super().restore(*a, **kw)
            torch.cuda.synchronize()
            self.seconds["restore"].append(time.perf_counter() - t0)
            return out

    def step_at(st, s, record):
        p, o, m = step_fn(*st, {"tokens": tokens_at(s)})
        record.append(float(m["loss"]))
        return (p, o)

    uninterrupted, st = [], state
    for s in range(RESUME_STEPS):
        st = step_at(st, s, uninterrupted)
    del st
    resumed = []
    saved = step_at(state, 0, resumed)
    del state
    n_bytes = sum(x.numel() * x.element_size() for x in state_leaves(saved))
    ckdir = root / "ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    mgr = TimedManager(ckdir, keep=1, device="cuda")
    written = obs.counter("ckpt_bytes_written_total").value()
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    checked = {"armed": True, "leaves": 0}
    try:
        mgr.save(1, saved)

        def resilient_step(st, s):
            if checked["armed"]:
                checked["armed"] = False
                raise RuntimeError("injected step failure")
            if not checked["leaves"]:     # the restored state, once
                if st is saved:
                    raise AssertionError("9b: the run resumed from its "
                                         "initial state, not the checkpoint")
                got, want = state_leaves(st), state_leaves(saved)
                for i, (a, b) in enumerate(zip(got, want)):
                    if a.dtype != b.dtype or a.device != b.device or \
                            not torch.equal(a, b):
                        raise AssertionError(f"9b: restored leaf {i} "
                                             f"differs from the saved one")
                checked["leaves"] = len(got)
            return step_at(st, s, resumed)

        _, events = run_resilient(resilient_step, saved,
                                  n_steps=RESUME_STEPS, ckpt=mgr,
                                  save_every=0, start_step=1)
    finally:
        mgr.wait()
        shutil.rmtree(ckdir, ignore_errors=True)
    if ("restored", 1) not in events or not checked["leaves"] or \
            len(mgr.seconds["restore"]) != 1:
        raise AssertionError(f"9b: events {events}, {checked['leaves']} "
                             f"leaves checked")
    diffs = [abs(a - b) / abs(b) for a, b in zip(resumed, uninterrupted)]
    if len(resumed) != RESUME_STEPS or max(diffs) > RESUME_RTOL:
        raise AssertionError(f"9b: resumed losses {resumed} vs "
                             f"uninterrupted {uninterrupted}")
    log("ckpt", state_bytes=n_bytes,
        file_bytes=obs.counter("ckpt_bytes_written_total").value() - written,
        leaves=checked["leaves"], **{f"{k}_s": v for k, v in
                                      mgr.seconds.items()},
        peak_rss_bytes=resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss * 1024,
        peak_rss_before_bytes=rss0, mem_available_after=mem_available(),
        events=[list(e[:2]) for e in events], resumed_losses=resumed,
        uninterrupted_losses=uninterrupted, max_rel_loss_diff=max(diffs),
        bar=f"rtol {RESUME_RTOL} (not bitwise: the embedding backward "
            f"accumulates with atomics)")


def phase_table1(torch, ops):
    """9c: ``repro_torch.bench.table1_main.run`` on the card: the bench
    model trained by the port (400 steps) into build/smoke/bench_model/,
    then every row, with ``table1_main``'s claims and the rows' kernel
    launches held to the pipeline's counts."""
    import shutil

    from repro_torch.bench import table1_main as t1
    from repro_torch.bench.common import BENCH_CFG, bench_model

    root = ROOT / "build" / "smoke"
    ck = root / "bench_model"
    shutil.rmtree(ck, ignore_errors=True)
    t0 = time.perf_counter()
    bench_model(device="cuda", ckpt_dir=ck)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows, info = t1.run(device="cuda", ckpt_dir=ck, out=root / "table1.json")
    total = defaultdict(int)
    for name, r in info.items():
        method = name.split("+")[0]
        want = {"group_quant": base_method_gq_launches(method, BENCH_CFG),
                "transform_quant": 2 * 400 if "+" in name else 0}
        got = {k: r["launches"][k] for k in want}
        if got != want:
            raise AssertionError(f"9c {name}: launches {got} != {want}")
        for k, v in got.items():
            total[k] += v
        log("table1_row", row=name, ppl=rows[name], seconds=r["seconds"],
            accept_rate=r["accept_rate"], launches=got)
    log("table1", fp32=rows["fp32"], train_s=train_s,
        rows_s=time.perf_counter() - t0, rows=rows, launches=dict(total),
        model=dict(n_layers=BENCH_CFG.n_layers, d_model=BENCH_CFG.d_model,
                   d_ff=BENCH_CFG.d_ff, vocab=BENCH_CFG.vocab_size))
    return dict(total)


def phase_small_train(torch, devs=("cpu", "cuda"), arch="opt-tiny",
                      cfg=None):
    """9d (and 10d, 11d): ``arch`` reduced (or ``cfg``), the same init
    (drawn on the CPU) and batches, SMALL_TRAIN_STEPS steps of ``train()``
    on each of ``devs`` (the yardstick's device, then the device under
    test): losses within 1e-5 relative, params within 9a's accumulation
    bar."""
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.models.model import init_params
    from repro_torch.optim.adamw import tree_leaves

    cfg = cfg or get_config(arch).reduced()
    params = init_params(cfg, torch.Generator().manual_seed(11), device="cpu")
    out = []
    for d in devs:
        p, losses, _ = train(steps=SMALL_TRAIN_STEPS, batch=4, seq=64,
                             lr=1e-3, cfg=cfg, params=to_device(params, d),
                             log_every=1000, device=d)
        out.append((p, losses))
    (p_ref, l_ref), (p_dev, l_dev) = out
    rel = max(abs(a - b) / abs(b) for a, b in zip(l_dev, l_ref))
    if rel > 1e-5:
        raise AssertionError(f"9d: losses {l_dev} vs {l_ref}")
    param_diff = within(torch, [x.cpu() for x in tree_leaves(p_dev)],
                        tree_leaves(p_ref), what="9d params", **ACCUM_TOL)
    log("small_train", arch=arch, devices=list(devs), losses=l_dev,
        ref_losses=l_ref,
        max_rel_loss_diff=rel, params_max_abs_diff=param_diff)


# ---------------------------------------------------------------------------
# phase 10: the dense zoo (RoPE, qk-norm, gated SwiGLU, GQA) at full width
# ---------------------------------------------------------------------------

ZOO_ARCH = "qwen3-4b"
ZOO_ARCHS = ("qwen3-4b", "yi-6b", "internlm2-1.8b", "command-r-35b")
# phase 10's fp32 run (the configs' own dtype is bf16, which phase 14 runs
# at full depth): 12 of Qwen3-4B's 36 layers, to pay for phase 14
ZOO_DTYPE = dict(param_dtype="float32", compute_dtype="float32")
ZOO_FP32_LAYERS = 12
ZOO_METHODS = ("rtn", "awq")     # each alone, then + STEPS fused steps
ZOO_SERVE = (("off", False, 1), ("on", True, 1), ("on-mp2", True, 2))
# 10b profiles the first request of each tenant (a third of the trace's
# profiler events); 10c takes no profile (6c's covers the same kernels)
ZOO_PROFILE_REQUESTS = 8
SMALL_ZOO_STEPS = 4
FWD_TOL = dict(rtol=1e-4, atol=1e-5)      # tests/test_torch_model.py
DECODE_TOL = dict(rtol=1e-4, atol=1e-4)   # tests/test_torch_legacy_serve.py
FFN_KEYS = ("up", "gate", "down")


def dense_parts(cfg):
    """(attention, FFN, norm) parameters of one dense block of the port's
    tree: projections with their biases (and qk-norm), the FFN's weights and
    biases, one norm's weight (and bias under LayerNorm)."""
    D, F = cfg.d_model, cfg.d_ff
    hd, hq, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    attn = 2 * D * hq * hd + 2 * D * hkv * hd
    if cfg.attn_qkv_bias or cfg.use_bias:
        attn += (hq + 2 * hkv) * hd
    if cfg.use_bias:
        attn += D
    if cfg.qk_norm:
        attn += 2 * hd
    n_ffn = 2 + int(cfg.gated_mlp)
    mlp = n_ffn * D * F + ((n_ffn - 1) * F + D if cfg.use_bias else 0)
    return attn, mlp, D * (2 if cfg.norm == "layernorm" else 1)


def dense_param_count(cfg) -> int:
    """Parameters of the port's ``init_params`` tree for a dense ``cfg``."""
    D, V = cfg.d_model, cfg.padded_vocab
    attn, mlp, norm = dense_parts(cfg)
    n = cfg.n_layers * (attn + mlp + 2 * norm) + norm + V * D
    if cfg.pos_emb == "learned":
        n += cfg.max_seq_len * D
    if not cfg.tie_embeddings:
        n += D * V
    return n


def matmul_params(cfg) -> int:
    """Weights a forward multiplies by: every block's projections and the
    LM head (the token embedding is a lookup)."""
    D, F = cfg.d_model, cfg.d_ff
    hd, hq, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    per_layer = 2 * D * hq * hd + 2 * D * hkv * hd \
        + (2 + int(cfg.gated_mlp)) * D * F
    return cfg.n_layers * per_layer + D * cfg.padded_vocab


def forward_flops(cfg, B, S) -> int:
    """Operations of one forward over (B, S) tokens: 2 per weight per token,
    and causal attention's QK^T and PV over the S(S+1)/2 pairs a head."""
    return 2 * matmul_params(cfg) * B * S + 2 * 2 * cfg.n_layers * B \
        * (S * (S + 1) // 2) * cfg.n_heads * cfg.resolved_head_dim


def ffn_stack_bytes(cfg, elem=4) -> int:
    """The stacked FFN weights (up, gate, down) that an accepted move clones."""
    return cfg.n_layers * (2 + int(cfg.gated_mlp)) * cfg.d_model * cfg.d_ff \
        * elem


def paged_launches(cfg, steps) -> int:
    """Paged-decode launches of a serving run: one per layer per step."""
    return cfg.n_layers * steps


def zoo_config(get_config, arch=ZOO_ARCH, n_layers=None):
    """``arch`` in fp32, ``n_layers`` deep (its own depth by default)."""
    import dataclasses
    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=n_layers or cfg.n_layers,
                               **ZOO_DTYPE)


def phase_zoo_main(torch, ops, cfg, qcfg, methods=ZOO_METHODS, tag="zoo"):
    """10a (and 11a, ``tag="moe"``): ``quantize_model`` on random-init
    ``cfg`` (Qwen3-4B at full width and depth; Phi-3.5-MoE at full width, 3
    layers) in fp32: each of ``methods`` alone and + STEPS fused steps on 4
    x 512 calibration tokens, held-out ppl on 4 x 512 others; then one
    search step's forward timed beside its operations (``forward_flops``;
    ``moe_forward_flops`` over the E·C slots of the dispatch buffer); last,
    the fp32 params packed at 2 bits / g32 for the servers. Returns (the
    packed params, the seconds the packing took, the launch counts by
    kernel and run)."""
    from repro_torch.core.objective import activation_mse, calib_ce
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.search import SearchConfig
    from repro_torch.data.calib import calibration_tensor
    from repro_torch.models.model import forward, init_params, lm_loss
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.quantized.qmodel import pack_model

    moe = cfg.block_pattern == "moe"
    elem = torch.finfo(getattr(torch, cfg.param_dtype)).bits // 8
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    calib = calibration_tensor(cfg.vocab_size, n_seqs=4, seq_len=512,
                               seed=99, device="cuda")
    held = calibration_tensor(cfg.vocab_size, n_seqs=4, seq_len=512,
                              seed=123, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    want = moe_param_count(cfg) if moe else dense_param_count(cfg)
    if n_params != want:
        raise AssertionError(f"{n_params} params != {want}")
    extra = dict(experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
                 capacity_factor=cfg.moe.capacity_factor,
                 capacity_512=cfg.moe.capacity(512), norm=cfg.norm,
                 param_count=cfg.param_count(),
                 active_param_count=cfg.active_param_count(),
                 cuts=[f"depth: {cfg.n_layers} of 32 layers"]) if moe else {}
    log(tag + "_setup", arch=cfg.name, n_layers=cfg.n_layers,
        d_model=cfg.d_model, heads=[cfg.n_heads, cfg.n_kv_heads],
        head_dim=cfg.resolved_head_dim, d_ff=cfg.d_ff, vocab=cfg.vocab_size,
        qk_norm=cfg.qk_norm, rope_theta=cfg.rope_theta,
        dtype=cfg.param_dtype, params=n_params,
        param_bytes=elem * n_params, calib=list(calib.shape),
        seconds=time.perf_counter() - t0, **extra)

    def ppl(p):
        logits = forward(p, cfg, held)
        return math.exp(float(lm_loss(logits[:, :-1], held[:, 1:],
                                      cfg.vocab_size)))

    ppl_fp = ppl(params)
    scfg = SearchConfig(steps=STEPS, fused_kernel=True, log_every=0)
    n_units = cfg.n_layers * (cfg.moe.num_experts if moe else 1)
    clone = expert_stack_bytes(cfg, elem) if moe else ffn_stack_bytes(cfg,
                                                                      elem)
    launches = {"group_quant": {}, "transform_quant": {}}
    step_ms = None
    for method in methods:
        for search in (None, scfg):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            res = quantize_model(params, cfg, qcfg, method, calib, search,
                                 device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts, peak = dict(ops.LAUNCHES), torch.cuda.max_memory_allocated()
            ppl_q = ppl(res.params_q)
            sr, label = res.search, res.method
            del res
            want_gq = base_method_gq_launches(method, cfg)
            want_tq = search_launches(cfg, scfg, sr.stats)["transform_quant"] \
                if sr else 0
            if counts["group_quant"] != want_gq or \
                    counts["transform_quant"] != want_tq or \
                    any(v for k, v in counts.items()
                        if k not in ("group_quant", "transform_quant")):
                raise AssertionError(f"{label}: launches {counts}, expected "
                                     f"group_quant {want_gq}, "
                                     f"transform_quant {want_tq}")
            nums = [ppl_q] + ([sr.initial_loss, sr.final_loss]
                              + [h[1] for h in sr.history] if sr else [])
            if not all(math.isfinite(x) for x in nums):
                raise AssertionError(f"{label}: non-finite numbers {nums}")
            extra = {}
            if sr:
                if not sr.final_loss <= sr.initial_loss:
                    raise AssertionError(f"{label}: final loss above initial")
                if sr.transforms.pi.shape[0] != n_units:
                    raise AssertionError(f"{label}: {sr.transforms.pi.shape[0]}"
                                         f" units, expected {n_units}")
                step_ms = 1e3 / sr.stats["proposals_per_sec"]
                accepts = sum(1 for h in sr.history[1:] if h[4])
                extra = dict(initial_loss=sr.initial_loss,
                             final_loss=sr.final_loss,
                             accept_rate=sr.accept_rate, steps=STEPS,
                             units=n_units, step_ms=step_ms,
                             search_s=STEPS / sr.stats["proposals_per_sec"],
                             accepts=accepts, stack_clone_bytes=clone,
                             cloned_bytes=accepts * clone)
            log(tag + "_quantize", arch=cfg.name, method=label,
                ppl_fp32=ppl_fp, ppl=ppl_q, wall_s=wall, peak_bytes=peak,
                launches=counts, group_quant_expected=want_gq,
                transform_quant_expected=want_tq, **extra)
            for kernel in launches:
                launches[kernel][label] = counts[kernel]
            del sr
    # one candidate's forward and objective (its cost does not depend on
    # the weights' values), beside the step the searches measured
    B, S = calib.shape

    def eval_once():
        logits, hidden = forward(params, cfg, calib, collect_hidden=True)
        return calib_ce(logits, calib, cfg.vocab_size), \
            activation_mse(hidden, hidden, 10)

    fwd_ms = time_ms(torch, eval_once, warmup=1, reps=3)
    flops = (moe_forward_flops if moe else forward_flops)(cfg, B, S)
    extra = {}
    if moe:
        C = cfg.moe.capacity(S)
        extra = dict(expert_flops=cfg.n_layers * 2 * B * cfg.moe.num_experts
                     * C * (2 + int(cfg.gated_mlp)) * cfg.d_model * cfg.d_ff,
                     slots_per_row=cfg.moe.num_experts * C,
                     routed_slots_per_row=S * cfg.moe.top_k)
    log(tag + "_step", arch=cfg.name, forward_objective_ms=fwd_ms,
        step_ms=step_ms, forward_flops=flops,
        forward_tflops_per_s=flops / fwd_ms / 1e9,
        **peak_share(flops, fwd_ms, elem),
        stack_clone_bytes=clone,
        logits_bytes=B * S * cfg.padded_vocab * elem, **extra)
    del calib, held
    t0 = time.perf_counter()
    params_q = pack_model(params, qcfg)
    torch.cuda.synchronize()
    return params_q, time.perf_counter() - t0, launches


def phase_zoo_serving(torch, ops, cfg, params_q, setup_s, pd_rows,
                      tag="zoo_"):
    """10b and 10c (and 14d): the packed model served over the 8-tenant
    trace by PagedServer (sharing off, on, on with 2 pages per block: the
    two GQA routes) and by BatchedServer (use_flash_decode off, on).
    Returns the paged runs' launch counts by label and the flash run's
    launches."""
    t0 = time.perf_counter()
    paged, _ = phase_serving(torch, ops, pd_rows, cfg, params_q, setup_s,
                             variants=ZOO_SERVE, tag=tag,
                             profile_requests=ZOO_PROFILE_REQUESTS)
    t1 = time.perf_counter()
    flash = phase_legacy_serving(torch, ops, cfg, params_q, profile=False)
    log(tag + "serving_seconds", paged_s=t1 - t0,
        batched_s=time.perf_counter() - t1)
    return paged, flash


def phase_small_zoo(torch, ops, arch, devs=("cpu", "cuda"), cfg=None):
    """10d (and 11d): ``arch``'s reduced config (or ``cfg``) on ``devs``
    (the yardstick's device, then the device under test), from the same
    weights (drawn on the CPU), tokens and proposals: the forward's logits
    (FWD_TOL), prefill + 3 decode steps (DECODE_TOL, logits and caches),
    RTN + SMALL_ZOO_STEPS fused steps (``histories_agree``; over the L·E
    expert units on an MoE config), the base methods
    (``small_base_methods``; a dense config only: they refuse MoE, as the
    reference's do), SMALL_TRAIN_STEPS train steps (``phase_small_train``)
    and PagedServer's greedy tokens and stats (identical)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import invariance as inv
    from repro_torch.core import rtn
    from repro_torch.core.quant import QuantConfig, fake_quant
    from repro_torch.core.search import SearchConfig
    from repro_torch.data.calib import calibration_tensor
    from repro_torch.models.model import (decode_step, forward, init_params,
                                          prefill)
    from repro_torch.quantized.qmodel import pack_model
    from repro_torch.search import run

    t0 = time.perf_counter()
    cfg = cfg or get_config(arch).reduced()
    qcfg = QuantConfig(bits=2, group_size=32)
    params = init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    calib = calibration_tensor(cfg.vocab_size, n_seqs=4, seq_len=64,
                               device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (3, 12)))
    scfg = SearchConfig(steps=SMALL_ZOO_STEPS, fused_kernel=True, log_every=0)
    outs = []
    for d in map(torch.device, devs):
        p = to_device(params, d)
        logits = [forward(p, cfg, calib.to(d)).cpu()]
        lg, cache = prefill(p, cfg, toks[:, :9].to(d), 32)
        logits.append(lg.cpu())
        for t in range(9, 12):
            lg, cache = decode_step(p, cfg, toks[:, t:t + 1].to(d), cache, t)
            logits.append(lg.cpu())
        base = rtn.map_quantizable(p, lambda w, _: fake_quant(w, qcfg),
                                   only=lambda q: q[-1] not in FFN_KEYS)
        ops.reset_launch_counts()
        res = run(p, base, cfg, qcfg, calib.to(d), scfg,
                  proposals=CpuProposals(inv, 3, d))
        counts = dict(ops.LAUNCHES)
        want = search_launches(cfg, scfg, res.stats) if d.type == "cuda" \
            else {k: 0 for k in counts}
        if any(counts[k] != want.get(k, 0) for k in counts):
            raise AssertionError(f"{arch}: search launches {counts} != {want}")
        outs.append((logits, [cache[k].cpu() for k in sorted(cache)],
                     res.history))
        del p, base, res, cache
    (l_ref, c_ref, h_ref), (l_dev, c_dev, h_dev) = outs
    fwd_err = within(torch, l_dev[:1], l_ref[:1], what=f"{arch} forward",
                     **FWD_TOL)
    dec_err = within(torch, l_dev[1:] + c_dev, l_ref[1:] + c_ref,
                     what=f"{arch} prefill / decode", **DECODE_TOL)
    compared, parted = histories_agree(h_dev, h_ref, f"{arch} search")
    if cfg.block_pattern == "dense":
        small_base_methods(torch, cfg, params, calib, devs,
                           f"{arch} (reduced)")
    phase_small_train(torch, devs, arch=arch, cfg=cfg)
    params_q = pack_model(params, qcfg)
    route = ops.paged_decode_route(cfg.n_heads, cfg.n_kv_heads)
    ref, dev = serve_on_devices(torch, ops, cfg, params_q, 1, devs)
    if dev[0] != ref[0] or dev[1] != ref[1]:
        raise AssertionError(f"{arch}: served tokens or stats differ")
    if devs[1] == "cuda" and (
            dev[2][route] != paged_launches(cfg, dev[1]["steps"])
            or any(dev[2][r] for r in PD_ROUTES if r != route)):
        raise AssertionError(f"{arch}: paged launches {dev[2]}")
    moe = dict(experts=cfg.moe.num_experts, top_k=cfg.moe.top_k) \
        if cfg.moe else {}
    log("small_zoo", arch=arch, devices=list(devs), **moe,
        heads=[cfg.n_heads, cfg.n_kv_heads], head_dim=cfg.resolved_head_dim,
        qk_norm=cfg.qk_norm, norm=cfg.norm, rope_theta=cfg.rope_theta,
        forward_max_abs_diff=fwd_err, decode_max_abs_diff=dec_err,
        search_compared=compared, search_parted_at=parted,
        card_losses=[h[1] for h in h_dev], ref_losses=[h[1] for h in h_ref],
        serve_stats=dev[1], serve_launches=dev[2], tokens_identical=True,
        seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# phase 11: the MoE family; Phi-3.5-MoE at full width
# ---------------------------------------------------------------------------

MOE_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_ARCHS = ("phi3.5-moe-42b-a6.6b", "moonshot-v1-16b-a3b")
# cut: 3 of the config's 32 layers (4.17 B params, 8.33 GB in its own bf16;
# 16.66 GB in fp32, where 11c's fp32 search for the accept comparison peaks
# near 64 GB: a deeper stack would not fit it; and 11b dequantises all 16
# experts of every layer at each decode step, ≈ 35 s of the script at 3)
MOE_LAYERS = 3
MOE_SERVE = (("off", False, 1), ("on", True, 1), ("on-mp2", True, 2))
MOE_PROFILE_REQUESTS = 8
# 11d runs Moonlight at its own fine-grained routing (reduced() keeps the
# reference's E 4 / top-2)
MOON_MOE = dict(num_experts=64, top_k=6)


def moe_config(get_config, arch=MOE_ARCH, n_layers=MOE_LAYERS):
    """``arch`` at full width, ``n_layers`` deep, in its own dtype."""
    return dataclasses.replace(get_config(arch), n_layers=n_layers)


def moe_param_count(cfg) -> int:
    """Parameters of the port's ``init_params`` tree for an MoE ``cfg``
    (``ModelConfig.param_count``, the reference's analytic count, counts 2
    D a block for the norms: a LayerNorm block holds 4 D, and the final
    norm is not counted there)."""
    D, F, V, E = cfg.d_model, cfg.d_ff, cfg.padded_vocab, cfg.moe.num_experts
    hd, hq, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    attn = 2 * D * hq * hd + 2 * D * hkv * hd + (2 * hd if cfg.qk_norm else 0)
    experts = E * (2 + int(cfg.gated_mlp)) * D * F
    norm = D * (2 if cfg.norm == "layernorm" else 1)
    n = cfg.n_layers * (attn + experts + D * E + 2 * norm) + norm + V * D
    return n + (0 if cfg.tie_embeddings else D * V)


def moe_forward_flops(cfg, B, S) -> int:
    """Operations of one forward over (B, S) tokens as the port computes
    it: per layer the attention projections and the router, 2 per weight
    per token; causal attention's QK^T and PV over S(S+1)/2 pairs a head;
    the expert GEMMs over all E·C slots of each row's dispatch buffer (C =
    capacity(S); an empty slot costs what a full one does); and the LM
    head."""
    D, F, E = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    hd, hq, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    C = cfg.moe.capacity(S)
    per_layer = 2 * B * S * (2 * D * hq * hd + 2 * D * hkv * hd + D * E) \
        + 2 * B * E * C * (2 + int(cfg.gated_mlp)) * D * F \
        + 2 * 2 * B * (S * (S + 1) // 2) * hq * hd
    return cfg.n_layers * per_layer + 2 * B * S * D * cfg.padded_vocab


def expert_stack_bytes(cfg, elem=4) -> int:
    """The (L·E, ...) expert stack (up, gate, down) that an accepted move
    clones (``install_unit``), and that each decode step dequantises."""
    return cfg.n_layers * cfg.moe.num_experts * (2 + int(cfg.gated_mlp)) \
        * cfg.d_model * cfg.d_ff * elem


def moe_gq_shapes(cfg):
    """The (K, N) shapes an MoE model gives ``group_quant``: ``fake_quant``
    flattens the stacked attention leaves (L, K, N) to (L·K, N) and the
    expert leaves (L, E, K, N) to (L·E·K, N)."""
    L, D, F, E = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    hq = cfg.n_heads * cfg.resolved_head_dim
    hkv = cfg.n_kv_heads * cfg.resolved_head_dim
    return (("attn wq", (L * D, hq)), ("attn wk/wv", (L * D, hkv)),
            ("attn wo", (L * hq, D)), ("experts up/gate", (L * E * D, F)),
            ("experts down", (L * E * F, D)))


def gq_shapes_check(torch, ops, ref, cfg, shapes, timed, seed, dtype=None,
                    round_range=False):
    """``group_quant`` against its plain version (``torch.equal``) at each
    named (K, N) of ``shapes`` (2-bit g32, the path's setting; w in
    ``dtype``, f32 by default, with ``round_range`` as ``fake_quant`` calls
    it on a bf16 w), and at the shape named ``timed`` its time and device
    time beside its bound and its plain version's. Returns (max abs err,
    the timing row)."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    err, row = 0.0, None
    kw = dict(bits=2, group=32, round_range=round_range)
    for name, shape in shapes:
        w = torch.randn(shape, generator=gen, device=dev).to(
            dtype or torch.float32)
        e = exact(torch, ops.group_quant(w, **kw),
                  ref.group_quant_ref(w, 2, 32, round_range=round_range),
                  f"group_quant {name} {shape}")
        err = max(err, e)
        log("kernel_check", kernel="group_quant", arch=cfg.name, weight=name,
            shape=list(shape), dtype=str(w.dtype), round_range=round_range,
            bits=2, group=32, max_abs_err=e)
        if name == timed:
            K, N = shape
            ms = time_ms(torch, lambda: ops.group_quant(w, **kw), warmup=1,
                         reps=5)
            dms = device_ms(torch, lambda: ops.group_quant(w, **kw),
                            ("group_quant",), calls=5)
            plain = time_ms(torch, lambda: ref.group_quant_ref(
                w, 2, 32, round_range=round_range), warmup=1, reps=3)
            bms, by = bound_ms(gq_bytes(K, N, 32, w.element_size()),
                               GQ_OPS * K * N)
            row = dict(weight=name, shape=list(shape), dtype=str(w.dtype),
                       ms=ms, device_ms=dms, plain_ms=plain, bound_ms=bms,
                       bound_by=by, share_of_bound=bms / dms)
            log("kernel_time", kernel="group_quant", arch=cfg.name, **row)
        del w
    torch.cuda.empty_cache()
    return err, row


def stepwise_oracle(torch, ref, cfg, params_q, device="cuda"):
    """11b's oracle: each PagedServer run served again with the same
    options under ``StepCheck``: every decode step held to the same step
    through the paged decode's plain version (``kernels.ref.
    paged_decode_ref``) on the same pools, the token parting only at a near
    tie of the plain logits or of the plain step's routing. The served
    computation itself (chunking and MoE capacity included), so no
    full-forward oracle is needed; the run must give the tokens the timed
    run gave. Runs are not held to each other: an MoE model routes each
    prefill chunk at the chunk's capacity (sharing changes the chunks), and
    in bf16 the attention routes round differently."""
    from repro_torch.launch.serve import PagedServer

    def oracle(reqs, runs):
        ties = {}
        for k, r in runs.items():
            check = StepCheck(torch, ref, cfg)
            with check:
                outs = check.watch_paged(PagedServer(
                    params_q, cfg, prefix_cache=r["sharing"],
                    gqa_pages_per_block=r["mp"], device=device,
                    **SERVE)).generate(reqs)
            if outs != r["outs"]:
                raise AssertionError(f"{k}: the checked run's tokens are not "
                                     f"the timed run's")
            ties[k] = check.parted
            log("step_check", arch=cfg.name, run=k, **check.counts())
        return (ties, "each decode step again through the paged decode's "
                "plain version on the same pools (StepCheck)",
                {k: k for k in runs})

    return oracle


def phase_moe_serving(torch, ops, ref, cfg, params_q, setup_s):
    """11b and 11c: the packed model served over the 8-tenant trace by
    PagedServer (sharing off, on, on with 2 pages per block: both GQA
    routes) held to its plain route, and by BatchedServer
    (use_flash_decode off, on). Returns the paged runs' launch counts by
    label and the flash run's launches."""
    t0 = time.perf_counter()
    rows = {r: {"decode": {"ms": None}} for r in PD_ROUTES}
    paged, split = phase_serving(
        torch, ops, rows, cfg, params_q, setup_s, variants=MOE_SERVE,
        tag="moe_", profile_requests=MOE_PROFILE_REQUESTS,
        oracle=stepwise_oracle(torch, ref, cfg, params_q))
    per_layer = expert_stack_bytes(cfg) // cfg.n_layers // 4
    log("moe_dequant", arch=cfg.name, expert_weights_per_layer=per_layer,
        dequant_per_layer_ms=split["dequant_per_layer_ms"],
        us_per_million_weights=1e3 * split["dequant_per_layer_ms"]
        / (per_layer / 1e6))
    t1 = time.perf_counter()
    flash = phase_legacy_serving(torch, ops, cfg, params_q, profile=False,
                                 full_forward_oracle=False, ref=ref)
    log("moe_serving_seconds", paged_s=t1 - t0,
        batched_s=time.perf_counter() - t1)
    return paged, flash


def small_moe_config(get_config, arch):
    """``arch``'s reduced config; Moonlight at E 64 / top-6."""
    import dataclasses
    cfg = get_config(arch).reduced()
    if arch != MOE_ARCH:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **MOON_MOE))
    return cfg


def phase_moe(torch, ops, ref, get_config, qcfg):
    """Phase 11 (11a-11d), Phi-3.5-MoE in its own bf16: the kernels at its
    shapes (``group_quant`` at every stacked shape, ``transform_quant`` at
    one expert, the GQA routes and ``flash_decode`` at 32/8 x 128 on bf16
    caches), 11a RTN ± STEPS fused steps, 11b / 11c both servers, then
    the bf16-vs-fp32 accept decisions, and 11d both MoE configs reduced,
    card against CPU, in fp32 and in bf16. Returns what the kernels line
    carries: 11a's launches by kernel and run, 11b's paged runs by label,
    11c's flash_decode, the kernel checks' rows."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = moe_config(get_config)
    gq_check = gq_shapes_check(torch, ops, ref, cfg, moe_gq_shapes(cfg),
                               "experts up/gate", 4321,
                               **own_dtype_kw(torch, cfg))
    tq = tq_check(torch, ops, ref, cfg.name, cfg.d_model, cfg.d_ff, qcfg,
                  4324, torch.bfloat16)
    attn = attn_kernels_at(torch, ops, ref, cfg, (
        "paged_decode_gqa", "paged_decode_gqa_mp", "flash_decode"),
        trace_decode_lens(cfg), (torch.bfloat16,), torch.bfloat16)
    params_q, pack_s, launches = phase_zoo_main(torch, ops, cfg, qcfg,
                                                methods=("rtn",), tag="moe")
    t1 = time.perf_counter()
    paged, flash = phase_moe_serving(torch, ops, ref, cfg, params_q, pack_s)
    del params_q
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    differing = family_accepts(torch, ops, cfg, qcfg)
    t3 = time.perf_counter()
    for arch in MOE_ARCHS:
        phase_small_zoo(torch, ops, arch, cfg=small_moe_config(get_config,
                                                               arch))
        phase_small_bf16(torch, ops, arch)
    t4 = time.perf_counter()
    log("phase11", seconds=t4 - t0, a_s=t1 - t0, bc_s=t2 - t1,
        accepts_s=t3 - t2, d_s=t4 - t3, accept_decisions_differing=differing)
    return dict(main=launches, paged=paged, flash=flash, gq_check=gq_check,
                tq=tq, attn=attn, differing=differing)


# ---------------------------------------------------------------------------
# phase 12: the SSM and hybrid families; Mamba2-2.7B at full width and depth
# ---------------------------------------------------------------------------

SSM_ARCH = "mamba2-2.7b"
HYBRID_ARCH = "zamba2-7b"
SSM_ARCHS = (SSM_ARCH, HYBRID_ARCH)
# 12c's cut: 13 of Zamba2-7B's 81 blocks, so that hybrid_layout() is
# (11, 2): two applications of the shared block and one tail SSM block
# (1.29 B params, 2.6 GB in its own bf16, 5.2 GB in fp32 for 12c's accept
# comparison; the full 81 blocks with the search's three Mamba stacks of
# 21 GB each in fp32 would not fit one card)
HYBRID_LAYERS = 13
SSM_SERVE_REQUESTS = 8        # 12b / 12c: one batch of the trace's first 8
MAMBA_KEYS = ("w_z", "w_x", "out_proj")
SCAN_RANGE, DEQUANT_RANGE = "ssm.scan", "model.dequant"


def ssm_config(get_config, arch=SSM_ARCH):
    """``arch`` at full width in its own dtype (Zamba2-7B HYBRID_LAYERS
    deep)."""
    cfg = get_config(arch)
    if cfg.block_pattern == "hybrid":
        cfg = dataclasses.replace(cfg, n_layers=HYBRID_LAYERS)
    return cfg


def ssm_dims(cfg):
    """(Mamba blocks, shared-block applications, d_inner, SSD heads, state
    width, groups x state) of an SSM or hybrid ``cfg``."""
    s = cfg.ssm
    n_m, n_a = cfg.hybrid_layout() if cfg.block_pattern == "hybrid" \
        else (cfg.n_layers, 0)
    return (n_m, n_a, s.d_inner(cfg.d_model), s.n_heads(cfg.d_model),
            s.d_state, s.n_groups * s.d_state)


def ssm_param_count(cfg) -> int:
    """Parameters of the port's ``init_params`` tree for an SSM or hybrid
    ``cfg``: ``ModelConfig.param_count`` (the reference's analytic count)
    plus what it leaves out, each block's three conv biases and the final
    norm."""
    n_m, _, di, _, _, gn = ssm_dims(cfg)
    return cfg.param_count() + n_m * (di + 2 * gn) + cfg.d_model


def mamba_stack_bytes(cfg, elem=4) -> int:
    """The search's Mamba unit stack (w_z, w_x, out_proj; the conv and norm
    leaves are small): what an accepted move clones."""
    n_m, _, di, _, _, _ = ssm_dims(cfg)
    return n_m * 3 * cfg.d_model * di * elem


def ssd_flops(cfg, B, S) -> int:
    """Operations of one block's chunked SSD scan over (B, S) as the port
    computes it (``models/ssm.py::_ssd_chunked``): over nc chunks of Q =
    min(chunk, S) positions (S padded to a multiple of Q), C·B^T and the
    decay-weighted product with x over the full Q x Q square, the
    chunk-final states and the inter-chunk term, 2 operations a
    multiply-add; the state carry across chunks."""
    _, _, _, H, N, _ = ssm_dims(cfg)
    P = cfg.ssm.head_dim
    Q = min(cfg.ssm.chunk, S)
    nc = -(-S // Q)
    quad = 2 * B * nc * Q * Q * H * (N + P)       # C·B^T, then (·dec)·x
    states = 2 * 2 * B * nc * Q * H * P * N        # S_c, and y_off
    return quad + states + 2 * B * nc * H * P * N


def ssm_matmul_params(cfg) -> int:
    """Weights a forward multiplies by: each Mamba block's projections, the
    shared block once per application (its attention and MLP), and the LM
    head."""
    n_m, n_a, di, H, _, gn = ssm_dims(cfg)
    D = cfg.d_model
    n = n_m * (D * (2 * di + 2 * gn + H) + di * D) + D * cfg.padded_vocab
    if n_a:
        hd = cfg.resolved_head_dim
        attn = 2 * D * cfg.n_heads * hd + 2 * D * cfg.n_kv_heads * hd
        n += n_a * (attn + (2 + int(cfg.gated_mlp)) * D * cfg.d_ff)
    return n


def ssm_forward_flops(cfg, B, S) -> int:
    """Operations of one forward over (B, S) tokens: 2 per weight per token
    (``ssm_matmul_params``), each Mamba block's SSD scan (``ssd_flops``),
    and the shared block's causal attention (QK^T and PV over S(S+1)/2
    pairs a head) at each application."""
    n_m, n_a, _, _, _, _ = ssm_dims(cfg)
    attn = 2 * 2 * n_a * B * (S * (S + 1) // 2) * cfg.n_heads \
        * cfg.resolved_head_dim if n_a else 0
    return 2 * ssm_matmul_params(cfg) * B * S + n_m * ssd_flops(cfg, B, S) \
        + attn


def ssm_quantize_launches(cfg, scfg=None):
    """Kernel launches of one ``quantize_model(method="rtn", search=scfg)``
    on an SSM or hybrid ``cfg`` (one island, no tabu):

    - the freeze: one ``group_quant`` per stacked attention leaf of the
      shared block (4 in hybrid, none in an SSM stack);
    - RTN alone: one per search leaf: w_z, w_x, out_proj (stacked), and
      the shared FFN's up, down[, gate];
    - with the search: the Mamba phase's initial stack (3) and 3 per
      built unit (a Mamba block has no fused build: the unfused lane);
      in hybrid the shared phase's initial stack (3 gated) and 3 per
      built unit, ``transform_quant`` on the fused lane, else
      ``group_quant``. A hybrid run gives the Mamba phase ``steps // 2``
      steps and the shared phase the rest."""
    hybrid = cfg.block_pattern == "hybrid"
    n_ffn = 2 + int(cfg.gated_mlp) if hybrid else 0
    freeze = 4 if hybrid else 0
    if scfg is None:
        return {"group_quant": freeze + 3 + n_ffn, "transform_quant": 0}
    K = max(int(scfg.population), 1)
    n1 = scfg.steps // 2 if hybrid else scfg.steps
    n2 = scfg.steps - n1
    fused = bool(scfg.fused_kernel)
    gq = freeze + 3 + 3 * K * n1
    tq = 0
    if hybrid:
        gq += n_ffn + (0 if fused else n_ffn * K * n2)
        tq = n_ffn * K * n2 if fused else 0
    return {"group_quant": gq, "transform_quant": tq}


def ssm_gq_shapes(cfg):
    """The (K, N) shapes the SSM path gives ``group_quant``: the stacked
    Mamba projections flattened ((L·D, d_inner) for w_z and w_x,
    (L·d_inner, D) for out_proj), one block's unit, and in hybrid the
    shared block's attention and FFN."""
    n_m, n_a, di, _, _, _ = ssm_dims(cfg)
    D = cfg.d_model
    shapes = [("w_z/w_x stack", (n_m * D, di)), ("out_proj stack", (n_m * di, D)),
              ("w_z/w_x unit", (D, di)), ("out_proj unit", (di, D))]
    if n_a:
        hq = cfg.n_heads * cfg.resolved_head_dim
        shapes += [("shared wq", (D, hq)), ("shared up/gate", (D, cfg.d_ff)),
                   ("shared down", (cfg.d_ff, D))]
    return tuple(shapes)


def history_phases(history):
    """A search history cut into its phases (each starts at a step-0
    baseline): one for an SSM run, two for the hybrid run."""
    cuts = [i for i, h in enumerate(history) if h[0] == 0] + [len(history)]
    return [history[a:b] for a, b in zip(cuts, cuts[1:])]


def phases_monotone(history, final_loss, what):
    """At T = 0 each phase accepts a move only when it lowers the phase's
    current loss strictly, so the accepted losses of a phase (its step-0
    baseline first) fall strictly, and the final loss is the last phase's
    last accepted one. (The merged initial loss of a hybrid run is phase
    1's, taken with the shared FFN still continuous, as in the reference:
    the final loss can lie above it.)"""
    for i, ph in enumerate(history_phases(history)):
        acc = [h[1] for h in ph if h[4]]
        if any(b >= a for a, b in zip(acc, acc[1:])):
            raise AssertionError(f"{what}: phase {i} accepted a move that "
                                 f"did not lower its loss: {acc}")
    if final_loss != acc[-1]:
        raise AssertionError(f"{what}: final loss {final_loss} is not the "
                             f"last accepted {acc[-1]}")


def phase_ssm_main(torch, ops, cfg, qcfg):
    """12a (and 12c's search): ``quantize_model`` RTN alone and with STEPS
    steps (the fused flag asked for: the Mamba phase falls back to the
    unfused lane with a warning; the hybrid's shared phase runs fused) on
    random-init ``cfg`` in its own dtype, 4 x 512 calibration tokens,
    held-out ppl on 4 x 512 others; each run's launches held to
    ``ssm_quantize_launches``; then one candidate's forward + objective
    timed beside its operations (``ssm_forward_flops``), and the params
    packed at 2 bits / g32. Returns (the packed params, the packing
    seconds, the launch counts by run)."""
    import warnings

    from repro_torch.core.objective import activation_mse, calib_ce
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.search import SearchConfig
    from repro_torch.data.calib import calibration_tensor
    from repro_torch.models.model import forward, init_params, lm_loss
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.quantized.qmodel import pack_model

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    calib = calibration_tensor(cfg.vocab_size, n_seqs=4, seq_len=512,
                               seed=99, device="cuda")
    held = calibration_tensor(cfg.vocab_size, n_seqs=4, seq_len=512,
                              seed=123, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    if n_params != ssm_param_count(cfg):
        raise AssertionError(f"{n_params} params != {ssm_param_count(cfg)}")
    n_m, n_a, di, H, N, _ = ssm_dims(cfg)
    hybrid = cfg.block_pattern == "hybrid"
    elem = torch.finfo(getattr(torch, cfg.param_dtype)).bits // 8
    cuts = [f"depth: {cfg.n_layers} of 81 blocks"] if hybrid else []
    log("ssm_setup", arch=cfg.name, n_layers=cfg.n_layers,
        mamba_blocks=n_m, shared_applications=n_a, d_model=cfg.d_model,
        d_inner=di, ssd_heads=H, d_state=N, chunk=cfg.ssm.chunk,
        vocab=cfg.vocab_size, padded_vocab=cfg.padded_vocab,
        dtype=cfg.param_dtype, params=n_params,
        param_count=cfg.param_count(), param_bytes=elem * n_params,
        mamba_stack_bytes=mamba_stack_bytes(cfg, elem),
        calib=list(calib.shape), peak_bytes=torch.cuda.max_memory_allocated(),
        cuts=cuts, seconds=time.perf_counter() - t0)

    def ppl(p):
        logits = forward(p, cfg, held)
        return math.exp(float(lm_loss(logits[:, :-1], held[:, 1:],
                                      cfg.vocab_size)))

    ppl_fp = ppl(params)
    scfg = SearchConfig(steps=STEPS, fused_kernel=True, log_every=0)
    launches = {"group_quant": {}, "transform_quant": {}}
    step_ms = None
    for search in (None, scfg):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            res = quantize_model(params, cfg, qcfg, "rtn", calib, search,
                                 device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, peak = dict(ops.LAUNCHES), torch.cuda.max_memory_allocated()
        ppl_q = ppl(res.params_q)
        sr, label = res.search, res.method
        del res
        want = ssm_quantize_launches(cfg, search)
        if any(counts[k] != want.get(k, 0) for k in counts):
            raise AssertionError(f"{cfg.name} {label}: launches {counts}, "
                                 f"expected {want}")
        fallback = [str(w.message) for w in caught
                    if "falling back to the unfused" in str(w.message)]
        nums = [ppl_q] + ([sr.initial_loss, sr.final_loss]
                          + [h[1] for h in sr.history] if sr else [])
        if not all(math.isfinite(x) for x in nums):
            raise AssertionError(f"{label}: non-finite numbers {nums}")
        extra = {}
        if sr:
            if len(fallback) != 1 or sr.stats["fused"] != hybrid:
                raise AssertionError(f"{label}: the Mamba phase did not fall "
                                     f"back once ({fallback}; fused "
                                     f"{sr.stats['fused']})")
            phases_monotone(sr.history, sr.final_loss, label)
            if not hybrid and not sr.final_loss <= sr.initial_loss:
                raise AssertionError(f"{label}: final loss above initial")
            step_ms = 1e3 / sr.stats["proposals_per_sec"]
            phases = history_phases(sr.history)
            extra = dict(initial_loss=sr.initial_loss,
                         final_loss=sr.final_loss,
                         final_le_initial=sr.final_loss <= sr.initial_loss,
                         phase_baselines=[p[0][1] for p in phases],
                         phase_final=[[h[1] for h in p if h[4]][-1]
                                      for p in phases],
                         accept_rate=sr.accept_rate, steps=STEPS,
                         step_ms=step_ms, fused=sr.stats["fused"],
                         fallback_warning=fallback[0],
                         accepts=sum(1 for h in sr.history if h[0] and h[4]),
                         stack_clone_bytes=mamba_stack_bytes(cfg, elem))
        log("ssm_quantize", arch=cfg.name, method=label, ppl_fp32=ppl_fp,
            ppl=ppl_q, wall_s=wall, peak_bytes=peak, launches=counts,
            expected=want, **extra)
        for kernel in launches:
            launches[kernel][label] = counts[kernel]
        del sr
    B, S = calib.shape

    def eval_once():
        logits, hidden = forward(params, cfg, calib, collect_hidden=True)
        return calib_ce(logits, calib, cfg.vocab_size), \
            activation_mse(hidden, hidden, 10)

    fwd_ms = time_ms(torch, eval_once, warmup=1, reps=3)
    flops = ssm_forward_flops(cfg, B, S)
    log("ssm_step", arch=cfg.name, forward_objective_ms=fwd_ms,
        step_ms=step_ms, forward_flops=flops,
        ssd_flops=n_m * ssd_flops(cfg, B, S),
        forward_tflops_per_s=flops / fwd_ms / 1e9,
        **peak_share(flops, fwd_ms, elem),
        stack_clone_bytes=mamba_stack_bytes(cfg, elem),
        logits_bytes=B * S * cfg.padded_vocab * elem)
    del calib, held
    t0 = time.perf_counter()
    params_q = pack_model(params, qcfg)
    del params
    torch.cuda.synchronize()
    return params_q, time.perf_counter() - t0, launches


SSM_FAMILIES = (("gemm", "GEMM (cuBLAS)"), ("gemv", "GEMM (cuBLAS)"),
                ("cutlass", "GEMM (cuBLAS)"), ("nvjet", "GEMM (cuBLAS)"),
                ("split_decode", "flash_decode (port kernel)"))


def ssm_decode_profile(torch, obs, server, params_q, toks, steps):
    """Host ms per decode step of ``server`` over ``steps`` steps after a
    prefill of ``toks`` (ending in one synchronize), then the same steps
    under ``torch.profiler`` with the model's profiler ranges: device ms of
    the kernels launched inside the ``model.dequant`` ranges (dequant) and
    the ``ssm.scan`` ranges (the SSD state update), the GEMMs elsewhere,
    the other kernels, and the idle time: the unprofiled step's ms less
    the kernels' device ms (the profiler slows the launching host, so its
    own window overstates idle; its span is logged beside). A kernel
    belongs to a range whose device-side copy (on the GPU's clock) holds
    its start; without those, to none."""
    from torch.profiler import ProfilerActivity, profile

    plen = toks.shape[1]

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
    ranges = (DEQUANT_RANGE, SCAN_RANGE)
    logits, cache = server.prefill_fn(params_q, {"tokens": toks})
    tok = torch.argmax(logits[:, -1, :server.cfg.vocab_size], dim=-1)[:, None]
    torch.cuda.synchronize()
    obs.enable_profiler(True)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for t in range(steps):
                tok, cache = server.step_fn(params_q, tok, cache, plen + t)
            torch.cuda.synchronize()
    finally:
        obs.enable_profiler(False)
    windows = {n: [] for n in ranges}
    kernels = []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        rng = (ev.time_range.start, ev.time_range.end)
        if ev.name in windows:
            windows[ev.name].append(rng)
        else:
            kernels.append((rng[0], rng[1], ev.name))
    if not kernels:
        return step_ms, None
    fam = defaultdict(float)
    for start, end, name in kernels:
        where = next((n for n in ranges
                      if any(a <= start <= b for a, b in windows[n])), None)
        label = {DEQUANT_RANGE: "dequant", SCAN_RANGE: "SSD state update"}.get(
            where) or _family(name, SSM_FAMILIES)
        fam[label] += (end - start) / 1e3
    others = other_kernels(((name, (end - start) / 1e3 / steps)
                            for start, end, name in kernels), SSM_FAMILIES)
    span = (max(e for _, e, _ in kernels) - min(s for s, _, _ in kernels)) \
        / 1e3 / steps
    busy = sum(fam.values()) / steps
    out = {k: v / steps for k, v in sorted(fam.items(), key=lambda kv: -kv[1])}
    # idle against the unprofiled step (the profiler slows the host that
    # launches the kernels: its own window's idle share is not the run's)
    out["idle"] = max(step_ms - busy, 0.0)
    return step_ms, dict(per_step_ms=out, busy_ms=busy,
                         idle_share=out["idle"] / step_ms,
                         profiled_span_ms=span,
                         kernels_per_step=len(kernels) / steps,
                         other_kernels_ms=others,
                         device_windows={n: len(w) for n, w in
                                         windows.items()})


def phase_ssm_serving(torch, ops, cfg, params_q, flash_flags=(False,),
                      profile=True):
    """12b (and 12c): BatchedServer on the packed model over the trace's
    first SSM_SERVE_REQUESTS requests (one batch, max_new TRACE's), once
    per ``use_flash_decode`` flag: tokens/s, step ms, and with ``profile``
    device ms per decode step by family (flag off), peak bytes;
    flash_decode launched once per shared-block application per decode
    step with the flag on and never otherwise. In fp32 every run's tokens
    are held to the greedy full-forward oracle on the left-padded prompts
    (or part at a near tie), the flag-on run to the flag-off run; in bf16
    every run's logits are held, teacher-forced, to the full forward's
    (``hold_served_logits``). Then PagedServer must refuse the config.
    Returns the flag-on run's flash_decode launches (None without it)."""
    from repro_torch import obs
    from repro_torch.launch.serve import BatchedServer, PagedServer, Request
    from repro_torch.models.model import forward, init_cache
    from repro_torch.quantized.qmodel import cache_bytes
    from repro_torch.serving import build_trace

    _, n_a, _, _, _, _ = ssm_dims(cfg)
    reqs = [Request(**t) for t in build_trace(cfg.vocab_size, **TRACE)[
        :SSM_SERVE_REQUESTS]]
    B = LEGACY["batch_size"]
    padded = padded_requests(Request, reqs, B)
    steps = TRACE["max_new"] - 1
    bf16 = cfg.compute_dtype != "float32"
    cache = init_cache(cfg, B, LEGACY["max_len"], device="cuda")
    state_bytes = cache_bytes(cache)
    del cache
    runs = {}
    for flash in flash_flags:
        scfg = dataclasses.replace(cfg, use_flash_decode=flash)
        server = BatchedServer(params_q, scfg, device="cuda", **LEGACY)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        outs = server.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        want = n_a * steps if flash else 0
        if counts["flash_decode"] != want or \
                any(v for k, v in counts.items() if k != "flash_decode"):
            raise AssertionError(f"{cfg.name} use_flash_decode={flash}: "
                                 f"launches {counts}, expected flash_decode "
                                 f"{want}")
        peak = torch.cuda.max_memory_allocated()
        toks = torch.tensor([list(r.prompt) for r in padded[:B]],
                            device="cuda")
        step_ms, family = ssm_decode_profile(
            torch, obs, server, params_q, toks, steps) if profile and \
            not flash else (legacy_step_profile(
                torch, server, params_q, padded, steps, False)[0], None)
        served = None
        if bf16:
            again, served = generate_with_logits(torch, server, reqs)
            if again != outs:
                raise AssertionError(f"{cfg.name} flash={flash}: the run "
                                     f"keeping its logits served other "
                                     f"tokens")
        runs[flash] = dict(outs=outs, wall=wall, counts=counts, peak=peak,
                           step_ms=step_ms, family=family, served=served,
                           tokens=sum(len(o) for o in outs))
        del server
    dense = oracle_weights(params_q, cfg)
    if bf16:
        ties = {f: [] for f in runs}
        held = {f: hold_served_logits(torch, forward, dense, cfg, padded,
                                      r["outs"], r.pop("served"),
                                      f"{cfg.name} flash={f}")
                for f, r in runs.items()}
        parted = [i for i, (a, b) in enumerate(zip(
            runs[False]["outs"], runs[True]["outs"])) if a != b] \
            if True in runs else []
        oracle = ("the full forward's logits over the dequantized weights, "
                  "teacher-forced on the served tokens")
    else:
        ties = {f: check_greedy(torch, forward, dense, cfg, padded,
                                runs[f]["outs"], f"{cfg.name} flash={f} vs "
                                f"oracle") for f in runs}
        held = {f: None for f in runs}
        parted = compare_runs(runs[False]["outs"], runs[True]["outs"],
                              {(i, j) for t in ties.values() for i, j, _ in t},
                              f"{cfg.name} flash off vs on") \
            if True in runs else []
        oracle = ("full forward over the dequantized weights on the "
                  "left-padded prompts")
    del dense
    torch.cuda.empty_cache()
    for f, r in runs.items():
        log("ssm_serving", arch=cfg.name, dtype=cfg.compute_dtype,
            use_flash_decode=f, requests=len(reqs), decode_steps=steps,
            tokens=r["tokens"], wall_s=r["wall"],
            tokens_per_s=r["tokens"] / r["wall"], step_ms=r["step_ms"],
            launches=r["counts"], state_and_kv_bytes=state_bytes,
            peak_bytes=r["peak"], near_ties=ties[f],
            logits_largest_and_bar=held[f], device_ms_by_family=r["family"],
            profile_window=f"{steps} decode steps of the batch"
            if r["family"] else None)
    try:
        PagedServer(params_q, cfg, device="cuda", **SERVE)
    except ValueError as e:
        refusal = str(e)
    else:
        raise AssertionError(f"{cfg.name}: PagedServer did not refuse")
    log("ssm_serving_check", arch=cfg.name, dtype=cfg.compute_dtype,
        parted_at=parted, oracle=oracle, paged_refusal=refusal)
    return runs[True]["counts"]["flash_decode"] if True in runs else None


def phase_ssm_serving_fp32(torch, ops, cfg, qcfg, flash_flags):
    """12b / 12c's fp32 check, shortened: ``cfg`` in fp32, random-init
    (seed 0) and packed by RTN, through ``phase_ssm_serving`` unprofiled
    (tokens held to the full-forward oracle at NEAR_TIE, flag-on run to
    flag-off run): the oracle that holds tokens, which a bf16 stack this
    deep cannot give. Returns the flag-on run's flash_decode launches."""
    from repro_torch.models.model import init_params
    from repro_torch.quantized.qmodel import pack_model

    c = dataclasses.replace(cfg, param_dtype="float32",
                            compute_dtype="float32")
    params_q = pack_model(init_params(c, torch.Generator(
        device="cuda").manual_seed(0), device="cuda"), qcfg)
    torch.cuda.empty_cache()
    flash = phase_ssm_serving(torch, ops, c, params_q, flash_flags,
                              profile=False)
    del params_q
    torch.cuda.empty_cache()
    return flash


def ssm_proposals(inv, cfg, seed, device):
    """CPU-drawn native proposals handed over on ``device`` for a search
    on ``cfg``: the Mamba adapter's within-head moves, and for a hybrid
    stack one source per phase (each from the seed)."""
    from repro_torch.core.search import MambaAdapter

    mamba = CpuProposals(inv, seed, device, MambaAdapter(cfg).propose)
    if cfg.block_pattern == "hybrid":
        return {"mamba": mamba, "shared": CpuProposals(inv, seed, device)}
    return mamba


def phase_small_ssm(torch, ops, arch, devs=("cpu", "cuda")):
    """12d: ``arch``'s reduced config on ``devs`` (the yardstick's device,
    then the device under test), from the same weights (drawn on the CPU),
    tokens and proposals: the forward's logits and taps (FWD_TOL), prefill
    + 3 decode steps (DECODE_TOL, logits and caches), RTN +
    SMALL_ZOO_STEPS steps with the fused flag (``histories_agree`` per
    phase), and BatchedServer's greedy tokens (identical; flash_decode on
    for the hybrid stack)."""
    import warnings

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import invariance as inv
    from repro_torch.core import rtn
    from repro_torch.core.quant import QuantConfig, fake_quant
    from repro_torch.core.search import SearchConfig
    from repro_torch.data.calib import calibration_tensor
    from repro_torch.launch.serve import BatchedServer, Request
    from repro_torch.models.model import (decode_step, forward, init_params,
                                          prefill)
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.quantized.qmodel import pack_model
    from repro_torch.search import run
    from repro_torch.serving import build_trace

    t0 = time.perf_counter()
    cfg = get_config(arch).reduced()
    # group 8: at the reduced head_dim 16 a within-head move then changes
    # the codes; at 32 every move ties (tests/test_torch_ssm_search_serve.py)
    qcfg = QuantConfig(bits=2, group_size=8)
    params = init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    calib = calibration_tensor(cfg.vocab_size, n_seqs=4, seq_len=64,
                               device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (3, 12)))
    scfg = SearchConfig(steps=SMALL_ZOO_STEPS, fused_kernel=True, log_every=0,
                        proposal=inv.ProposalConfig(subset_frac=0.5))
    hybrid = cfg.block_pattern == "hybrid"
    scfg_cfg = dataclasses.replace(cfg, use_flash_decode=hybrid)
    trace = build_trace(cfg.vocab_size, n_tenants=2, per_tenant=2,
                        page_size=8, max_new=5)
    params_q = pack_model(params, QuantConfig(2, 32))
    outs = []
    for d in map(torch.device, devs):
        p = to_device(params, d)
        lg, hid = forward(p, cfg, calib.to(d), collect_hidden=True)
        logits = [lg.cpu(), hid.cpu()]
        lg, cache = prefill(p, cfg, toks[:, :9].to(d), 32)
        logits.append(lg.cpu())
        for t in range(9, 12):
            lg, cache = decode_step(p, cfg, toks[:, t:t + 1].to(d), cache, t)
            logits.append(lg.cpu())
        base = rtn.map_quantizable(p, lambda w, _: fake_quant(w, qcfg),
                                   only=lambda q: q[-1] not in
                                   FFN_KEYS + MAMBA_KEYS)
        ops.reset_launch_counts()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)   # the Mamba fallback
            res = run(p, base, cfg, qcfg, calib.to(d), scfg,
                      proposals=ssm_proposals(inv, cfg, 3, d))
        counts = dict(ops.LAUNCHES)
        want = ssm_quantize_launches(cfg, scfg) if d.type == "cuda" else {}
        if d.type == "cuda":       # the search alone: no freeze, no RTN pass
            want = dict(want, group_quant=want["group_quant"]
                        - (4 if hybrid else 0))
        if any(counts[k] != want.get(k, 0) for k in counts):
            raise AssertionError(f"{arch}: search launches {counts} != {want}")
        ops.reset_launch_counts()
        served = BatchedServer(to_device(params_q, d), scfg_cfg, batch_size=4,
                               max_len=64, device=d).generate(
            [Request(**t) for t in trace])
        serve_counts = dict(ops.LAUNCHES)
        outs.append((logits, [x.cpu() for x in tree_leaves(cache)],
                     res.history, served, serve_counts))
        del p, base, res, cache
    (l_ref, c_ref, h_ref, s_ref, _), (l_dev, c_dev, h_dev, s_dev, n_dev) = outs
    fwd_err = within(torch, l_dev[:2], l_ref[:2], what=f"{arch} forward",
                     **FWD_TOL)
    dec_err = within(torch, l_dev[2:] + c_dev, l_ref[2:] + c_ref,
                     what=f"{arch} prefill / decode", **DECODE_TOL)
    compared, parted = [], []
    for ha, hb in zip(history_phases(h_dev), history_phases(h_ref)):
        c, p_ = histories_agree(ha, hb, f"{arch} search")
        compared.append(c)
        parted.append(p_)
    if s_dev != s_ref:
        raise AssertionError(f"{arch}: served tokens differ")
    if devs[1] == "cuda":     # one batch of 4, 4 decode steps
        want = ssm_dims(cfg)[1] * (-(-len(trace) // 4)) * (5 - 1) \
            if hybrid else 0
        if n_dev["flash_decode"] != want or any(
                v for k, v in n_dev.items() if k != "flash_decode"):
            raise AssertionError(f"{arch}: serve launches {n_dev}")
    log("small_ssm", arch=arch, devices=list(devs), pattern=cfg.block_pattern,
        layout=list(cfg.hybrid_layout()) if hybrid else None,
        forward_max_abs_diff=fwd_err, decode_max_abs_diff=dec_err,
        search_compared=compared, search_parted_at=parted,
        card_losses=[h[1] for h in h_dev], ref_losses=[h[1] for h in h_ref],
        serve_launches=n_dev, tokens_identical=True,
        seconds=time.perf_counter() - t0)


def phase_ssm(torch, ops, ref, get_config, qcfg):
    """Phase 12 (12a-12d) in the configs' own bf16: 12a Mamba2-2.7B RTN ±
    STEPS steps after ``group_quant`` at its shapes, 12b its
    BatchedServer; 12c Zamba2-7B (HYBRID_LAYERS blocks) after
    ``group_quant`` at its shapes, ``transform_quant`` at the shared FFN
    and ``flash_decode`` at Dh 112 on a bf16 cache: the two-phase search
    and BatchedServer flag off / on; the bf16-vs-fp32 accept decisions of
    both; 12d both reduced, card against CPU, in fp32 and in bf16. Returns
    the launch counts and kernel rows the kernels line carries."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = ssm_config(get_config)
    gq_check = gq_shapes_check(torch, ops, ref, cfg, ssm_gq_shapes(cfg),
                               "w_z/w_x stack", 4322,
                               **own_dtype_kw(torch, cfg))
    params_q, pack_s, mamba = phase_ssm_main(torch, ops, cfg, qcfg)
    t1 = time.perf_counter()
    phase_ssm_serving(torch, ops, cfg, params_q)
    del params_q
    torch.cuda.empty_cache()
    phase_ssm_serving_fp32(torch, ops, cfg, qcfg, (False,))
    t2 = time.perf_counter()
    hcfg = ssm_config(get_config, HYBRID_ARCH)
    gq_shapes_check(torch, ops, ref, hcfg, ssm_gq_shapes(hcfg),
                    "w_z/w_x stack", 4322, **own_dtype_kw(torch, hcfg))
    tq = tq_check(torch, ops, ref, hcfg.name, hcfg.d_model, hcfg.d_ff, qcfg,
                  4325, torch.bfloat16)
    attn = attn_kernels_at(torch, ops, ref, hcfg, ("flash_decode",),
                           trace_decode_lens(hcfg), (torch.bfloat16,),
                           torch.bfloat16)
    params_q, _, hybrid = phase_ssm_main(torch, ops, hcfg, qcfg)
    flash = phase_ssm_serving(torch, ops, hcfg, params_q, (False, True))
    del params_q
    torch.cuda.empty_cache()
    flash32 = phase_ssm_serving_fp32(torch, ops, hcfg, qcfg, (False, True))
    t3 = time.perf_counter()
    differing = {c.name: family_accepts(torch, ops, c, qcfg)
                 for c in (cfg, hcfg)}
    t4 = time.perf_counter()
    for arch in SSM_ARCHS:
        phase_small_ssm(torch, ops, arch)
        phase_small_bf16(torch, ops, arch)
    t5 = time.perf_counter()
    log("phase12", seconds=t5 - t0, a_s=t1 - t0, b_s=t2 - t1, c_s=t3 - t2,
        accepts_s=t4 - t3, d_s=t5 - t4, pack_s=pack_s,
        accept_decisions_differing=differing)
    return dict(mamba=mamba, hybrid=hybrid, flash=flash, flash32=flash32,
                gq_check=gq_check, tq=tq, attn=attn, differing=differing)


# ---------------------------------------------------------------------------
# phase 13: the encoder-decoder and vision families; SeamlessM4T-medium and
# InternVL2-1B at full width and depth
# ---------------------------------------------------------------------------

ENCDEC_ARCH = "seamless-m4t-medium"
VLM_ARCH = "internvl2-1b"
ENCDEC_ARCHS = (ENCDEC_ARCH, VLM_ARCH)
ENC_FFN = (("enc_blocks", "mlp", "up"), ("enc_blocks", "mlp", "down"))
ENCDEC_SERVE = dict(batch=8, steps=16)  # 13b / 13c: B 8, 16 greedy tokens
# 13c profiles PagedServer over 1 request (8 took 37 s on the H100, 2 took
# 22.6-24.6 s: the profiler's events cost ≈ 0.2 ms each to read; 1 since
# phase 15)
VLM_PROFILE_REQUESTS = 1
TRAIN13 = dict(batch=2, seq=512, frames=512, steps=4)    # 13d


def encdec_config(get_config, arch=ENCDEC_ARCH):
    """``arch`` at full width and depth in its own dtype."""
    return get_config(arch)


def encdec_param_count(cfg) -> int:
    """Parameters of the port's ``init_params`` tree: the dense decoder
    (``dense_param_count``), and for an encoder-decoder stack each decoder
    block's cross-attention and ``ln_x``, the encoder blocks and
    ``enc_norm``."""
    n = dense_param_count(cfg)
    if cfg.is_enc_dec:
        attn, mlp, norm = dense_parts(cfg)
        n += cfg.n_layers * (attn + norm) \
            + cfg.encoder_layers * (attn + mlp + 2 * norm) + norm
    return n


def encdec_forward_flops(cfg, B, S, T=0) -> int:
    """Operations of one forward over (B, S) tokens (S counts a vision
    stack's patches): the decoder (``forward_flops``), and for an
    encoder-decoder stack over T frames the encoder's projections and its
    non-causal attention over T x T pairs a head, and each decoder block's
    cross-attention: q and o over the S tokens, k and v over the T frames,
    QK^T and PV over S x T pairs a head."""
    n = forward_flops(cfg, B, S)
    if cfg.is_enc_dec:
        D, F = cfg.d_model, cfg.d_ff
        hd, hq, hkv = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
        proj = 2 * D * hq * hd + 2 * D * hkv * hd
        n_ffn = 2 + int(cfg.gated_mlp)
        n += 2 * B * T * cfg.encoder_layers * (proj + n_ffn * D * F) \
            + 2 * 2 * cfg.encoder_layers * B * T * T * hq * hd
        n += cfg.n_layers * (2 * B * S * 2 * D * hq * hd
                             + 2 * B * T * 2 * D * hkv * hd
                             + 2 * 2 * B * S * T * hq * hd)
    return n


def cross_cache_bytes(cfg, B, T, elem=4) -> int:
    """The cross-attention K/V ``prefill`` caches: (L, B, T, Hkv, Dh) twice."""
    return 2 * cfg.n_layers * B * T * cfg.n_kv_heads \
        * cfg.resolved_head_dim * elem


def encdec_gq_shapes(cfg):
    """The distinct (K, N) shapes a dense stack with or without an encoder
    gives ``group_quant`` (each stacked (L, K, N) leaf flattened to (L·K,
    N)): the attention leaves of the decoder, of its cross-attention (the
    same shapes) and of the encoder, and the FFN stacks of both (RTN; the
    search's initial stack is the decoder's). Shapes that coincide are
    named together."""
    D, F = cfg.d_model, cfg.d_ff
    hq = cfg.n_heads * cfg.resolved_head_dim
    hkv = cfg.n_kv_heads * cfg.resolved_head_dim
    up = "up/gate" if cfg.gated_mlp else "up"
    stacks = [("", cfg.n_layers)]
    if cfg.is_enc_dec:
        stacks.append(("enc ", cfg.encoder_layers))
    named = {}
    for pre, L in stacks:
        for name, shape in (("wq", (L * D, hq)), ("wk/wv", (L * D, hkv)),
                            ("wo", (L * hq, D)), (up, (L * D, F)),
                            ("down", (L * F, D))):
            named.setdefault(shape, []).append(pre + name)
    return tuple((" ".join(n), shape) for shape, n in named.items())


def encdec_gq_check(torch, ops, ref, cfg):
    """13a's and 13c's kernel check (``gq_shapes_check``, w in the
    config's dtype) at every shape of ``encdec_gq_shapes``, timed at the
    largest."""
    shapes = encdec_gq_shapes(cfg)
    timed = max(shapes, key=lambda s: s[1][0] * s[1][1])[0]
    return gq_shapes_check(torch, ops, ref, cfg, shapes, timed, 4323,
                           **own_dtype_kw(torch, cfg))


def encdec_quantize_launches(cfg, scfg=None, stats=None):
    """``group_quant`` / ``transform_quant`` launches of one
    ``quantize_model(method="rtn", search=scfg)`` on a dense config with or
    without an encoder: the freeze takes one launch per stacked attention
    leaf (wq, wk, wv, wo) of the decoder, the cross-attention and the
    encoder; then RTN alone one per stacked FFN weight of the decoder and
    the encoder, or the search (``search_launches``) on the decoder's FFNs
    alone — the encoder's FFN stays at full precision."""
    n_attn = 1 + 2 * int(cfg.is_enc_dec)
    n_w = 2 + int(cfg.gated_mlp)
    if scfg is None:
        return {"group_quant": 4 * n_attn + n_w * (1 + int(cfg.is_enc_dec)),
                "transform_quant": 0}
    want = search_launches(cfg, scfg, stats)
    return {"group_quant": 4 * n_attn + want["group_quant"],
            "transform_quant": want["transform_quant"]}


def frontend_kw(torch, cfg, batch, seed, n=None, device="cuda"):
    """{"enc_embeds" | "vision_embeds": the stub frontend's (batch, n, D)
    draw from a generator seeded with ``seed`` on ``device``}; n defaults to
    ``cfg.frontend_len``."""
    from repro_torch.models import frontends

    gen = torch.Generator(device=device).manual_seed(seed)
    if cfg.is_enc_dec:
        return {"enc_embeds": frontends.stub_audio_frames(
            gen, cfg, batch, n or cfg.frontend_len, device=device)}
    return {"vision_embeds": frontends.stub_vision_embeds(
        gen, cfg, batch, n, device=device)}


def serve_with_frontend(torch, ops, cfg, params_q, toks, kw, steps):
    """``make_prefill_step`` on {tokens, frontend input} then ``steps - 1``
    greedy ``make_serve_step`` calls from position P+S: (tokens (B,
    steps), host ms per decode step, launch counts, the cache's cross K/V
    bytes)."""
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    P = kw["vision_embeds"].shape[1] if "vision_embeds" in kw else 0
    S = toks.shape[1]
    prefill = make_prefill_step(cfg, P + S + steps)
    serve = make_serve_step(cfg)
    ops.reset_launch_counts()
    logits, cache = prefill(params_q, {"tokens": toks, **kw})
    out = [torch.argmax(logits[:, -1, :cfg.vocab_size], dim=-1)[:, None]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(steps - 1):
        nxt, cache = serve(params_q, out[-1], cache, P + S + t)
        out.append(nxt)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3 / max(steps - 1, 1)
    xbytes = sum(x.numel() * x.element_size() for x in cache["cross"]) \
        if cache.get("cross") is not None else 0
    return torch.cat(out, dim=1), step_ms, dict(ops.LAUNCHES), xbytes


def frontend_serving(torch, ops, cfg, params_q, toks, kw, tag):
    """13b / 13c: the packed model served through the steps with the
    frontend input, ``use_flash_decode`` off and on: tokens held to the
    full-forward oracle and to each other, flash_decode launched
    n_layers x (steps - 1) times with the flag on and never with it off.
    Returns (the flag-on run's launches, the runs)."""
    from types import SimpleNamespace

    from repro_torch.models.model import forward

    steps = ENCDEC_SERVE["steps"]
    runs = {}
    for flash in (False, True):
        c = dataclasses.replace(cfg, use_flash_decode=flash)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        gen, step_ms, counts, xbytes = serve_with_frontend(
            torch, ops, c, params_q, toks, kw, steps)
        want = cfg.n_layers * (steps - 1) if flash else 0
        if counts["flash_decode"] != want or \
                any(v for k, v in counts.items() if k != "flash_decode"):
            raise AssertionError(f"{cfg.name} flash={flash}: launches "
                                 f"{counts}, expected flash_decode {want}")
        runs[flash] = dict(gen=gen, step_ms=step_ms, counts=counts,
                           cross_bytes=xbytes,
                           peak=torch.cuda.max_memory_allocated())
    dense = oracle_weights(params_q, cfg)
    prompts = [SimpleNamespace(prompt=p) for p in toks.tolist()]
    ties = {f: check_greedy(torch, forward, dense, cfg, prompts,
                            r["gen"].tolist(), f"{cfg.name} flash={f} vs "
                            f"oracle", kw=kw)
            for f, r in runs.items()}
    del dense
    torch.cuda.empty_cache()
    parted = compare_runs(runs[False]["gen"].tolist(),
                          runs[True]["gen"].tolist(),
                          {(i, j) for t in ties.values() for i, j, _ in t},
                          f"{cfg.name} flash off vs on")
    for f, r in runs.items():
        log(tag, arch=cfg.name, use_flash_decode=f, batch=toks.shape[0],
            prompt_len=toks.shape[1],
            frontend={k: list(v.shape) for k, v in kw.items()},
            tokens=int(r["gen"].numel()), step_ms=r["step_ms"],
            launches=r["counts"], cross_cache_bytes=r["cross_bytes"],
            peak_bytes=r["peak"], near_ties=ties[f])
    log(tag + "_check", arch=cfg.name, parted_at=parted,
        outputs_identical=not parted,
        oracle="full forward over the dequantized weights with the same "
               "frontend input")
    return runs[True]["counts"]["flash_decode"], runs


def trace_prompts(torch, Request, cfg, n):
    """The trace's first ``n`` prompts left-padded with 0 to the longest
    (as ``BatchedServer`` pads a batch), on the card."""
    from repro_torch.serving import build_trace

    reqs = [Request(**t) for t in build_trace(cfg.vocab_size, **TRACE)[:n]]
    padded = padded_requests(Request, reqs, n)
    return torch.tensor([list(r.prompt) for r in padded], device="cuda")


def phase_encdec_main(torch, ops, cfg, qcfg):
    """13a: Seamless at full width and depth in its own dtype (bf16):
    ``quantize_model`` RTN
    alone and with STEPS fused steps on 4 x 512 calibration tokens and 4 x
    ``frontend_len`` stub frames through ``forward_kwargs``; held-out ppl on
    4 x 512 other tokens with their own frames. The encoder's FFN leaves
    must be unchanged by the search and changed by RTN; launches held to
    ``encdec_quantize_launches``; GPTQ, AWQ and OmniQuant must raise
    ValueError. Then one candidate's forward + objective beside its
    operations (``encdec_forward_flops``), and the params packed at 2
    bits / g32. Returns (the packed params, the launch counts by run)."""
    from repro_torch.core.objective import activation_mse, calib_ce
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.rtn import get_by_path
    from repro_torch.core.search import SearchConfig
    from repro_torch.data.calib import calibration_tensor
    from repro_torch.models.model import forward, init_params, lm_loss
    from repro_torch.optim.adamw import tree_leaves
    from repro_torch.quantized.qmodel import pack_model

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    calib = calibration_tensor(cfg.vocab_size, n_seqs=4, seq_len=512,
                               seed=99, device="cuda")
    held = calibration_tensor(cfg.vocab_size, n_seqs=4, seq_len=512,
                              seed=123, device="cuda")
    kw = frontend_kw(torch, cfg, 4, seed=1)
    held_kw = frontend_kw(torch, cfg, 4, seed=2)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    if n_params != encdec_param_count(cfg):
        raise AssertionError(f"{n_params} params != "
                             f"{encdec_param_count(cfg)}")
    elem = torch.finfo(getattr(torch, cfg.param_dtype)).bits // 8
    log("encdec_setup", arch=cfg.name, n_layers=cfg.n_layers,
        encoder_layers=cfg.encoder_layers, d_model=cfg.d_model,
        heads=[cfg.n_heads, cfg.n_kv_heads], head_dim=cfg.resolved_head_dim,
        d_ff=cfg.d_ff, vocab=cfg.vocab_size, padded_vocab=cfg.padded_vocab,
        frontend=cfg.frontend, frames=list(kw["enc_embeds"].shape),
        dtype=cfg.param_dtype, params=n_params,
        param_count=cfg.param_count(), param_bytes=elem * n_params,
        calib=list(calib.shape), seconds=time.perf_counter() - t0)

    def ppl(p):
        logits = forward(p, cfg, held, **held_kw)
        return math.exp(float(lm_loss(logits[:, :-1], held[:, 1:],
                                      cfg.vocab_size)))

    ppl_fp = ppl(params)
    scfg = SearchConfig(steps=STEPS, fused_kernel=True, log_every=0)
    launches = {"group_quant": {}, "transform_quant": {}}
    results = {}
    for search in (None, scfg):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = quantize_model(params, cfg, qcfg, "rtn", calib, search,
                             forward_kwargs=kw, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, peak = dict(ops.LAUNCHES), torch.cuda.max_memory_allocated()
        sr, label = res.search, res.method
        want = encdec_quantize_launches(cfg, search, sr.stats if sr else None)
        if any(counts[k] != want.get(k, 0) for k in counts):
            raise AssertionError(f"{label}: launches {counts}, expected "
                                 f"{want}")
        enc_ffn_equal = [bool(torch.equal(get_by_path(res.params_q, p),
                                          get_by_path(params, p)))
                         for p in ENC_FFN]
        if enc_ffn_equal != [search is not None] * len(ENC_FFN):
            raise AssertionError(f"{label}: encoder FFN leaves equal to the "
                                 f"FP weights: {enc_ffn_equal} (the search "
                                 f"leaves them, RTN quantizes them)")
        ppl_q = ppl(res.params_q)
        nums = [ppl_q] + ([sr.initial_loss, sr.final_loss]
                          + [h[1] for h in sr.history] if sr else [])
        if not all(math.isfinite(x) for x in nums):
            raise AssertionError(f"{label}: non-finite numbers {nums}")
        extra = {}
        if sr:
            if not sr.final_loss <= sr.initial_loss:
                raise AssertionError(f"{label}: final loss above initial")
            extra = dict(initial_loss=sr.initial_loss,
                         final_loss=sr.final_loss,
                         accept_rate=sr.accept_rate, steps=STEPS,
                         units=sr.transforms.pi.shape[0],
                         step_ms=1e3 / sr.stats["proposals_per_sec"])
            results["step_ms"] = extra["step_ms"]
        log("encdec_quantize", arch=cfg.name, method=label, ppl_fp32=ppl_fp,
            ppl=ppl_q, wall_s=wall, peak_bytes=peak, launches=counts,
            expected=want, encoder_ffn_at_full_precision=enc_ffn_equal[0],
            **extra)
        for kernel in launches:
            launches[kernel][label] = counts[kernel]
        del res, sr
    refusals = {}
    for method in BASE_METHODS:
        try:
            quantize_model(params, cfg, qcfg, method, calib, device="cuda")
        except ValueError as e:
            refusals[method] = str(e)
        else:
            raise AssertionError(f"{method} did not refuse {cfg.name}")
    B, S = calib.shape
    T = kw["enc_embeds"].shape[1]

    def eval_once():
        logits, hidden = forward(params, cfg, calib, collect_hidden=True,
                                 **kw)
        return calib_ce(logits, calib, cfg.vocab_size), \
            activation_mse(hidden, hidden, 10)

    fwd_ms = time_ms(torch, eval_once, warmup=1, reps=3)
    flops = encdec_forward_flops(cfg, B, S, T)
    log("encdec_step", arch=cfg.name, forward_objective_ms=fwd_ms,
        step_ms=results.get("step_ms"), forward_flops=flops,
        forward_tflops_per_s=flops / fwd_ms / 1e9,
        **peak_share(flops, fwd_ms, elem), frames=T, refusals=refusals)
    del calib, held, kw, held_kw
    params_q = pack_model(params, qcfg)
    del params
    torch.cuda.empty_cache()
    return params_q, launches


def phase_encdec_serving(torch, ops, cfg, params_q):
    """13b: the packed Seamless through ``make_prefill_step`` (B 8 of the
    trace's first prompts, left-padded, with 8 x ``frontend_len`` stub
    frames) and 15 ``make_serve_step`` calls (``frontend_serving``); one
    decode step's device time by family and idle share under the profiler
    (``ssm_decode_profile``); then PagedServer and BatchedServer must raise
    ValueError. Returns the flag-on run's flash_decode launches."""
    from types import SimpleNamespace

    from repro_torch import obs
    from repro_torch.launch.serve import BatchedServer, PagedServer, Request
    from repro_torch.launch.steps import make_prefill_step, make_serve_step

    B = ENCDEC_SERVE["batch"]
    toks = trace_prompts(torch, Request, cfg, B)
    kw = frontend_kw(torch, cfg, B, seed=3)
    flash, runs = frontend_serving(torch, ops, cfg, params_q, toks, kw,
                                   "encdec_steps")
    if runs[True]["cross_bytes"] != cross_cache_bytes(
            cfg, B, kw["enc_embeds"].shape[1],
            kw["enc_embeds"].element_size()):
        raise AssertionError(f"cross cache {runs[True]['cross_bytes']} bytes")
    steps = ENCDEC_SERVE["steps"] - 1
    prefill = make_prefill_step(cfg, toks.shape[1] + steps + 1)
    server = SimpleNamespace(
        cfg=cfg, step_fn=make_serve_step(cfg),
        prefill_fn=lambda p, batch: prefill(p, {**batch, **kw}))
    step_ms, family = ssm_decode_profile(torch, obs, server, params_q, toks,
                                         steps)
    refusals = {}
    for name, make in (("PagedServer", lambda: PagedServer(
            params_q, cfg, device="cuda", **SERVE)),
            ("BatchedServer", lambda: BatchedServer(
                params_q, cfg, device="cuda", **LEGACY))):
        try:
            make()
        except ValueError as e:
            refusals[name] = str(e)
        else:
            raise AssertionError(f"{name} did not refuse {cfg.name}")
    log("encdec_serving_profile", arch=cfg.name, step_ms=step_ms,
        decode_steps=steps, **family, refusals=refusals)
    return flash


def phase_vlm(torch, ops, ref, cfg, qcfg, pd_rows):
    """13c: InternVL2 at full width and depth in its own dtype (bf16; 14/2
    heads: GQA rep 7; qkv biases; tied embeddings). RTN and AWQ, each alone
    and with STEPS
    fused steps, on text (``phase_zoo_main``); the packed model through the
    steps with 8 x 256 stub patches (``frontend_serving``: decode from
    P+S, flash_decode at rep 7), PagedServer over the trace with sharing
    off, on and MP 2 (``phase_serving``, profiled over
    VLM_PROFILE_REQUESTS requests), and BatchedServer flag off / on
    (``phase_legacy_serving``); the rep-7 kernels (``attn_kernels_at``: f32,
    int8 and bf16 caches, timed on bf16) and ``transform_quant`` at its FFN
    in bf16; and the CE search with patches must raise ValueError. Returns
    the launch counts and the kernel rows."""
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.search import SearchConfig
    from repro_torch.data.calib import calibration_tensor
    from repro_torch.launch.serve import Request
    from repro_torch.models.model import init_params

    params_q, pack_s, launches = phase_zoo_main(torch, ops, cfg, qcfg,
                                                tag="vlm")
    B = ENCDEC_SERVE["batch"]
    toks = trace_prompts(torch, Request, cfg, B)
    kw = frontend_kw(torch, cfg, B, seed=4)
    flash, _ = frontend_serving(torch, ops, cfg, params_q, toks, kw,
                                "vlm_steps")
    paged, _ = phase_serving(torch, ops, pd_rows, cfg, params_q, pack_s,
                             variants=ZOO_SERVE, tag="vlm_",
                             profile_requests=VLM_PROFILE_REQUESTS)
    legacy = phase_legacy_serving(torch, ops, cfg, params_q, profile=False)
    del params_q
    torch.cuda.empty_cache()
    rep7 = attn_kernels_at(torch, ops, ref, cfg, (
        "paged_decode_gqa", "paged_decode_gqa_mp", "flash_decode"),
        trace_decode_lens(cfg), (torch.float32, torch.int8, torch.bfloat16),
        torch.bfloat16)
    tq = tq_check(torch, ops, ref, cfg.name, cfg.d_model, cfg.d_ff, qcfg,
                  4326, torch.bfloat16)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    calib = calibration_tensor(cfg.vocab_size, n_seqs=2, seq_len=64, seed=99,
                               device="cuda")
    try:
        quantize_model(params, cfg, qcfg, "rtn", calib,
                       SearchConfig(steps=1, log_every=0),
                       forward_kwargs=frontend_kw(torch, cfg, 2, seed=5),
                       device="cuda")
    except ValueError as e:
        refusal = str(e)
    else:
        raise AssertionError("the CE search with vision_embeds did not raise")
    del params
    torch.cuda.empty_cache()
    log("vlm_search_refusal", arch=cfg.name, error=refusal)
    return dict(main=launches, flash=flash, legacy_flash=legacy,
                paged=paged, rep7=rep7, vlm_tq=tq)


def phase_encdec_train(torch, cfg):
    """13d: ``run_train_steps`` at full width and depth in the config's own
    bf16 (``TRAIN13``: B 2 x 512 tokens, 512 stub encoder frames or the
    256 patches, 4 steps at lr 1e-4 after one warm-up step): losses finite,
    the logged quantities of ``run_train_steps`` and the forward + backward
    operations by ``encdec_forward_flops`` (the encoder's and the patches'
    included), peak bytes against ``train_reckoning``. No fp32 step is kept:
    14e's and the CPU tests' checks of the bf16 step cover what 13d's fp32
    run used to show (finite losses, the peak)."""
    B, S = TRAIN13["batch"], TRAIN13["seq"]
    kw = frontend_kw(torch, cfg, B, seed=6,
                     n=TRAIN13["frames"] if cfg.is_enc_dec else None)
    row = run_train_steps(torch, cfg, B, S, TRAIN13["steps"], TRAIN_LR, kw,
                          seed=200)
    T = kw["enc_embeds"].shape[1] if cfg.is_enc_dec else 0
    P = kw["vision_embeds"].shape[1] if "vision_embeds" in kw else 0
    flops = 3 * encdec_forward_flops(cfg, B, P + S, T)
    log("encdec_train", arch=cfg.name, dtype=cfg.param_dtype, batch=B,
        seq=S, frontend={k: list(v.shape) for k, v in kw.items()},
        train_flops=flops,
        forward_backward_tflops_per_s=flops / row["step_ms"] / 1e9, **row)


def phase_small_encdec(torch, ops, arch, devs=("cpu", "cuda")):
    """13e: ``arch``'s reduced config on ``devs`` (the yardstick's device,
    then the device under test), from the same weights, tokens, frontend
    input (drawn on the CPU) and proposals: the forward's logits and taps
    with the frontend input (FWD_TOL), prefill + 3 decode steps (DECODE_TOL,
    logits and caches, the cross K/V included), RTN + SMALL_ZOO_STEPS fused
    steps (Seamless with its frames through ``forward_kwargs``, InternVL2 on
    text: ``histories_agree``; launches held to ``search_launches``), and 3
    train steps with the frontend input (9d's bars)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import invariance as inv
    from repro_torch.core import rtn
    from repro_torch.core.quant import QuantConfig, fake_quant
    from repro_torch.core.search import SearchConfig
    from repro_torch.data.calib import calibration_tensor
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import (decode_step, forward, init_params,
                                          prefill)
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, tree_leaves
    from repro_torch.search import run

    t0 = time.perf_counter()
    cfg = get_config(arch).reduced()
    qcfg = QuantConfig(bits=2, group_size=32)
    params = init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    calib = calibration_tensor(cfg.vocab_size, n_seqs=4, seq_len=64,
                               device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (3, 12)))
    kw_cal = frontend_kw(torch, cfg, 4, seed=8, device="cpu")
    kw_dec = frontend_kw(torch, cfg, 3, seed=9, device="cpu")
    P = cfg.frontend_len if cfg.frontend == "vision" else 0
    scfg = SearchConfig(steps=SMALL_ZOO_STEPS, fused_kernel=True, log_every=0)
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, total_steps=10,
                                            warmup_steps=1))
    outs = []
    for d in map(torch.device, devs):
        p = to_device(params, d)
        kc = {k: v.to(d) for k, v in kw_cal.items()}
        kd = {k: v.to(d) for k, v in kw_dec.items()}
        lg, hid = forward(p, cfg, calib.to(d), collect_hidden=True, **kc)
        logits = [lg.cpu(), hid.cpu()]
        lg, cache = prefill(p, cfg, toks[:, :9].to(d), 32, **kd)
        logits.append(lg.cpu())
        for t in range(9, 12):
            lg, cache = decode_step(p, cfg, toks[:, t:t + 1].to(d), cache,
                                    P + t)
            logits.append(lg.cpu())
        caches = [x.cpu() for k in sorted(cache) for x in (
            cache[k] if isinstance(cache[k], tuple) else (cache[k],))]
        base = rtn.map_quantizable(p, lambda w, _: fake_quant(w, qcfg),
                                   only=lambda q: q[-1] not in FFN_KEYS)
        ops.reset_launch_counts()
        res = run(p, base, cfg, qcfg, calib.to(d), scfg,
                  proposals=CpuProposals(inv, 3, d),
                  forward_kwargs=kc if cfg.is_enc_dec else None)
        counts = dict(ops.LAUNCHES)
        want = search_launches(cfg, scfg, res.stats) if d.type == "cuda" \
            else {}
        if any(counts[k] != want.get(k, 0) for k in counts):
            raise AssertionError(f"{arch}: search launches {counts} != {want}")
        state, losses = (p, adamw_init(p)), []
        for i in range(3):
            batch = {"tokens": calibration_tensor(
                cfg.vocab_size, 2, 32, seed=300 + i, device=d),
                **{k: v[:2] for k, v in kc.items()}}
            new_p, new_o, m = step(*state, batch)
            state = (new_p, new_o)
            losses.append(float(m["loss"]))
        outs.append((logits, caches, res.history, losses,
                     [x.cpu() for x in tree_leaves(state[0])]))
        del p, base, res, cache, state
    (l_ref, c_ref, h_ref, t_ref, p_ref), (l_dev, c_dev, h_dev, t_dev,
                                          p_dev) = outs
    fwd_err = within(torch, l_dev[:2], l_ref[:2], what=f"{arch} forward",
                     **FWD_TOL)
    dec_err = within(torch, l_dev[2:] + c_dev, l_ref[2:] + c_ref,
                     what=f"{arch} prefill / decode", **DECODE_TOL)
    compared, parted = histories_agree(h_dev, h_ref, f"{arch} search")
    rel = max(abs(a - b) / abs(b) for a, b in zip(t_dev, t_ref))
    if rel > 1e-5:
        raise AssertionError(f"{arch}: train losses {t_dev} vs {t_ref}")
    train_err = within(torch, p_dev, p_ref, what=f"{arch} train params",
                       **ACCUM_TOL)
    log("small_encdec", arch=arch, devices=list(devs),
        frontend=cfg.frontend, frontend_len=cfg.frontend_len,
        encoder_layers=cfg.encoder_layers, forward_max_abs_diff=fwd_err,
        decode_max_abs_diff=dec_err, search_compared=compared,
        search_parted_at=parted, card_losses=[h[1] for h in h_dev],
        ref_losses=[h[1] for h in h_ref], train_losses=t_dev,
        train_max_rel_loss_diff=rel, train_params_max_abs_diff=train_err,
        seconds=time.perf_counter() - t0)


def phase_encdec(torch, ops, ref, get_config, qcfg, pd_rows):
    """Phase 13 (13a-13e) in the configs' own bf16, after ``group_quant``
    is held to its plain version at both models' shapes
    (``encdec_gq_check``) and ``transform_quant`` and ``flash_decode`` at
    Seamless's decoder (13c holds InternVL2's): 13a-13c, the bf16-vs-fp32
    accept decisions of both, 13d the bf16 train steps, 13e both reduced,
    card against CPU, in fp32 and in bf16. Returns the launch counts and
    rows the kernels line carries."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = encdec_config(get_config)
    vcfg = encdec_config(get_config, VLM_ARCH)
    checks = {c.name: encdec_gq_check(torch, ops, ref, c) for c in (cfg, vcfg)}
    gq_check = (max(e for e, _ in checks.values()),
                {arch: row for arch, (_, row) in checks.items()})
    tq = tq_check(torch, ops, ref, cfg.name, cfg.d_model, cfg.d_ff, qcfg,
                  4327, torch.bfloat16)
    attn = attn_kernels_at(torch, ops, ref, cfg, ("flash_decode",),
                           trace_decode_lens(cfg), (torch.bfloat16,),
                           torch.bfloat16)
    params_q, seamless = phase_encdec_main(torch, ops, cfg, qcfg)
    t1 = time.perf_counter()
    seamless_flash = phase_encdec_serving(torch, ops, cfg, params_q)
    del params_q
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    vlm = phase_vlm(torch, ops, ref, vcfg, qcfg, pd_rows)
    t3 = time.perf_counter()
    differing = {cfg.name: family_accepts(
        torch, ops, cfg, qcfg, kw=frontend_kw(torch, cfg, 4, seed=1)),
        vcfg.name: family_accepts(torch, ops, vcfg, qcfg)}
    t4 = time.perf_counter()
    for c in (cfg, vcfg):
        phase_encdec_train(torch, c)
    t5 = time.perf_counter()
    for arch in ENCDEC_ARCHS:
        phase_small_encdec(torch, ops, arch)
        phase_small_bf16(torch, ops, arch)
    t6 = time.perf_counter()
    log("phase13", seconds=t6 - t0, a_s=t1 - t0, b_s=t2 - t1, c_s=t3 - t2,
        accepts_s=t4 - t3, d_s=t5 - t4, e_s=t6 - t5,
        accept_decisions_differing=differing)
    return dict(seamless=seamless, seamless_flash=seamless_flash,
                gq_check=gq_check, tq=tq, attn=attn, differing=differing,
                **vlm)


# ---------------------------------------------------------------------------
# the families in their own bf16: checks shared by phases 11-14
# ---------------------------------------------------------------------------

BF16_ULPS = 2          # tests/test_torch_bf16.py's elementwise bar
BF16_FARTHER = 1.25    # and its bar against the fp32 forward
BF16_LOSS_RTOL = 1e-3  # tests/test_torch_bf16_search.py's LOSS_RTOL


def own_dtype_kw(torch, cfg):
    """``gq_shapes_check``'s w dtype and ``round_range`` for ``cfg``'s
    params (a bf16 w is fake-quantised with its range and scale rounded to
    bf16, as ``core.quant.fake_quant`` calls the kernel)."""
    bf16 = cfg.param_dtype == "bfloat16"
    return dict(dtype=torch.bfloat16 if bf16 else torch.float32,
                round_range=bf16)


def tq_check(torch, ops, ref, arch, D, F, qcfg, seed, dtype):
    """``transform_quant`` up (D, F) and down (F, D) on a random π and w in
    ``dtype``, each held to its plain version with ``torch.equal`` and
    timed beside its bound. Returns {mode: row}."""
    G = qcfg.group_size
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pi = make_pi(torch, "random", F, gen, "cuda")
    s = 1.0 + 0.05 * torch.randn(F, generator=gen, device="cuda")
    phi = 0.3 * torch.randn(F // 2, generator=gen, device="cuda")
    rows = {}
    for mode, shape in (("up", (D, F)), ("down", (F, D))):
        w = torch.randn(shape, generator=gen, device="cuda").to(dtype)

        def kern(w=w, mode=mode):
            return ops.transform_quant(w, pi, s, phi, bits=qcfg.bits,
                                       group=G, mode=mode)

        err = exact(torch, kern(), ref.transform_quant_ref(
            w, pi, s, phi, bits=qcfg.bits, group=G, mode=mode),
            f"transform_quant {arch} {dtype} {mode}")
        ms = time_ms(torch, kern)
        dev = device_ms(torch, kern, ("transform_quant",))
        plain = time_ms(torch, lambda w=w, mode=mode: ref.transform_quant_ref(
            w, pi, s, phi, bits=qcfg.bits, group=G, mode=mode), reps=5)
        K, N = shape
        nbytes = tq_bytes(K, N, G, F, w.element_size())
        bound, by = bound_ms(nbytes, TQ_OPS * K * N)
        rows[mode] = dict(shape=[K, N], ms=ms, device_ms=dev, plain_ms=plain,
                          bound_ms=bound, bound_by=by, bytes=nbytes,
                          share_of_bound=bound / dev, max_abs_err=err,
                          plan=list(importlib.import_module(
                              "repro_torch.kernels.transform_quant").plan(
                                  K, N, G, mode, w.element_size())))
        log("kernel_check", kernel="transform_quant", arch=arch, mode=mode,
            dtype=str(dtype), pi="random", equal=True, **rows[mode])
        del w
    torch.cuda.empty_cache()
    return rows


def attn_kernels_at(torch, ops, ref, cfg, routes, decode_lens, dtypes,
                    timed, seed=13):
    """The decode-attention routes of ``routes`` ("paged_decode_gqa",
    "paged_decode_gqa_mp" at MP 2, "flash_decode") at ``cfg``'s head
    layout (B 8), against their plain versions (PD_TOL / FD_TOL) with the
    caches in each of ``dtypes``, at the trace's decode lengths and at
    1024 tokens; each timed in the ``timed`` dtype (one call, and device
    time under the profiler) beside its bound and plain version. Returns
    {route: {"max_abs_err", context: row}}."""
    pd = importlib.import_module("repro_torch.kernels.paged_decode")
    fd = importlib.import_module("repro_torch.kernels.flash_decode")
    B, H, Hkv, Dh = 8, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    out = {}
    for route in routes:
        mp = 2 if route == "paged_decode_gqa_mp" else 1
        rows, err = {}, 0.0
        for ctx, lens in (("decode", decode_lens), ("1024", [1024] * B)):
            P = -(-max(lens) // PSZ)
            for dt in dtypes:
                before = ops.LAUNCHES[route]
                if route == "flash_decode":
                    args = flash_case(torch, B=B, S=max(lens), H=H, Hkv=Hkv,
                                      Dh=Dh, dtype=dt, seed=seed)
                    n = max(lens)
                    want = ref.flash_decode_ref(*args, kv_len=n)
                    got = ops.flash_decode(*args, kv_len=n)
                    torch.testing.assert_close(got, want, **FD_TOL)
                else:
                    args = paged_case(torch, B=B, H=H, Hkv=Hkv, Dh=Dh, P=P,
                                      lens=lens, dtype=dt, seed=seed)
                    want = ref.paged_decode_ref(*args)
                    got = ops.paged_decode(*args, **route_kw(route, mp))
                    torch.testing.assert_close(got, want, **PD_TOL)
                torch.cuda.synchronize()
                if ops.LAUNCHES[route] != before + 1:
                    raise AssertionError(f"{route} did not launch at "
                                         f"{H}/{Hkv} x {Dh}")
                e = float((got - want).abs().max())
                err = max(err, e)
                log("kernel_check", kernel=route, arch=cfg.name, context=ctx,
                    heads=[H, Hkv], head_dim=Dh, batch=B, dtype=str(dt),
                    lens=lens, max_abs_err=e)
                if dt != timed:
                    continue
                if route == "flash_decode":
                    q, k, v, _, _ = args
                    o = torch.empty((B, H, Dh), device=q.device)

                    def run():
                        fd.launch(q, k, v, None, None, o, kv_len=n)

                    def plain():
                        return ref.flash_decode_ref(q, k, v, kv_len=n)
                    nbytes = 2 * B * n * Hkv * Dh * k.element_size() \
                        + 2 * q.numel() * 4
                    ops_n = 4 * B * H * Dh * n
                else:
                    q, kp, vp, bt, ln, ks, _ = args
                    o = torch.empty((B, H, Dh), device=q.device)
                    m = torch.empty((B, H), device=q.device)
                    l_ = torch.empty_like(m)

                    def run():
                        pd.launch(route, q, kp, vp, bt, ln, None, None, o, m,
                                  l_, normalize=True, pages_per_block=mp)

                    def plain():
                        return ref.paged_decode_ref(q, kp, vp, bt, ln)
                    nbytes = paged_bytes(q, kp, ks, lens, H, Hkv)
                    ops_n = 4 * H * Dh * sum(lens)
                t, spread = time_stats(torch, run, reps=50)
                dev = device_ms(torch, run, PD_KERNEL_NAMES)
                b, by = bound_ms(nbytes, ops_n)
                rows[ctx] = dict(ms=t, ms_range=spread, device_ms=dev,
                                 plain_ms=time_ms(torch, plain, reps=20),
                                 bound_ms=b, bound_by=by,
                                 device_share_of_bound=b / dev, batch=B,
                                 heads=[H, Hkv], head_dim=Dh, lens=lens,
                                 dtype=str(dt))
                log("kernel_time", kernel=route, arch=cfg.name, context=ctx,
                    **rows[ctx])
        out[route] = dict(max_abs_err=err, **rows)
    torch.cuda.empty_cache()
    return out


def trace_decode_lens(cfg):
    """The trace's first batch's sequence lengths halfway through decoding
    (5b's "decode" context)."""
    from repro_torch.serving import build_trace
    return [len(t["prompt"]) + TRACE["max_new"] // 2
            for t in build_trace(cfg.vocab_size, **TRACE)[:8]]


def family_accepts(torch, ops, cfg, qcfg, kw=None, device="cuda"):
    """14c for any family: from the same bf16 initial weights (random-init,
    seed 0), RTN on every leaf the search does not take and STEPS steps
    with the fused flag in bf16, and the same on the weights widened to
    f32 in fp32, each from a fresh CPU-drawn proposal source of one seed
    (the Mamba adapter's within-head moves for a Mamba phase, one source
    per phase of a hybrid run); an encoder-decoder stack with the frames
    ``kw`` in each run's dtype. The decisions are compared step by step
    (after the first that differs, the two runs search from different
    points). Returns the number of decisions that differ. ``device="cpu"``
    runs it on the CPU (at a reduced size, to try its plumbing)."""
    import warnings

    from repro_torch.core import invariance as inv
    from repro_torch.core import rtn
    from repro_torch.core.quant import fake_quant
    from repro_torch.core.search import SearchConfig
    from repro_torch.data.calib import calibration_tensor
    from repro_torch.models.model import init_params
    from repro_torch.search import run

    t0 = time.perf_counter()
    cuda = device == "cuda"
    ssm = cfg.block_pattern in ("ssm", "hybrid")
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    calib = calibration_tensor(cfg.vocab_size, n_seqs=4,
                               seq_len=512 if cuda else 32, seed=99,
                               device=device)
    scfg = SearchConfig(steps=STEPS, fused_kernel=True, log_every=0)
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    runs = {}
    for label, c in (("bf16", cfg), ("fp32", cfg32)):
        if label == "fp32":
            p, params = _widen(torch, params), None
        else:
            p = params
        base = rtn.map_quantizable(p, lambda w, _: fake_quant(w, qcfg),
                                   only=lambda q: q[-1] not in
                                   FFN_KEYS + MAMBA_KEYS)
        src = ssm_proposals(inv, c, 5, device) if ssm else \
            CpuProposals(inv, 5, device)
        fkw = {k: v.to(getattr(torch, c.compute_dtype))
               for k, v in (kw or {}).items()} or None
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)  # the Mamba fallback
            res = run(p, base, c, qcfg, calib, scfg, proposals=src,
                      forward_kwargs=fkw)
        runs[label] = dict(history=res.history, final=res.final_loss,
                           initial=res.initial_loss,
                           launches=dict(ops.LAUNCHES),
                           peak=torch.cuda.max_memory_allocated()
                           if cuda else None,
                           step_ms=1e3 / res.stats["proposals_per_sec"])
        del p, base, res
        if cuda:
            torch.cuda.empty_cache()
    hb, hf = runs["bf16"]["history"], runs["fp32"]["history"]
    # positions in the merged history (a hybrid run's phases each count
    # their steps from 1)
    differ = [i for i, (b, f) in enumerate(zip(hb, hf))
              if b[0] and b[4] != f[4]]
    for label, r in runs.items():
        phases_monotone(r["history"], r["final"], f"{cfg.name} {label}")
    log("bf16_vs_fp32_accepts", arch=cfg.name, n_layers=cfg.n_layers,
        steps=STEPS, bf16_accepts=[h[4] for h in hb if h[0]],
        fp32_accepts=[h[4] for h in hf if h[0]], differing=len(differ),
        differ_at=differ, first_parting=differ[0] if differ else None,
        bf16_losses=[h[1] for h in hb], fp32_losses=[h[1] for h in hf],
        bf16_step_ms=runs["bf16"]["step_ms"],
        fp32_step_ms=runs["fp32"]["step_ms"],
        peak_bytes={k: r["peak"] for k, r in runs.items()},
        launches={k: r["launches"] for k, r in runs.items()},
        seconds=time.perf_counter() - t0)
    return len(differ)


# a router near tie: the k-th and (k+1)-th expert scores at most this many
# ulps apart (2x the largest margin met at a parting on Phi-3.5-MoE, 1 ulp)
ROUTER_TIE_ULPS = 2
# ... excuses a token whose plain logit is within this of the top, relative
# (2x the largest gap met at such a parting, 0.248; the oracle's logits of
# a token at random lie about one top logit below it)
ROUTER_TIE_GAP = 0.5


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(v) for v in tree)
    return tree.clone() if hasattr(tree, "clone") else tree


class StepCheck:
    """Inside ``with``: each decode step a server takes through a port
    kernel is computed again on the same inputs (its cache or pools cloned
    first) through the plain attention route, and every live row's token
    is held to the plain step's logits: the same argmax, or a near tie of
    them (the token within ``near_tie(cfg)`` of the top), or, within the
    wider ROUTER_TIE_GAP, a router near tie of the plain step (in some
    layer the k-th and (k+1)-th expert scores at most ROUTER_TIE_ULPS ulps
    apart: a rounding of the hidden state may swap the experts there, which
    an MoE model turns into another token). ``counts()`` gives the rule's
    reach: rows checked, rows at a router near tie, rows whose plain top-2
    gap is under the near tie, and the mean share of the vocabulary within
    ROUTER_TIE_GAP of the top at a router near tie. In bf16 the kernel
    and the plain version round differently, so the tokens of two whole
    runs part wherever one such step does (11b / 11c held whole runs to
    the plain route in fp32). ``watch_paged(server)``
    checks a PagedServer's steps (the paged decode's plain version);
    ``watch_batched(server, cfg_off)`` a BatchedServer's with
    ``use_flash_decode`` on (blocked attention, the flag off). ``parted``
    lists (step, row, the served token's gap in the plain logits, the
    plain step's smallest router margin in ulps)."""

    def __init__(self, torch, ref, cfg):
        self.torch, self.ref, self.cfg = torch, ref, cfg
        self.parted, self.steps, self.rows = [], 0, 0
        self.router_ties, self.top2_under, self.reach = 0, 0, []

    def counts(self):
        return dict(steps=self.steps, rows=self.rows,
                    router_tie_rows=self.router_ties,
                    top2_under_near_tie=self.top2_under,
                    vocab_share_within_router_gap=sum(self.reach)
                    / len(self.reach) if self.reach else None,
                    parted=self.parted)

    def _router_margins(self, L, run):
        """``run()`` with ``layers.moe_top_k`` recording each row's gap
        between its k-th and (k+1)-th score in ulps of the k-th; returns
        (run's result, the smallest gap per row or None)."""
        torch, real, gaps = self.torch, L.moe_top_k, []

        def top_k(logits, k):
            srt = torch.sort(logits.float(), dim=-1, descending=True).values
            kth = srt[..., k - 1]
            ulp = torch.exp2(torch.floor(torch.log2(kth.abs().clamp_min(
                1e-30)))) * torch.finfo(logits.dtype).eps
            gaps.append(((kth - srt[..., k]) / ulp).reshape(
                logits.shape[0], -1).amin(-1))
            return real(logits, k)
        L.moe_top_k = top_k
        try:
            out = run()
        finally:
            L.moe_top_k = real
        return out, (torch.stack(gaps).amin(0) if gaps else None)

    def _hold(self, logits, plain, margins, rows):
        """Hold each of ``rows`` of the step's (B, V) logits to ``plain``."""
        torch, V, bar = self.torch, self.cfg.vocab_size, near_tie(self.cfg)
        got = torch.argmax(logits[:, :V], dim=-1).tolist()
        want = torch.argmax(plain[:, :V], dim=-1).tolist()
        top2 = torch.topk(plain[:, :V], 2, dim=-1).values
        gap2 = ((top2[:, 0] - top2[:, 1]) / top2[:, 0].abs()).tolist()
        for i in rows:
            self.rows += 1
            margin = None if margins is None else float(margins[i])
            tie = margin is not None and margin <= ROUTER_TIE_ULPS
            self.top2_under += gap2[i] < bar
            if tie:
                self.router_ties += 1
                top = plain[i, :V].max()
                self.reach.append(float(((top - plain[i, :V]) / top.abs()
                                         < ROUTER_TIE_GAP).float().mean()))
            if got[i] == want[i]:
                continue
            top = float(plain[i, want[i]])
            gap = (top - float(plain[i, got[i]])) / abs(top)
            if gap >= bar and not (tie and gap < ROUTER_TIE_GAP):
                raise AssertionError(
                    f"{self.cfg.name}: decode step {self.steps} row {i}: the "
                    f"kernel route serves {got[i]}, the plain route {want[i]}"
                    f", gap {gap:.3g}, router margin {margin} ulps (not a "
                    f"near tie)")
            self.parted.append((self.steps, i, gap, margin))
        self.steps += 1

    def watch_paged(self, server):
        from repro_torch.models import layers as L
        from repro_torch.serving import decode as dec

        real, ref, batcher = dec.paged_decode_logits, self.ref, server.batcher

        def plain(q, k_pages, v_pages, block_tables, seq_lens, k_scale=None,
                  v_scale=None, **_):
            return ref.paged_decode_ref(q, k_pages, v_pages, block_tables,
                                        seq_lens, k_scale, v_scale)

        def logits_step(params_q, cfg, tokens, pools, bt, lens, **kw):
            saved = _clone(pools)
            logits, pools = real(params_q, cfg, tokens, pools, bt, lens, **kw)
            kernel = dec.paged_decode
            dec.paged_decode = plain
            try:
                (p_logits, _), margins = self._router_margins(
                    L, lambda: real(params_q, cfg, tokens, saved, bt, lens,
                                    **kw))
            finally:
                dec.paged_decode = kernel
            self._hold(logits[:, -1].float(), p_logits[:, -1].float(), margins,
                       [i for i, s in enumerate(batcher.slots)
                        if s is not None])
            return logits, pools

        self._undo = lambda: setattr(dec, "paged_decode_logits", real)
        dec.paged_decode_logits = logits_step
        return server

    def watch_batched(self, server, cfg_off):
        from repro_torch.models import layers as L
        from repro_torch.models.model import decode_step

        cfg_on = server.cfg

        def step(params_q, tokens, cache, index):
            saved = _clone(cache)
            logits, cache = decode_step(params_q, cfg_on, tokens, cache, index)
            (p_logits, _), margins = self._router_margins(
                L, lambda: decode_step(params_q, cfg_off, tokens, saved,
                                       index))
            self._hold(logits[:, -1].float(), p_logits[:, -1].float(), margins,
                       range(tokens.shape[0]))
            V = cfg_on.vocab_size
            return self.torch.argmax(logits[:, -1, :V], dim=-1)[:, None], cache

        server.step_fn = step
        self._undo = lambda: None
        return server

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        getattr(self, "_undo", lambda: None)()


def ulps_of_scale(torch, got, want):
    """max |got - want| in bf16 ulps of ``want``'s scale (2^(floor(log2
    max|want|) - 7))."""
    want = want.double()
    ulp = 2.0 ** (math.floor(math.log2(float(want.abs().max()))) - 7)
    return float((got.double() - want).abs().max()) / ulp


def bf16_close(torch, got, want, want32, what, ulps):
    """The bf16 bars on one tensor: within ``ulps`` ulps of ``want``'s
    scale elementwise, and no farther from ``want32`` (the same weights'
    fp32 run) than BF16_FARTHER x ``want`` is, by max abs and by RMS.
    Returns the distance in ulps."""
    d = ulps_of_scale(torch, got, want)
    if d > ulps:
        raise AssertionError(f"{what}: {d:.3g} ulps of the scale > {ulps}")
    got, want, want32 = (x.double() for x in (got, want, want32))
    for name, f in (("max", lambda x: float(x.abs().max())),
                    ("rms", lambda x: float(x.pow(2).mean().sqrt()))):
        if f(got - want32) > BF16_FARTHER * f(want - want32):
            raise AssertionError(f"{what}: {name} off fp32 {f(got - want32)}"
                                 f" > {BF16_FARTHER} x {f(want - want32)}")
    return d


# ---- the bf16 train step (13d, 14e, and the reduced configs' steps) -------

TRAIN_LR = 1e-4        # 13d / 14e: lr after one warm-up step
TRAIN14 = dict(batch=4, seq=512, steps=5, layers=12)     # 14e
SMALL_TRAIN = dict(steps=3, lr=1e-3, batch=2, seq=32)    # phase_small_bf16
TRAIN_SPREAD_X = 2     # the step's bar, in the CPU port's own spreads
STEP_ULP_SHARE = 1e-3  # params' RMS floor: one ulp of the scale on 0.1 %
CARD_BYTES = 80e9      # one H100's device memory


def train_reckoning(cfg, B, S):
    """The bf16 (or fp32) train step's bytes at its peak on one card, from
    ``cfg.param_count()`` (N, the reference's analytic count; the port's
    tree adds only the final norm and the q/k norms). The step is out of
    place (``optim/adamw.py``; ``run_resilient`` replays from its inputs),
    so a parameter holds 4 e + 16 bytes at once (e its dtype's size: 24 in
    bf16, 32 in fp32): the params, grads and clipped grads, the new params,
    and m and v old and new (f32). On top: four f32 temporaries of the
    largest leaf (the embedding or head, or a stacked FFN matrix), and the
    logits (the compute dtype, their f32 log-softmax and its gradient)."""
    e = 2 if cfg.param_dtype == "bfloat16" else 4
    c = 2 if cfg.compute_dtype == "bfloat16" else 4
    n = cfg.param_count()
    V, D = cfg.padded_vocab, cfg.d_model
    largest = max(V * D, cfg.n_layers * D * cfg.d_ff)
    out = dict(n_params=n, bytes_per_param=4 * e + 16,
               state_bytes=(4 * e + 16) * n, temp_bytes=4 * 4 * largest,
               logits_bytes=B * S * V * (c + 4 + 4))
    out["total_bytes"] = out["state_bytes"] + out["temp_bytes"] + \
        out["logits_bytes"]
    return out


def optimizer_bytes(params) -> int:
    """Bytes ``adamw_update`` must move: per element of a leaf of e bytes,
    the clip reads the gradient twice (its norm, then the scaling) and
    writes it once (3 e), the update reads p and the clipped g (2 e) and m,
    v (8) and writes p (e) and m, v (8): 6 e + 16 (28 in bf16)."""
    from repro_torch.optim.adamw import tree_leaves
    return sum(x.numel() * (6 * x.element_size() + 16)
               for x in tree_leaves(params))


def bf16_moved_share(torch, new, old) -> float:
    """The share of the bf16 params' elements a step changed."""
    from repro_torch.optim.adamw import tree_leaves
    pairs = [(a, b) for a, b in zip(tree_leaves(new), tree_leaves(old))
             if a.dtype == torch.bfloat16]
    return sum(int((a != b).sum()) for a, b in pairs) / \
        max(sum(a.numel() for a, _ in pairs), 1)


def run_train_steps(torch, cfg, B, S, steps, lr, kw, seed, device="cuda"):
    """``steps`` steps of ``make_train_step`` (AdamW at ``lr`` after one
    warm-up step) from ``init_params`` on ``device``, in ``cfg``'s dtypes,
    B x S calibration tokens a step (seeds ``seed`` + i) plus the frontend
    input ``kw``. Raises on a non-finite loss. Returns the row its callers
    log: losses, the share of bf16 elements each step moved, step ms (the
    median of the last 3, and all), 6·N·tokens TFLOP/s, peak bytes
    against ``train_reckoning``, and the optimizer alone on the last
    state's gradients (``queued_ms`` of ``adamw_update``) beside its bytes
    bound (``optimizer_bytes``). On the CPU (a test's plumbing run) the
    peak and the optimizer's time are None."""
    from repro_torch.data.calib import calibration_tensor
    from repro_torch.launch.steps import _loss_fn, _value_and_grad, \
        make_train_step
    from repro_torch.models.model import init_params
    from repro_torch.optim.adamw import (AdamWConfig, adamw_init,
                                         adamw_update, tree_leaves)

    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    if cuda:
        torch.cuda.empty_cache()
        sync()
        torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device=device).manual_seed(0),
                         device=device)
    state = adamw_init(params)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=1, total_steps=steps)
    step = make_train_step(cfg, opt_cfg)
    n_params = sum(x.numel() for x in tree_leaves(params))
    losses, times, moved = [], [], []
    for i in range(steps):
        batch = {"tokens": calibration_tensor(
            cfg.vocab_size, n_seqs=B, seq_len=S, seed=seed + i,
            device=device), **kw}
        sync()
        t0 = time.perf_counter()
        new, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
        moved.append(bf16_moved_share(torch, new, params))
        params = new
        del new
    peak = torch.cuda.max_memory_allocated() if cuda else None
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{cfg.name}: train losses {losses}")
    opt_ms = None
    if cuda:
        _, grads = _value_and_grad(_loss_fn(cfg), params, batch)
        opt_ms = queued_ms(torch, lambda: adamw_update(params, grads, state,
                                                       opt_cfg), calls=3)
        del grads
    opt_bytes = optimizer_bytes(params)
    opt_bound, opt_by = bound_ms(opt_bytes, 0)
    del params, state
    if cuda:
        torch.cuda.empty_cache()
    step_ms = statistics.median(times[-3:])
    tokens = B * S
    reck = train_reckoning(cfg, B, S)
    return dict(n_params=n_params, n_params_analytic=reck["n_params"],
                n_layers=cfg.n_layers, steps=steps, lr=lr, losses=losses,
                bf16_moved_share=moved, step_ms=step_ms, step_ms_all=times,
                tokens_per_s=tokens / step_ms * 1e3,
                tflops_6nt=6 * n_params * tokens / step_ms / 1e9,
                share_of_bf16_peak=6 * n_params * tokens / step_ms / 1e-3
                / BF16_OPS_PER_S, peak_bytes=peak, reckoning=reck,
                peak_over_reckoning=peak / reck["total_bytes"] if cuda
                else None,
                optimizer_queued_ms=opt_ms, optimizer_bytes=opt_bytes,
                optimizer_bound_ms=opt_bound, optimizer_bound_by=opt_by)


def small_train_step(torch, step, params, state, batch, d):
    """One step of ``step`` on device ``d`` from CPU (params, state,
    batch): (new params, new state, loss), on the CPU."""
    p, s, m = step(to_device(params, d), to_device(state, d),
                   {k: v.to(d) for k, v in batch.items()})
    return to_device(p, "cpu"), to_device(s, "cpu"), float(m["loss"])


def train_step_spread(torch, step, params, state, batch, want, d):
    """The port's own spread on device ``d`` of one step from (params,
    state, batch) against ``want`` (that step's outputs): the step again
    with SPREAD_FRAC of the token embedding moved one ulp (two draws,
    ``embed_moved``) and with the batch's rows reversed (the same loss
    summed in another order). Per leaf the largest |Δ| of m and of v and
    the largest RMS Δ of the new params, and the largest |Δ loss|."""
    from repro_torch.optim.adamw import tree_leaves

    runs = [(embed_moved(torch, params, seed), batch) for seed in (0, 1)]
    runs.append((params, {k: v.flip(0) for k, v in batch.items()}))
    n = len(tree_leaves(want[0]))
    out = dict(m=[0.0] * n, v=[0.0] * n, params_rms=[0.0] * n, loss=0.0)
    for p, b in runs:
        got = small_train_step(torch, step, p, state, b, d)
        for i, (a, w) in enumerate(zip(tree_leaves(got[0]),
                                       tree_leaves(want[0]))):
            diff = a.double() - w.double()
            out["params_rms"][i] = max(out["params_rms"][i],
                                       float(diff.pow(2).mean().sqrt()))
        for key in ("m", "v"):
            for i, (a, w) in enumerate(zip(tree_leaves(got[1][key]),
                                           tree_leaves(want[1][key]))):
                out[key][i] = max(out[key][i],
                                  float((a.double() - w.double()).abs().max()))
        out["loss"] = max(out["loss"], abs(got[2] - want[2]))
    return out


def _scale_ulp(x, mantissa) -> float:
    m = float(x.double().abs().max())
    return 2.0 ** (math.floor(math.log2(m)) - mantissa) if m > 0 else 0.0


def hold_train_step(torch, got, want, spread, what):
    """One step's outputs on the card (``got``: new params, new state,
    loss) against the CPU's (``want``), at TRAIN_SPREAD_X x the CPU's own
    spread (``train_step_spread``): the loss within that or 1e-4 relative;
    m and v elementwise, with a floor of one f32 ulp of the leaf's scale;
    each param leaf's RMS distance, with a floor of one ulp of its scale
    (its dtype) on STEP_ULP_SHARE of its elements. The card's bf16 GEMMs
    round apart from the CPU's, so no flat tolerance holds. Raises naming
    the first leaf over its bar; returns the worst share of a bar for the
    loss, m, v and the params."""
    from repro_torch.optim.adamw import tree_leaves

    worst = dict(loss=0.0, m=0.0, v=0.0, params=0.0)
    bar = max(TRAIN_SPREAD_X * spread["loss"], 1e-4 * abs(want[2]))
    worst["loss"] = abs(got[2] - want[2]) / bar
    if worst["loss"] > 1:
        raise AssertionError(f"{what}: loss {got[2]} vs {want[2]}, bar {bar}")
    for key in ("m", "v"):
        for i, (a, w) in enumerate(zip(tree_leaves(got[1][key]),
                                       tree_leaves(want[1][key]))):
            bar = TRAIN_SPREAD_X * max(spread[key][i], _scale_ulp(w, 23))
            err = float((a.double() - w.double()).abs().max())
            if err > bar:
                raise AssertionError(f"{what}: {key} leaf {i} "
                                     f"{tuple(a.shape)} off by {err} > {bar}")
            worst[key] = max(worst[key], err / bar if bar else 0.0)
    for i, (a, w) in enumerate(zip(tree_leaves(got[0]), tree_leaves(want[0]))):
        floor = _scale_ulp(w, 7 if w.dtype == torch.bfloat16 else 23) \
            * math.sqrt(STEP_ULP_SHARE)
        bar = TRAIN_SPREAD_X * max(spread["params_rms"][i], floor)
        err = float((a.double() - w.double()).pow(2).mean().sqrt())
        if err > bar:
            raise AssertionError(f"{what}: param leaf {i} {tuple(a.shape)} "
                                 f"RMS off by {err} > {bar}")
        worst["params"] = max(worst["params"], err / bar if bar else 0.0)
    return worst


def small_bf16_train(torch, cfg, params, calib, kw, devs, what):
    """SMALL_TRAIN["steps"] bf16 train steps (lr 1e-3 after one warm-up
    step) on ``devs``, teacher-forced: each step from the CPU's (params,
    state) after the one before, held with ``hold_train_step`` to the
    CPU's own spread measured in this call. Returns (the worst shares per
    step, the last step's outputs on the device under test)."""
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import AdamWConfig, adamw_init

    step = make_train_step(cfg, AdamWConfig(lr=SMALL_TRAIN["lr"],
                                            warmup_steps=1, total_steps=100))
    batch = {"tokens": calib, **kw}
    p, s = params, adamw_init(params)
    reads, got = [], None
    for k in range(SMALL_TRAIN["steps"]):
        want = small_train_step(torch, step, p, s, batch, torch.device(devs[0]))
        got = small_train_step(torch, step, p, s, batch, torch.device(devs[1]))
        spread = train_step_spread(torch, step, p, s, batch, want,
                                   torch.device(devs[0]))
        reads.append(hold_train_step(torch, got, want, spread,
                                     f"{what} step {k}"))
        p, s = want[0], want[1]
    return reads, got


def bf16_ckpt_roundtrip(torch, state, device, ckdir):
    """``state`` (params, opt_state) saved on ``device`` through
    ``CheckpointManager`` in format 1 and in format 2 under ``ckdir``
    (deleted afterwards) and restored onto ``device``: every leaf equal,
    dtype included. Returns the dtypes seen."""
    import shutil

    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.optim.adamw import tree_leaves

    state = to_device({"p": state[0], "o": state[1]}, device)
    seen = set()
    try:
        for sharded in (False, True):
            d = Path(ckdir) / ("format2" if sharded else "format1")
            mgr = CheckpointManager(d, sharded=sharded, device=device)
            mgr.save(3, (state["p"], state["o"]))
            mgr.wait()
            (p, o), manifest = mgr.restore()
            if manifest["step"] != 3:
                raise AssertionError(f"ckpt round trip: step {manifest}")
            for a, b in zip(tree_leaves({"p": p, "o": o}), tree_leaves(state)):
                if a.dtype != b.dtype or a.device != b.device or \
                        not torch.equal(a, b):
                    raise AssertionError(
                        f"ckpt round trip (format {1 + sharded}): a "
                        f"{b.dtype} leaf {tuple(b.shape)} came back apart")
                seen.add(str(b.dtype).split(".")[-1])
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    return sorted(seen)


def small_bf16_runs(torch, cfg, params, d, calib, kw_cal, toks, kw_dec, P):
    """The forward (logits and block outputs), prefill + 3 decode steps'
    logits of ``cfg`` on device ``d`` from ``params``, all on the CPU."""
    from repro_torch.models.model import decode_step, forward, prefill

    p = to_device(params, d)
    lg, hid = forward(p, cfg, calib.to(d), collect_hidden=True,
                      **{k: v.to(d) for k, v in kw_cal.items()})
    out = [lg.cpu(), hid.cpu()]
    lg, cache = prefill(p, cfg, toks[:, :9].to(d), 32,
                        **{k: v.to(d) for k, v in kw_dec.items()})
    out.append(lg.cpu())
    for t in range(9, 12):
        lg, cache = decode_step(p, cfg, toks[:, t:t + 1].to(d), cache, P + t)
        out.append(lg.cpu())
    return out


def phase_small_bf16(torch, ops, arch, devs=("cpu", "cuda"), ckpt_dir=None):
    """11d / 12d / 13e's bf16 case: ``arch``'s reduced config in its own
    bf16 on ``devs`` (the CPU yardstick, then the card) from the same bf16
    weights (drawn on the CPU), tokens, frontend input and proposals. The
    forward's logits and block outputs, and prefill + 3 decode steps'
    logits, within BF16_ULPS ulps of the tensor's scale of the CPU's (or of
    the CPU port's own spread where that is wider: its forward against the
    same with SPREAD_FRAC of the embedding table moved by one bf16 ulp, the
    hybrid's depth grows one-ulp partings), and no farther from the CPU's
    fp32 run of the weights widened than BF16_FARTHER x the CPU's bf16;
    RTN within one quantization step; RTN + SMALL_ZOO_STEPS steps with the
    fused flag, losses within BF16_LOSS_RTOL and the decisions equal
    wherever a step's |delta| exceeds it (``histories_agree``); 3 bf16
    train steps on 2 x 32 tokens, teacher-forced from the CPU's state,
    each held to the CPU port's own spread (``small_bf16_train``); with
    ``ckpt_dir``, the device's last train state saved there in formats 1
    and 2 and restored, equal bit for bit (``bf16_ckpt_roundtrip``)."""
    import warnings

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import invariance as inv
    from repro_torch.core import rtn
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.quant import QuantConfig, fake_quant
    from repro_torch.core.search import SearchConfig
    from repro_torch.data.calib import calibration_tensor
    from repro_torch.models.model import forward, init_params, quantizable_paths
    from repro_torch.search import run

    t0 = time.perf_counter()
    cfg = get_config(arch).reduced(param_dtype="bfloat16",
                                   compute_dtype="bfloat16")
    if cfg.moe is not None and arch != MOE_ARCH:
        cfg = small_moe_config(get_config, arch)
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16",
                                  compute_dtype="bfloat16")
    cfg32 = dataclasses.replace(cfg, param_dtype="float32",
                                compute_dtype="float32")
    qcfg = QuantConfig(bits=2, group_size=32)
    params = init_params(cfg, torch.Generator().manual_seed(7), device="cpu")
    calib = calibration_tensor(cfg.vocab_size, n_seqs=4, seq_len=64,
                               device="cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (3, 12)))
    front = cfg.is_enc_dec or cfg.frontend == "vision"
    kw_cal = frontend_kw(torch, cfg, 4, seed=8, device="cpu") if front else {}
    kw_dec = frontend_kw(torch, cfg, 3, seed=9, device="cpu") if front else {}
    P = cfg.frontend_len if cfg.frontend == "vision" else 0
    ref = small_bf16_runs(torch, cfg, params, torch.device(devs[0]), calib,
                          kw_cal, toks, kw_dec, P)
    ref32 = small_bf16_runs(torch, cfg32, _widen(torch, params),
                            torch.device(devs[0]), calib,
                            {k: v.float() for k, v in kw_cal.items()}, toks,
                            {k: v.float() for k, v in kw_dec.items()}, P)
    dev = small_bf16_runs(torch, cfg, params, torch.device(devs[1]), calib,
                          kw_cal, toks, kw_dec, P)
    # the CPU port's own spread over the forward's logits and block outputs
    spread = [0.0, 0.0]
    for seed in range(2):
        lg, hid = forward(embed_moved(torch, params, seed), cfg, calib,
                          collect_hidden=True, **kw_cal)
        spread = [max(spread[0], ulps_of_scale(torch, lg, ref[0])),
                  max(spread[1], max(ulps_of_scale(torch, hid[i], ref[1][i])
                                     for i in range(hid.shape[0])))]
    bars = [max(BF16_ULPS, s) for s in spread]
    read = [bf16_close(torch, dev[0], ref[0], ref32[0], f"{arch} logits",
                       bars[0])]
    read.append(max(bf16_close(torch, dev[1][i], ref[1][i], ref32[1][i],
                               f"{arch} block {i}", bars[1])
                    for i in range(dev[1].shape[0])))
    read.append(max(bf16_close(torch, a, b, c, f"{arch} prefill / decode",
                               bars[0])
                    for a, b, c in zip(dev[2:], ref[2:], ref32[2:])))
    # RTN, then the search from an RTN base, card against CPU
    rtn_q, hist = [], []
    for d in map(torch.device, devs):
        p = to_device(params, d)
        kc = {k: v.to(d) for k, v in kw_cal.items()} or None
        rtn_q.append(quantize_model(p, cfg, qcfg, "rtn", device=d).params_q)
        base = rtn.map_quantizable(p, lambda w, _: fake_quant(w, qcfg),
                                   only=lambda q: q[-1] not in
                                   FFN_KEYS + MAMBA_KEYS)
        src = ssm_proposals(inv, cfg, 3, d) \
            if cfg.block_pattern in ("ssm", "hybrid") else \
            CpuProposals(inv, 3, d)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)   # the Mamba fallback
            res = run(p, base, cfg, qcfg, calib.to(d), SearchConfig(
                steps=SMALL_ZOO_STEPS, fused_kernel=True, log_every=0),
                proposals=src, forward_kwargs=kc if cfg.is_enc_dec else None)
        hist.append(res.history)
        del p, base, res
    apart = 0.0
    for path in quantizable_paths(params):
        a, b = (rtn.get_by_path(q, path) for q in rtn_q)
        apart = max(apart, within_one_step(a.float(), b.float(), 2, 32))
    compared, parted = [], []
    for ha, hb in zip(history_phases(hist[1]), history_phases(hist[0])):
        c, p_ = histories_agree(ha, hb, f"{arch} bf16 search",
                                rtol=BF16_LOSS_RTOL)
        compared.append(c)
        parted.append(p_)
    # 3 bf16 train steps, card against the CPU's own spread
    B, S = SMALL_TRAIN["batch"], SMALL_TRAIN["seq"]
    kw_train = frontend_kw(torch, cfg, B, seed=10, device="cpu") \
        if front else {}
    train_read, last = small_bf16_train(
        torch, cfg, params, calibration_tensor(cfg.vocab_size, n_seqs=B,
                                               seq_len=S, seed=11,
                                               device="cpu"),
        kw_train, devs, f"{arch} bf16 train")
    ckpt_dtypes = bf16_ckpt_roundtrip(torch, last[:2], devs[1], ckpt_dir) \
        if ckpt_dir else None
    log("small_bf16", arch=arch, devices=list(devs), dtype=cfg.param_dtype,
        pattern=cfg.block_pattern, frontend=cfg.frontend,
        train_worst_share_of_bar=train_read, ckpt_roundtrip_dtypes=ckpt_dtypes,
        ulps_bar=bars, spread_ulps=spread, read_ulps=read,
        rtn_steps_apart_frac=apart, search_compared=compared,
        search_parted_at=parted, card_losses=[h[1] for h in hist[1]],
        ref_losses=[h[1] for h in hist[0]], seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# phase 14: Qwen3-4B in its own bf16 at full width and depth
# ---------------------------------------------------------------------------

BF16_ARCH = "qwen3-4b"
# 14d serves the first 6 of the 36 layers 14b packed (a cut since phase 15:
# at full depth the five serving runs, their oracles and the profiled run
# took 112 s of the script, 36.6 s at 12 layers; cut from 12 to 6 to pay
# for phase 16; 10b-c serve 12 layers in fp32)
BF16_SERVE_LAYERS = 6


def first_layers(params_q, n):
    """A packed model cut to its first ``n`` layers: every stacked leaf of
    ``blocks`` (a packed one by its components) sliced to ``[:n]`` (views),
    the rest kept."""
    from repro_torch.core.quant import QTensor

    def cut(x):
        if isinstance(x, dict):
            return {k: cut(v) for k, v in x.items()}
        if isinstance(x, QTensor):
            return QTensor(x.packed[:n], x.scale[:n], x.zero[:n], x.bits,
                           x.group_size, x.shape)
        return x[:n]

    return {k: cut(v) if k == "blocks" else v for k, v in params_q.items()}


def phase_bf16_kernels(torch, ops, ref, cfg, qcfg):
    """14a: ``transform_quant``'s bf16 branch at the model's FFN
    (``tq_check``), and ``group_quant`` (``round_range``) at every stacked
    shape RTN, AWQ and the search give it (``encdec_gq_shapes``: the
    attention and FFN stacks), timed at the largest (``gq_shapes_check``).
    Returns the two kernels' rows for the kernels line."""
    rows = {"transform_quant": tq_check(torch, ops, ref, cfg.name,
                                        cfg.d_model, cfg.d_ff, qcfg, 1414,
                                        torch.bfloat16)}
    shapes = encdec_gq_shapes(cfg)
    timed = max(shapes, key=lambda s: s[1][0] * s[1][1])[0]
    err, row = gq_shapes_check(torch, ops, ref, cfg, shapes, timed, 1415,
                               dtype=torch.bfloat16, round_range=True)
    rows["group_quant"] = dict(max_abs_err=err, **row)
    torch.cuda.empty_cache()
    return rows


def _widen(torch, tree):
    """A param tree with every floating leaf in f32 (fresh tensors)."""
    if isinstance(tree, dict):
        return {k: _widen(torch, v) for k, v in tree.items()}
    return tree.float() if tree.is_floating_point() else tree


def phase_train_bf16(torch, get_config):
    """14e: Qwen3-4B in its own bf16 at full width, TRAIN14["layers"] of
    its 36 layers (``train_reckoning``: the out-of-place step holds 24 B a
    parameter, 106 GB at full depth; 1.99 B parameters and ≈ 48 GB + the
    temporaries and logits at 12), ``run_train_steps`` at B 4 x 512 tokens,
    5 steps, lr 1e-4 after one warm-up step. Holds: losses finite and the
    last below the first, the peak within the card. Logs the share of bf16
    elements each step moved, step ms (median of the last 3), 6·N·tokens
    TFLOP/s, peak bytes against the reckoning, and the optimizer's time
    beside its bytes bound."""
    cfg = dataclasses.replace(get_config(BF16_ARCH),
                              n_layers=TRAIN14["layers"])
    if cfg.param_dtype != "bfloat16" or cfg.compute_dtype != "bfloat16":
        raise AssertionError(f"{cfg.name} is not a bf16 config")
    row = run_train_steps(torch, cfg, TRAIN14["batch"], TRAIN14["seq"],
                          TRAIN14["steps"], TRAIN_LR, {}, seed=300)
    if not row["losses"][-1] < row["losses"][0]:
        raise AssertionError(f"14e: losses {row['losses']} did not fall")
    log("train_bf16", arch=cfg.name, dtype=cfg.param_dtype,
        batch=TRAIN14["batch"], seq=TRAIN14["seq"],
        n_layers_full=get_config(BF16_ARCH).n_layers, **row)
    return row


def phase_bf16(torch, ops, ref, get_config, qcfg, pd_rows):
    """Phase 14 (14a-14e, then Qwen3-4B reduced in bf16 card against CPU
    with the bf16 checkpoint round trip). Returns what the kernels line
    carries: 14a's
    rows, 14b's launches by kernel and run, 14d's paged runs' launches by
    label and the flash run's."""
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = get_config(BF16_ARCH)
    if cfg.param_dtype != "bfloat16" or cfg.compute_dtype != "bfloat16":
        raise AssertionError(f"{cfg.name} is not a bf16 config")
    rows = phase_bf16_kernels(torch, ops, ref, cfg, qcfg)
    t1 = time.perf_counter()
    params_q, pack_s, launches = phase_zoo_main(torch, ops, cfg, qcfg,
                                                tag="bf16")
    t2 = time.perf_counter()
    differing = family_accepts(torch, ops, cfg, qcfg)
    t3 = time.perf_counter()
    paged, flash = phase_zoo_serving(
        torch, ops, dataclasses.replace(cfg, n_layers=BF16_SERVE_LAYERS),
        first_layers(params_q, BF16_SERVE_LAYERS), pack_s, pd_rows,
        tag="bf16_")
    del params_q
    torch.cuda.empty_cache()
    t4 = time.perf_counter()
    phase_train_bf16(torch, get_config)
    t5 = time.perf_counter()
    phase_small_bf16(torch, ops, BF16_ARCH,
                     ckpt_dir=ROOT / SMOKE_OUT / "ckpt_bf16")
    t6 = time.perf_counter()
    log("phase14", seconds=t6 - t0, a_s=t1 - t0, b_s=t2 - t1, c_s=t3 - t2,
        d_s=t4 - t3, e_s=t5 - t4, small_s=t6 - t5,
        accept_decisions_differing=differing)
    return dict(rows=rows, main=launches, paged=paged, flash=flash,
                differing=differing)


# ---------------------------------------------------------------------------
# phase 15: more than one process (torch.distributed)
# ---------------------------------------------------------------------------

DIST_STEPS = 8            # fused search steps of 15a / 15b
DIST_MIGRATE = 4          # 15b's migration cadence
DIST_OUT = "build/smoke/dist"    # the ranks' results (git-ignored)
DIST_TIMEOUT_S = 600      # a rank that runs longer is killed, and fails
# 15b's sharded paged decode: (layout, H, Hkv, Dh, (route, MP) pairs) at
# B 8 x DIST_PAGES pages (1024 tokens a sequence), half of every sequence
# in each rank's own pool; the lengths put a sequence wholly on rank 0
# (512, 300), leave one shard of a sequence empty (300, 1) and one empty
# sequence (0)
DIST_PD_CASES = (("mha", 32, 32, 64, (("paged_decode", 1),)),
                 ("gqa", 32, 8, 128, (("paged_decode_gqa", 1),
                                      ("paged_decode_gqa_mp", 2))))
DIST_PAGES = 64
DIST_LENS = [1024, 1000, 777, 512, 513, 300, 1, 0]
DIST_PSUM = (1 << 20, 8, 32)     # compressed_psum: values a rank, bits, group


def split_pool(torch, args, n, rank, psz=PSZ):
    """Rank ``rank``'s share of a paged cache split over ``n`` ranks: the
    pages [rank·P/n, (rank+1)·P/n) of every sequence's block table (B, P),
    copied into a pool of its own (its page 0 unused, as the serving
    pools keep theirs), with the rank's block table and local lengths.
    ``args`` is ``paged_case``'s list (q, pools, table, lengths, scales);
    returns the same list for the rank's pool."""
    q, kp, vp, bt, lens, ks, vs = args
    B, P = bt.shape
    per = P // n
    pages = bt[:, rank * per:(rank + 1) * per].reshape(-1).long()

    def pool(x):
        return None if x is None else torch.cat([x[:1], x[pages]])

    local_bt = (1 + torch.arange(B * per, device=bt.device,
                                 dtype=torch.int32)).reshape(B, per)
    local = (lens - rank * per * psz).clamp(0, per * psz).to(torch.int32)
    return [q, pool(kp), pool(vp), local_bt, local, pool(ks), pool(vs)]


def hold_merge(torch, got, want, what):
    """A sharded decode's merged output held to a whole-cache decode at the
    paged bar (PD_TOL); returns the max abs error."""
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: merged {tuple(got.shape)}, finite "
                             f"{bool(torch.isfinite(got).all())}")
    try:
        torch.testing.assert_close(got, want, **PD_TOL)
    except AssertionError as e:
        raise AssertionError(f"{what}: the merge is not the whole-cache "
                             f"decode: {e}") from None
    return float((got - want).abs().max())


def mapped_matches(seq, got, what):
    """A mapped run held to the sequential lane bit for bit: every island's
    history, the initial and final loss, the migrations and the elite's
    (π, s, φ)."""
    for i, (a, b) in enumerate(zip(seq["histories"], got["histories"])):
        if a != b:
            first = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                         min(len(a), len(b)))
            raise AssertionError(
                f"{what}: island {i} parts from the sequential lane at entry "
                f"{first}: {a[first:first + 1]} vs {b[first:first + 1]}")
    if len(seq["histories"]) != len(got["histories"]):
        raise AssertionError(f"{what}: {len(got['histories'])} islands, the "
                             f"sequential lane {len(seq['histories'])}")
    for key in ("initial_loss", "final_loss", "migrations"):
        if seq[key] != got[key]:
            raise AssertionError(f"{what}: {key} {got[key]} vs the "
                                 f"sequential lane's {seq[key]}")
    for key in ("pi", "s", "phi"):
        if seq[key] != got[key]:
            raise AssertionError(f"{what}: the elite's {key} differs")


def dist_search(torch, ops, cfg, qcfg, islands, mapped, dev):
    """RTN + DIST_STEPS fused steps on random-init opt-1.3b (phase 2's seed
    and calibration set) over ``islands`` islands, sequential or mapped
    (one island a rank); the launches, peak bytes and a step's ms ride
    along."""
    from repro_torch.core.pipeline import quantize_model
    from repro_torch.core.search import SearchConfig
    from repro_torch.data.calib import calibration_tensor
    from repro_torch.models.model import init_params

    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                         device=dev)
    calib = calibration_tensor(cfg.vocab_size, n_seqs=4, seq_len=512,
                               seed=99, device=dev)
    scfg = SearchConfig(steps=DIST_STEPS, fused_kernel=True, log_every=0,
                        islands=islands, migrate_every=DIST_MIGRATE,
                        mapped=mapped)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = quantize_model(params, cfg, qcfg, "rtn", calib, scfg, device=dev)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    sr = res.search
    out = {"histories": sr.island_histories, "initial_loss": sr.initial_loss,
           "final_loss": sr.final_loss, "migrations": sr.stats["migrations"],
           "mapped": sr.stats["mapped"], "accept_rate": sr.accept_rate,
           "step_ms": 1e3 * sr.stats["proposals"]
           / sr.stats["proposals_per_sec"] / DIST_STEPS,
           "peak_bytes": torch.cuda.max_memory_allocated(dev),
           "wall_s": wall, "launches": counts}
    for key in ("pi", "s", "phi"):
        out[key] = getattr(sr.transforms, key).cpu().numpy().tobytes()
    del res, sr, params, calib
    torch.cuda.empty_cache()
    return out


def dist_decode(torch, ops, ref, world, rank, dev):
    """The sequence-sharded paged decode at every DIST_PD_CASES route: this
    rank's share of the cache (all of it in a world of one) through the
    CUDA kernel with ``normalize=False`` and the cross-rank merge, held to
    the kernel on the whole cache and to the plain version. The launches
    are counted over the sharded calls alone."""
    from repro_torch.dist import attention
    rows, counts = [], dict.fromkeys(PD_ROUTES, 0)
    for name, H, Hkv, Dh, routes in DIST_PD_CASES:
        whole = paged_case(torch, B=len(DIST_LENS), H=H, Hkv=Hkv, Dh=Dh,
                           P=DIST_PAGES, lens=DIST_LENS,
                           dtype=torch.float32, seed=15)
        mine = split_pool(torch, whole, world, rank)
        plain = ref.paged_decode_ref(*whole)
        for route, mp in routes:
            kw = route_kw(route, mp)
            ops.reset_launch_counts()
            got = attention.sharded_paged_decode_attention(
                *mine[:5], None, mine[5], mine[6],
                fused_gqa=kw.get("fused_gqa", True),
                gqa_pages_per_block=kw.get("gqa_pages_per_block", 1))
            torch.cuda.synchronize(dev)
            counts[route] += ops.LAUNCHES[route]
            if ops.LAUNCHES[route] != 1:
                raise AssertionError(f"{route}: {ops.LAUNCHES[route]} "
                                     f"launches in one sharded call")
            kernel = ops.paged_decode(*whole, **kw)
            err = hold_merge(torch, got, kernel, f"{name} {route} vs kernel")
            err_plain = hold_merge(torch, got, plain,
                                   f"{name} {route} vs plain")
            ms = time_ms(torch, lambda: attention.sharded_paged_decode_attention(
                *mine[:5], None, mine[5], mine[6],
                fused_gqa=kw.get("fused_gqa", True),
                gqa_pages_per_block=kw.get("gqa_pages_per_block", 1)),
                warmup=2, reps=10)
            rows.append({"layout": name, "route": route, "pages_per_block": mp,
                         "heads": [H, Hkv], "head_dim": Dh,
                         "local_lens": mine[4].tolist(),
                         "max_abs_err_vs_kernel": err,
                         "max_abs_err_vs_plain": err_plain, "ms": ms})
    return rows, counts


def dist_collectives(torch, world, rank, dev):
    """argmin_allgather, elite_broadcast and compressed_psum on card
    tensors: the exact ones held exactly, compressed_psum to its bound
    (N·max(scale)/2 of the exact sum) and to the same function on the CPU
    copies of the same inputs (one quantization step)."""
    from repro_torch.dist import collectives
    n, bits, group = DIST_PSUM
    xs = [torch.randn(n, generator=torch.Generator(device=dev)
                      .manual_seed(1000 + r), device=dev)
          for r in range(world)]
    v, owner = collectives.argmin_allgather(xs[rank][:1].reshape(()))
    want = min(range(world), key=lambda r: float(xs[r][0]))
    if owner != want or float(v) != float(xs[want][0]):
        raise AssertionError(f"argmin_allgather: {owner} vs {want}")
    tree = {"x": xs[rank][:4096].clone(), "i": torch.full(
        (3,), rank, dtype=torch.int32, device=dev)}
    got = collectives.elite_broadcast(tree, world - 1)
    if not (torch.equal(got["x"], xs[world - 1][:4096])
            and int(got["i"][0]) == world - 1):
        raise AssertionError("elite_broadcast: not the owner's tree")
    t0 = time.perf_counter()
    card = collectives.compressed_psum(xs[rank], bits=bits, group_size=group)
    torch.cuda.synchronize(dev)
    card_s = time.perf_counter() - t0
    cpu = collectives.compressed_psum(xs[rank].cpu(), bits=bits,
                                      group_size=group)
    exact = torch.stack(xs).sum(0)
    step = max(float((x.reshape(-1, group).amax(1) - x.reshape(-1, group)
                      .amin(1)).max()) for x in xs) / ((1 << bits) - 1)
    err = float((card - exact).abs().max())
    if err > world * step / 2 + 1e-6:
        raise AssertionError(f"compressed_psum: {err} above its bound "
                             f"{world * step / 2}")
    diff = float((card.cpu() - cpu).abs().max())
    if diff > step * 1.001:
        raise AssertionError(f"compressed_psum: card vs CPU {diff} above one "
                             f"step {step}")
    return {"psum_values": n, "bits": bits, "group": group,
            "max_abs_err_vs_exact": err, "bound": world * step / 2,
            "card_vs_cpu_max_abs": diff,
            "card_equal_cpu": bool(torch.equal(card.cpu(), cpu)),
            "card_s": card_s}


def dist_rank_main(rank, world, backend, init, out_dir):
    """One rank of 15a / 15b, started with ``spawn``: brings the group up on
    the card (``cuda:0``: one card), runs ``repro_torch.launch.dist_smoke``'s
    checks, the collectives, the mapped search at opt-1.3b and the sharded
    paged decode, and writes its results to ``out_dir``."""
    import pickle
    import traceback
    out_file = Path(out_dir) / f"rank{rank}.pkl"
    try:
        sys.path.insert(0, str(ROOT / "src"))
        import torch
        import torch.distributed as dist
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
        dist.init_process_group(backend, init_method=init, world_size=world,
                                rank=rank)
        from repro_torch import obs
        from repro_torch.configs import get_config
        from repro_torch.core.quant import QuantConfig
        from repro_torch.dist import runtime
        from repro_torch.kernels import ops, ref
        from repro_torch.launch import dist_smoke
        out = {"backend": dist.get_backend(), "world": world,
               "nccl": ".".join(map(str, torch.cuda.nccl.version())),
               "device": str(runtime.local_device("cuda"))}
        runtime.barrier("phase15")
        dist_smoke.main(["--device", "cuda", "--steps", "3",
                         "--migrate-every", "2",
                         "--ckpt-dir", str(Path(out_dir) / "ckpt")])
        out["collectives"] = dist_collectives(torch, world, rank, dev)
        out["search"] = dist_search(torch, ops, get_config("opt-1.3b"),
                                    QuantConfig(bits=2, group_size=32),
                                    world, True, dev)
        out["decode"], out["decode_launches"] = dist_decode(
            torch, ops, ref, world, rank, dev)
        out["snapshot"] = obs.snapshot_json(obs.dist_snapshot())
        runtime.barrier("phase15-end")
        dist.destroy_process_group()
        out_file.write_bytes(pickle.dumps(("ok", out)))
    except BaseException:
        out_file.write_bytes(pickle.dumps(("error", traceback.format_exc())))
        raise


def run_dist_ranks(world, backend):
    """Start ``world`` ranks of ``dist_rank_main`` with ``spawn`` (this
    process holds a CUDA context), wait for them (killing every one left
    once a rank fails, or after DIST_TIMEOUT_S) and return their results,
    in rank order."""
    import multiprocessing as mp
    import pickle
    import shutil
    import socket

    out_dir = ROOT / DIST_OUT / f"{backend}{world}"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        init = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=dist_rank_main,
                         args=(r, world, backend, init, str(out_dir)))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DIST_TIMEOUT_S
    try:   # a rank that failed leaves its peer blocked in a collective
        while any(p.is_alive() for p in procs) and \
                time.monotonic() < deadline and \
                not any(p.exitcode not in (None, 0) for p in procs):
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    results = []
    for r, p in enumerate(procs):
        f = out_dir / f"rank{r}.pkl"
        if not f.exists():
            raise AssertionError(f"{backend} rank {r}/{world}: exit code "
                                 f"{p.exitcode}, no result")
        status, res = pickle.loads(f.read_bytes())
        if status != "ok":
            raise AssertionError(f"{backend} rank {r}/{world} failed:\n{res}")
        results.append(res)
    return results


def phase_dist(torch, ops, cfg, qcfg):
    """15: the parent's sequential runs (1 and 2 islands), then 15a, a real
    NCCL group of one, and 15b, two ranks on the one card over gloo (NCCL
    refuses two ranks on one device), each rank a process of its own.
    Returns the launches of the mapped searches and sharded decodes."""
    dev = torch.device("cuda", 0)
    seq = {}
    for islands in (1, 2):
        seq[islands] = dist_search(torch, ops, cfg, qcfg, islands, False, dev)
        s = seq[islands]
        log("dist_sequential", islands=islands, steps=DIST_STEPS,
            migrate_every=DIST_MIGRATE, step_ms=s["step_ms"],
            peak_bytes=s["peak_bytes"], wall_s=s["wall_s"],
            migrations=s["migrations"], final_loss=s["final_loss"],
            launches=s["launches"])
    torch.cuda.empty_cache()
    out = {}
    for tag, world, backend in (("15a", 1, "nccl"), ("15b", 2, "gloo")):
        t0 = time.perf_counter()
        ranks = run_dist_ranks(world, backend)
        for r, res in enumerate(ranks):
            mapped_matches(seq[world], res["search"], f"{tag} rank {r}")
        if len({res["snapshot"] for res in ranks}) != 1:
            raise AssertionError(f"{tag}: dist_snapshot differs by rank")
        for r, res in enumerate(ranks):
            s = res["search"]
            log("dist_mapped", phase=tag, rank=r, world=world,
                backend=res["backend"], nccl=res["nccl"],
                device=res["device"], islands=world, steps=DIST_STEPS,
                step_ms=s["step_ms"], sequential_step_ms=seq[world]["step_ms"],
                peak_bytes=s["peak_bytes"],
                sequential_peak_bytes=seq[world]["peak_bytes"],
                migrations=s["migrations"], final_loss=s["final_loss"],
                launches=s["launches"], equal_to_sequential=True)
            log("dist_decode", phase=tag, rank=r, rows=res["decode"],
                launches=res["decode_launches"])
            log("dist_collectives", phase=tag, rank=r, **res["collectives"])
        log("dist_phase", phase=tag, world=world, backend=backend,
            seconds=time.perf_counter() - t0,
            why=("a real NCCL group of one" if backend == "nccl" else
                 "backend gloo, passed explicitly: NCCL cannot put two "
                 "ranks on one device"),
            snapshot_bytes=len(ranks[0]["snapshot"]))
        out[tag] = ranks
    return {tag: {"search": [r["search"]["launches"] for r in ranks],
                  "decode": [r["decode_launches"] for r in ranks]}
            for tag, ranks in out.items()}


# ---------------------------------------------------------------------------
# phase 16: the tooling (achieved figures, remat and the dry run, the
# launch-budget checker) held against the card
# ---------------------------------------------------------------------------

MM_N = 8192                   # 16a: torch.matmul at N x N x N
MM_REPS = 20                  # 16a: median of this many
COPY_BYTES = 4 << 30          # 16a: one device-to-device copy of 4 GiB
REMAT_POLICIES = ("off", "full", "dots_all")
REMAT_TIMED = 3               # 16b: timed steps a policy
PEAK_BAND = (0.9, 1.1)        # 16b: fake trace's peak over the card's
# 16c: shapes the checker refuses (as its fixture does) beside the zoo's
LAUNCH_PROBES = (
    ("transform_quant", 100, 64, 32, "up", "float32"),
    ("transform_quant", 8192, 2048, 8192, "down", "float32"),
    ("transform_quant", 32, 4194304, 32, "up", "float32"),
    ("transform_quant", 9728, 2560, 32, "down", "bfloat16"),
)


def phase_achieved(torch):
    """16a: the card's achieved figures beside ``launch.roofline.HW``: a
    bf16 and an f32 (TF32 off) ``torch.matmul`` at MM_N³ (median of
    MM_REPS, CUDA events; 2·N³ operations), and HBM bandwidth from a
    COPY_BYTES device-to-device copy (its bytes read and written over the
    median of MM_REPS copies)."""
    from repro_torch.launch.roofline import HW

    gen = torch.Generator(device="cuda").manual_seed(16)
    row = {"hw": dict(HW), "n": MM_N, "tf32": torch.backends.cuda.matmul.allow_tf32}
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        a = torch.randn((MM_N, MM_N), generator=gen, device="cuda").to(dt)
        b = torch.randn((MM_N, MM_N), generator=gen, device="cuda").to(dt)
        ms, rng = time_stats(torch, lambda: torch.matmul(a, b), warmup=3,
                             reps=MM_REPS)
        row[f"{name}_matmul_ms"], row[f"{name}_matmul_ms_range"] = ms, rng
        row[f"{name}_tflops"] = 2 * MM_N ** 3 / (ms * 1e-3) / 1e12
        del a, b
    row["bf16_share_of_hw"] = row["bf16_tflops"] * 1e12 / HW["peak_flops"]
    src = torch.empty(COPY_BYTES, dtype=torch.uint8, device="cuda")
    src.fill_(1)
    dst = torch.empty_like(src)
    ms, rng = time_stats(torch, lambda: dst.copy_(src), warmup=3,
                         reps=MM_REPS)
    row.update(copy_bytes=COPY_BYTES, copy_ms=ms, copy_ms_range=rng,
               hbm_bytes_per_s=2 * COPY_BYTES / (ms * 1e-3))
    row["hbm_share_of_hw"] = row["hbm_bytes_per_s"] / HW["hbm_bw"]
    del src, dst
    torch.cuda.empty_cache()
    log("achieved", **row)
    return row


def remat_cfg(cfg, policy):
    """``cfg`` with remat off, or on under ``policy``."""
    if policy == "off":
        return cfg
    return dataclasses.replace(cfg, remat=True, remat_policy=policy)


def remat_args(torch, cfg, batch, seq, device, fake_mode=None):
    """(params, AdamW state, {"tokens"}) of ``cfg``: seeded on ``device``,
    or fake tensors of ``fake_mode`` (the dry run's builders) of the same
    shapes and dtypes."""
    from repro_torch.launch import steps
    from repro_torch.models.model import init_params
    from repro_torch.optim.adamw import adamw_init

    if fake_mode is not None:
        with fake_mode:
            params = steps.param_structs(cfg, fake_mode=fake_mode,
                                         device=device)
            return (params, adamw_init(params),
                    {"tokens": torch.zeros((batch, seq), dtype=torch.int64,
                                           device=device)})
    gen = torch.Generator(device=device).manual_seed(16)
    params = init_params(cfg, gen, device=device)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device=device)
    return params, adamw_init(params), {"tokens": tokens}


def measured_step(torch, step, args, device):
    """One ``step(*args)`` and its peak: on the card
    ``torch.cuda.max_memory_allocated`` over the call, less what was
    allocated before it that is not the step's arguments (the arguments'
    storages in 512-byte blocks); elsewhere the dry run's ``StepTrace``
    over the real run. Returns (out, step peak, raw peak or None)."""
    from repro_torch.launch import dryrun

    if torch.device(device).type != "cuda":
        res = dryrun.trace_step(step, args)
        return res["out"], res["peak_bytes"], None
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    arg_bytes = dryrun.StepTrace().track(args)
    torch.cuda.reset_peak_memory_stats()
    out = step(*args)
    torch.cuda.synchronize()
    raw = torch.cuda.max_memory_allocated()
    return out, raw - before + arg_bytes, raw


def hold_remat(torch, ref, run, what):
    """Losses and gradients of a remat step against remat off's: True when
    equal bit for bit; else held to 9d's bars (losses within 1e-5
    relative, the gradients and new params within ACCUM_TOL) and False.
    Raises past the bars."""
    from repro_torch.optim.adamw import tree_leaves

    pairs = [(run["loss"], ref["loss"]), (run["grad_norm"], ref["grad_norm"])]
    pairs += list(zip(tree_leaves(run["grads"]), tree_leaves(ref["grads"])))
    pairs += list(zip(tree_leaves(run["params"]), tree_leaves(ref["params"])))
    if all(torch.equal(a, b) for a, b in pairs):
        return True
    rel = abs(float(run["loss"]) - float(ref["loss"])) / abs(float(ref["loss"]))
    if not rel <= 1e-5:
        raise AssertionError(f"{what}: loss parts by {rel} relative")
    within(torch, [a for a, _ in pairs[2:]], [b for _, b in pairs[2:]],
           what=what, **ACCUM_TOL)
    return False


def peak_ratio(fake_peak, card_peak, what):
    """The fake trace's live peak over the card's, held to PEAK_BAND."""
    ratio = fake_peak / card_peak
    if not PEAK_BAND[0] <= ratio <= PEAK_BAND[1]:
        raise AssertionError(f"{what}: fake peak {fake_peak} is {ratio:.4f} "
                             f"x the card's {card_peak}, outside "
                             f"{PEAK_BAND}")
    return ratio


def remat_runs(torch, cfg, batch, seq, device="cuda",
               policies=REMAT_POLICIES, timed=REMAT_TIMED):
    """16b: the train step of ``cfg`` at ``batch`` x ``seq`` with each remat
    policy, from the same seeded state: its peak (``measured_step``) under
    ``FlopCounterMode``, whose FLOPs must equal the dry run's fake trace of
    the same step, and the fake trace's live peak within PEAK_BAND of the
    measured one; the loss and gradients (``_value_and_grad``, whose own
    peak — the forward and backward alone, where remat acts — is logged
    beside the step's) and the step's new params held to remat off's
    (``hold_remat``); step ms (median of ``timed``, on the card). Returns
    {policy: row}."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.launch import dryrun, steps
    from repro_torch.launch.steps import _loss_fn, _value_and_grad
    from repro_torch.optim.adamw import AdamWConfig

    opt_cfg = AdamWConfig(lr=3e-4, total_steps=10, warmup_steps=5)
    args = remat_args(torch, cfg, batch, seq, device)
    on_card = torch.device(device).type == "cuda"
    ref, rows = None, {}
    for policy in policies:
        t0 = time.perf_counter()
        c = remat_cfg(cfg, policy)
        step = steps.make_train_step(c, opt_cfg)
        with FlopCounterMode(display=False) as fc:
            out, peak, raw = measured_step(torch, step, args, device)
        flops = fc.get_total_flops()
        params, metrics = out[0], out[2]
        del out
        (loss, grads), grad_peak, _ = measured_step(
            torch, lambda p, b: _value_and_grad(_loss_fn(c), p, b),
            (args[0], args[2]), device)
        run = {"loss": loss, "grad_norm": metrics["grad_norm"],
               "grads": grads, "params": params}
        del params, grads
        bit_equal = True if ref is None else hold_remat(
            torch, ref, run, f"16b {policy}")
        if ref is None:
            ref = run
        del run
        ms = ms_range = None
        if on_card:
            ms, ms_range = time_stats(torch, lambda: step(*args), warmup=0,
                                      reps=timed)
        mode = steps.new_fake_mode()
        fake_args = remat_args(torch, c, batch, seq, device, fake_mode=mode)
        fake = dryrun.trace_step(step, fake_args, mode)
        del fake_args
        if fake["flops"] != flops:
            raise AssertionError(f"16b {policy}: the card's run counts "
                                 f"{flops} FLOPs, the fake trace "
                                 f"{fake['flops']}")
        ratio = peak_ratio(fake["peak_bytes"], peak, f"16b {policy}")
        rows[policy] = dict(
            loss=float(metrics["loss"]), bit_equal=bit_equal, flops=flops,
            fake_flops=fake["flops"], step_ms=ms, step_ms_range=ms_range,
            peak_bytes=peak, max_memory_allocated=raw,
            fake_peak_bytes=fake["peak_bytes"], fake_over_card=ratio,
            grad_peak_bytes=grad_peak, fake_trace_s=fake["seconds"],
            seconds=time.perf_counter() - t0)
        log("remat", arch=cfg.name, policy=policy, batch=batch, seq=seq,
            **rows[policy])
        del metrics, fake
        if on_card:
            torch.cuda.empty_cache()
    return rows


def launch_rows():
    """16c's rows: the launch-budget checker's zoo units (every zoo arch's
    up — gate is the same shape — and down, f32 and its own dtype) and
    LAUNCH_PROBES, each with the checker's verdict (``reason`` None where
    the kernel takes the shape)."""
    from repro_torch.analysis import launch_budget

    rows = []
    for r in launch_budget.zoo_units():
        if r["proj"] is None:
            continue
        rows.append({"arch": r["arch"], "proj": r["proj"], "K": r["K"],
                     "N": r["N"], "mode": r["mode"], "group": r["group"],
                     "dtype": r["dtype"], "reason": r["reason"] or None})
    for entry in LAUNCH_PROBES:
        _, K, N, group, mode, dtype = entry
        rows.append({"arch": "probe", "proj": mode, "K": K, "N": N,
                     "mode": mode, "group": group, "dtype": dtype,
                     "reason": launch_budget.probe(entry)})
    return rows


def phase_launch_budget(torch, ops, ref, rows, device="cuda"):
    """16c: each row the checker passes, ``ops.transform_quant`` at its full
    shape (2-bit, a seeded random π, s and φ) equal to its plain version
    (``torch.equal``); each row it flags, the wrapper raising
    ``ValueError``. Returns (checked, refused, launches)."""
    ops.reset_launch_counts()
    checked = refused = 0
    for i, r in enumerate(rows):
        K, N, mode = r["K"], r["N"], r["mode"]
        f = N if mode == "up" else K
        gen = torch.Generator(device=device).manual_seed(1600 + i)
        pi = torch.randperm(f, generator=gen, device=device)
        s = 1.0 + 0.05 * torch.randn(f, generator=gen, device=device)
        phi = 0.3 * torch.randn(f // 2, generator=gen, device=device)
        w = torch.randn((K, N), generator=gen, device=device).to(
            getattr(torch, r["dtype"]))
        kw = dict(bits=2, group=r["group"], mode=mode)
        if r["reason"] is not None:
            try:
                ops.transform_quant(w, pi, s, phi, **kw)
            except ValueError as e:
                refused += 1
                log("launch_budget", refused=True, error=str(e)[:120],
                    **{k: v for k, v in r.items() if k != "reason"})
                continue
            raise AssertionError(f"16c: the checker refuses {r} but the "
                                 f"wrapper launched it")
        exact(torch, ops.transform_quant(w, pi, s, phi, **kw),
              ref.transform_quant_ref(w, pi, s, phi, **kw),
              f"16c transform_quant {r['arch']} {mode} {r['dtype']}")
        checked += 1
        del w
    launches = ops.LAUNCHES["transform_quant"]
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
        if launches != checked:
            raise AssertionError(f"16c: {launches} launches for {checked} "
                                 f"checked rows")
    log("launch_budget_summary", checked=checked, refused=refused,
        launches=launches)
    return checked, refused, launches


def phase_tooling(torch, ops, ref, cfg):
    """16: 16a, 16b on ``cfg`` at phase 9a's TRAIN shape, 16c."""
    t0 = time.perf_counter()
    achieved = phase_achieved(torch)
    remat = remat_runs(torch, cfg, TRAIN["batch"], TRAIN["seq"])
    rows = launch_rows()
    budget = phase_launch_budget(torch, ops, ref, rows)
    log("phase16", seconds=time.perf_counter() - t0)
    return {"achieved": achieved, "remat": remat, "budget": budget,
            "rows": rows}


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
    # parity settings: accept decisions ride on loss deltas near 1e-5, and
    # bf16 GEMMs reduce in f32 as the reference's do
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

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
    marks, seconds = [time.perf_counter()], {}

    def lap(name):          # seconds since the last lap, for the last line
        marks.append(time.perf_counter())
        seconds[name] = marks[-1] - marks[-2]
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

    lap("build")

    # ---- phase 1: kernels vs plain versions ------------------------------
    cfg = get_config("opt-1.3b")
    rows = phase_kernels(torch, ops, ref, gq, tq, cfg)
    phase_small_reference(torch)

    lap("phase1")

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

    lap("phase2")

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

    lap("phase3")

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

    lap("phase4")

    # ---- phase 5: paged serving ------------------------------------------
    pd = importlib.import_module("repro_torch.kernels.paged_decode")
    pd_errs = phase_paged_kernels(torch, ops, ref, pd)
    pd_rows = phase_paged_times(torch, ops, ref, pd, trace_decode_lens(cfg))
    gqa_vs_sdpa(pd_rows)
    params_q, setup_s = packed_opt(torch, cfg)
    serve_counts, split = phase_serving(torch, ops, pd_rows, cfg, params_q,
                                        setup_s,
                                        profile_requests=ZOO_PROFILE_REQUESTS)
    serve_counts = serve_counts["on"]
    small_counts = phase_small_serving(torch, ops)

    lap("phase5")

    # ---- phase 6: contiguous-cache serving, quant_matmul -----------------
    fd = importlib.import_module("repro_torch.kernels.flash_decode")
    qm = importlib.import_module("repro_torch.kernels.quant_matmul")
    fd_err = phase_flash_kernels(torch, ops, ref, fd)
    fd_rows = phase_flash_times(torch, ref, fd,
                                flash_decode_len(cfg.vocab_size))
    fd_launches = phase_legacy_serving(torch, ops, cfg, params_q)
    del params_q
    torch.cuda.empty_cache()
    phase_small_legacy(torch, ops)
    qm_rows, qm_err, qm_launches = phase_quant_matmul(torch, ops, ref, qm)

    lap("phase6")

    # ---- phase 7: the calibrated base methods, the other objectives ------
    base_launches = phase_base_methods(
        torch, ops, dataclasses.replace(cfg, n_layers=BASE_LAYERS), qcfg)
    phase_small_base_methods(torch)

    lap("phase7")

    # ---- phase 8: the rest of the search engine, the search CLI ----------
    t0 = time.perf_counter()
    engine_launches = phase_search_engine(torch, ops, cfg, qcfg)
    phase_small_search_engine(torch)
    log("phase8", seconds=time.perf_counter() - t0)

    lap("phase8")

    # ---- phase 9: training and checkpoints, Table 1 trained by the port --
    from repro_torch import obs
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    phase_ckpt(torch, obs, *phase_train(torch, cfg))
    torch.cuda.empty_cache()
    table1_launches = phase_table1(torch, ops)
    phase_small_train(torch)
    log("phase9", seconds=time.perf_counter() - t0)

    lap("phase9")

    # ---- phase 10: the dense zoo; Qwen3-4B at full width and depth -------
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    zcfg = zoo_config(get_config, n_layers=ZOO_FP32_LAYERS)
    zoo_q, pack_s, zoo_launches = phase_zoo_main(torch, ops, zcfg, qcfg)
    t1 = time.perf_counter()
    zoo_paged, zoo_flash = phase_zoo_serving(torch, ops, zcfg, zoo_q, pack_s,
                                             pd_rows)
    del zoo_q
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    for arch in ZOO_ARCHS:
        phase_small_zoo(torch, ops, arch)
    t3 = time.perf_counter()
    log("phase10", seconds=t3 - t0, a_s=t1 - t0, bc_s=t2 - t1, d_s=t3 - t2)

    lap("phase10")

    # ---- phase 11: the MoE family; Phi-3.5-MoE at full width -------------
    moe = phase_moe(torch, ops, ref, get_config, qcfg)
    lap("phase11")

    # ---- phase 12: the SSM and hybrid families; Mamba2-2.7B --------------
    ssm = phase_ssm(torch, ops, ref, get_config, qcfg)
    lap("phase12")

    # ---- phase 13: the encoder-decoder and vision families ---------------
    encdec = phase_encdec(torch, ops, ref, get_config, qcfg, pd_rows)
    lap("phase13")

    # ---- phase 14: Qwen3-4B in its own bf16 at full width and depth ------
    bf16 = phase_bf16(torch, ops, ref, get_config, qcfg, pd_rows)
    lap("phase14")

    # ---- phase 15: more than one process (torch.distributed) -------------
    torch.cuda.empty_cache()
    dist15 = phase_dist(torch, ops, cfg, qcfg)
    lap("phase15")

    # ---- phase 16: the tooling held against the card -----------------------
    torch.cuda.empty_cache()
    tooling = phase_tooling(torch, ops, ref, cfg)
    lap("phase16")
    log("script_seconds", total=marks[-1] - marks[0], **seconds)

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
            "launches_on": "phase 2: quantize_model rtn, then rtn + 16 fused "
                           "steps (opt-1.3b)",
            "base_methods": {
                "launches": base_launches[name],
                "launches_on": "phase 7a: quantize_model gptq / awq / "
                               "omniquant on opt-1.3b (4 of its 24 "
                               "layers), alone and with 16 fused steps, "
                               "each counted from 0"},
            "search_engine": {
                "launches": engine_launches[name],
                "launches_on": "phase 8a-8d: repro_torch.search.run on "
                               "opt-1.3b (islands, shard_calib, both "
                               "install modes, tabu), each counted from 0"},
            "table1": {
                "launches": table1_launches[name],
                "launches_on": "phase 9c: repro_torch.bench.table1_main.run "
                               "on the port-trained bench model, 8 rows "
                               "(400 fused steps on each +IE row), each "
                               "counted from 0"},
            "zoo": {
                "launches": zoo_launches[name],
                "launches_on": "phase 10a: quantize_model rtn / awq, alone "
                               "and with 16 fused steps, on Qwen3-4B (fp32, "
                               "full width, 12 of 36 layers), each counted "
                               "from 0"},
            "bf16": {
                "launches": bf16["main"][name],
                "launches_on": "phase 14b: quantize_model rtn / awq, alone "
                               "and with 16 fused steps, on Qwen3-4B in its "
                               "own bf16 (full width and depth), each "
                               "counted from 0",
                "kernel": bf16["rows"][name]},
            "moe": {
                "launches": moe["main"][name],
                "launches_on": "phase 11a: quantize_model rtn, alone and "
                               "with 16 fused steps over the L·E expert "
                               "units, on Phi-3.5-MoE (its own bf16, full "
                               "width, 3 layers), each counted from 0",
                **({"max_abs_err": moe["gq_check"][0],
                    "expert_stack_time": moe["gq_check"][1]}
                   if name == "group_quant" else {"kernel": moe["tq"]})},
            "ssm": {
                "launches": {"mamba2-2.7b": ssm["mamba"][name],
                             "zamba2-7b": ssm["hybrid"][name]},
                "launches_on": "phase 12a / 12c: quantize_model rtn, alone "
                               "and with 16 steps (the fused flag asked "
                               "for: the Mamba phase runs unfused, the "
                               "hybrid's shared-FFN phase fused), on "
                               "Mamba2-2.7B (its own bf16, full width and "
                               "depth) and Zamba2-7B (bf16, full width, 13 "
                               "blocks), each counted from 0",
                **({"max_abs_err": ssm["gq_check"][0],
                    "mamba_stack_time": ssm["gq_check"][1]}
                   if name == "group_quant" else {"kernel": ssm["tq"]})},
            "encdec": {
                "launches": {"seamless-m4t-medium": encdec["seamless"][name],
                             "internvl2-1b": encdec["main"][name]},
                "launches_on": "phase 13a / 13c: quantize_model rtn alone "
                               "and with 16 fused steps on SeamlessM4T-medium "
                               "(its own bf16, full width and depth, 4 x "
                               "4096 stub frames through forward_kwargs), "
                               "rtn / awq alone and with 16 fused steps on "
                               "InternVL2-1B (bf16, full width and depth, "
                               "text), each counted from 0",
                **({"max_abs_err": encdec["gq_check"][0],
                    "largest_stack_time": encdec["gq_check"][1]}
                   if name == "group_quant" else
                   {"kernel": {"seamless-m4t-medium": encdec["tq"],
                               "internvl2-1b": encdec["vlm_tq"]}})},
            "dist": {
                "launches": {tag: [c[name] for c in d["search"]]
                             for tag, d in dist15.items()},
                "launches_on": "phase 15a / 15b: quantize_model rtn + 8 "
                               "fused steps on opt-1.3b (full width and "
                               "depth), mapped: one island a rank (15a a "
                               "NCCL group of one, 15b two ranks on the "
                               "card over gloo), each rank counted from 0"},
            **({"launch_budget": {
                "checks": tooling["budget"][2],
                "checked_rows": tooling["budget"][0],
                "refused_rows": tooling["budget"][1],
                "checks_on": "phase 16c: every row the launch-budget "
                             "checker passes (each zoo arch's up and down, "
                             "f32 and its own dtype, and the passing "
                             "probes), at full shape against the plain "
                             "version; checks, not the main path"}}
               if name == "transform_quant" else {}),
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
            **({"launches": serve_counts[route],
                "launches_on": "phase 5c: opt-1.3b serving, sharing on"}
               if route == "paged_decode" else
               {"launches": zoo_paged["on" if route == "paged_decode_gqa"
                                      else "on-mp2"][route],
                "launches_on": "phase 10b: PagedServer on 2-bit Qwen3-4B "
                               "(fp32, 12 layers), sharing on"
                               + (", 2 pages per block" if
                                  route.endswith("_mp") else ""),
                "bf16": {
                    "launches": bf16["paged"]["on" if route ==
                                              "paged_decode_gqa"
                                              else "on-mp2"][route],
                    "launches_on": "phase 14d: PagedServer on 2-bit "
                                   "Qwen3-4B, bf16 pools (6 of 36 "
                                   "layers), "
                                   "sharing on" + (", 2 pages per block" if
                                                   route.endswith("_mp")
                                                   else "")},
                "small_serving": {
                    "launches": small_counts[route],
                    "launches_on": "phase 5d: opt-tiny reduced serving"},
                "moe": {
                    "launches": moe["paged"]["on" if route ==
                                             "paged_decode_gqa"
                                             else "on-mp2"][route],
                    "launches_on": "phase 11b: PagedServer on 2-bit "
                                   "Phi-3.5-MoE (bf16 pools, 3 layers), "
                                   "sharing on" + (", 2 pages per block" if
                                                   route.endswith("_mp")
                                                   else ""),
                    "bf16": moe["attn"][route]},
                "encdec": {
                    "launches": encdec["paged"]["on" if route ==
                                                "paged_decode_gqa"
                                                else "on-mp2"][route],
                    "launches_on": "phase 13c: PagedServer on 2-bit "
                                   "InternVL2-1B (bf16 pools, 14/2 heads: "
                                   "rep 7), sharing on"
                                   + (", 2 pages per block" if
                                                   route.endswith("_mp")
                                                   else ""),
                    "rep7": encdec["rep7"][route]}}),
            "dist": {
                "launches": {tag: [c[route] for c in d["decode"]]
                             for tag, d in dist15.items()},
                "launches_on": "phase 15a / 15b: "
                               "dist.sharded_paged_decode_attention "
                               "(normalize=False partials, merged across "
                               "ranks) at B 8 x 1024, "
                               + ("32/32 x 64" if route == "paged_decode"
                                  else "32/8 x 128") + " (15a the whole "
                               "cache on one rank, 15b half of every "
                               "sequence a rank), each rank counted from 0"},
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
    main_row = fd_rows["decode"]
    kernels.append({
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_decode.cu",
        "sources": ["src/repro_torch/csrc/flash_decode.cu",
                    "src/repro_torch/csrc/split_decode.cuh"],
        "replaces": "src/repro/kernels/flash_decode.py:64",
        "launches": fd_launches,
        "launches_on": "opt-1.3b BatchedServer, use_flash_decode on",
        "zoo": {"launches": zoo_flash,
                "launches_on": "phase 10c: Qwen3-4B (fp32, 12 layers) "
                               "BatchedServer, use_flash_decode on"},
        "bf16": {"launches": bf16["flash"],
                 "launches_on": "phase 14d: Qwen3-4B (bf16 cache, 6 of "
                                "36 layers) BatchedServer, use_flash_decode "
                                "on"},
        "moe": {"launches": moe["flash"],
                "launches_on": "phase 11c: Phi-3.5-MoE (bf16 cache, 3 "
                               "layers) BatchedServer, use_flash_decode on",
                "bf16": moe["attn"]["flash_decode"]},
        "ssm": {"launches": ssm["flash"],
                "launches_on": "phase 12c: Zamba2-7B (bf16 cache, 13 "
                               "blocks: 2 applications of the shared block, "
                               "Dh 112) BatchedServer, use_flash_decode on",
                "fp32_launches": ssm["flash32"],
                "bf16": ssm["attn"]["flash_decode"]},
        "encdec": {"launches": {
            "seamless-m4t-medium steps": encdec["seamless_flash"],
            "internvl2-1b steps": encdec["flash"],
            "internvl2-1b BatchedServer": encdec["legacy_flash"]},
            "launches_on": "phase 13b / 13c: make_prefill_step + 15 "
                           "make_serve_step calls (B 8, bf16 caches, "
                           "use_flash_decode on) on SeamlessM4T-medium "
                           "(decoder self-attention, 16/16 heads) and on "
                           "InternVL2-1B after 256 patches (14/2 heads: rep "
                           "7); BatchedServer on InternVL2-1B, flag on",
            "rep7": encdec["rep7"]["flash_decode"],
            "bf16": encdec["attn"]["flash_decode"]},
        "max_abs_err": fd_err,
        **{k: main_row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                    "library_ms")},
        "library_note": "torch scaled_dot_product_attention over the same "
                        "contiguous cache (a transposed view) with a boolean "
                        "length mask",
        "shape": {k: main_row[k] for k in ("batch", "heads", "head_dim",
                                           "cache_rows", "kv_len")},
        **{k: main_row[k] for k in ("ms_range", "device_ms",
                                    "library_device_ms",
                                    "device_share_of_bound", "n_split")},
        "long_context": {k: fd_rows["long"][k] for k in FD_CTX_KEYS},
        "long_context_b1": {k: fd_rows["long-b1"][k] for k in FD_CTX_KEYS},
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
