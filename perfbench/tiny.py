"""Tiny cells for the CPU tests: the benchmark's own configurations and
mixes cut to sizes a test holds, run on the CPU through the drivers."""
from __future__ import annotations

import dataclasses
import functools
import time

import torch

from perfbench import harness


def tiny_cell(name: str, n_layers: int = 2, n_match=None, **traffic):
    """Cell ``name`` of ``BENCHMARK.json`` with its model cut to
    ``n_layers`` layers, width 64, vocabulary 512 (its family and types
    kept), and its mix cut to short sequences matching the first
    ``n_match`` block outputs; ``traffic`` overrides mix keys.

    A bfloat16 model keeps width 256 and 16 x 128 calibration tokens: its
    rounding, relative to the scores, is then about what it is at the
    cell's own size, where the limits were read; at width 64 over 32
    tokens it is several times larger."""
    cell = harness.load_cell(name)
    a = cell.arch
    gqa = a.n_kv_heads < a.n_heads
    wide = a.param_dtype == "bfloat16"
    D = 256 if wide else 64
    arch = dataclasses.replace(
        a, n_layers=n_layers, d_model=D, n_heads=4,
        n_kv_heads=2 if gqa else 4, d_ff=2 * D, vocab_size=512,
        head_dim=D // 4 if a.head_dim else 0, max_seq_len=256,
        vocab_pad_multiple=16)
    mix = dict(cell.traffic)
    mix.update(calib_seqs=16 if wide else 2, seq_len=128 if wide else 16,
               steps=6, warm_steps=1,
               n_match_layers=n_match if n_match is not None else n_layers)
    mix.update(traffic)
    return dataclasses.replace(cell, arch=arch, traffic=mix)


def run_cpu(cell, seed: int = 7, seconds: float = 1.0, trace: bool = False,
            control=None):
    """One run of ``cell`` on the CPU, past the harness's look for a card:
    the driver's record, the result line's object and the run's context
    (with ``control``, a lower precision, the control's numbers in
    ``ctx.control``)."""
    from perfbench import run as runner

    ctx = runner.make_context(cell, seed, seconds, trace,
                              torch.device("cpu"), time.monotonic())
    if control is not None:
        ctx.check = functools.partial(
            harness.driver(cell.traffic["driver"]).check, ctx,
            control=control)
    rec = harness.driver(cell.traffic["driver"]).run(ctx)
    info = {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": int(rec.memory_peak)}
    return rec, runner.result(cell, rec, trace, info), ctx
