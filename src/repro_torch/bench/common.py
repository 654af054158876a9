"""Shared benchmark scaffolding (the reference's ``benchmarks/common.py``):
one trained OPT-family model, cached on disk, calibration and held-out sets,
perplexity, CSV rows.

The model is trained by the port's own ``launch.train.train`` on the
deterministic synthetic Zipf corpus (no download): an OPT-architecture
model (ReLU, LayerNorm, learned positions), where the paper's invariances
are exact. It is cached through the port's checkpoint under
``build/bench_model/`` relative to the working directory (git-ignored).
"""
from __future__ import annotations

import math
import pathlib
import time

import torch

from repro_torch.ckpt.checkpoint import (latest_step, restore_checkpoint,
                                         save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.core.objective import calib_ce
from repro_torch.data.calib import calibration_tensor
from repro_torch.device import resolve_device
from repro_torch.models.model import forward

__all__ = ["BENCH_CFG", "CKPT", "ART", "bench_model", "calib_set",
           "heldout_set", "ppl", "emit", "timed"]

CKPT = pathlib.Path("build") / "bench_model"
ART = pathlib.Path("build") / "bench"

BENCH_CFG = get_config("opt-tiny").reduced(
    n_layers=4, d_model=96, d_ff=256, vocab_size=384, n_heads=4, n_kv_heads=4,
    max_seq_len=256)


def bench_model(steps: int = 400, *, device="cuda", ckpt_dir=CKPT):
    """Train (or load from ``ckpt_dir``) the shared benchmark model; returns
    (params on ``device``, cfg)."""
    from repro_torch.launch.train import train
    dev = resolve_device(device)
    cfg = BENCH_CFG
    if latest_step(ckpt_dir) is not None:
        params, _ = restore_checkpoint(ckpt_dir, device=dev)
        return params, cfg
    params, _, _ = train(steps=steps, batch=16, seq=128, lr=1.5e-3, cfg=cfg,
                         log_every=100, device=dev)
    save_checkpoint(ckpt_dir, steps, params)
    return params, cfg


def calib_set(cfg, n_seqs=32, seq_len=128, *, device="cuda"):
    """Paper §4.1: 32 sequences (512 tokens there; 128 here — the same
    ratio of calibration tokens to model capacity as the reference)."""
    return calibration_tensor(cfg.vocab_size, n_seqs=n_seqs, seq_len=seq_len,
                              device=device)


def heldout_set(cfg, n_seqs=16, seq_len=128, seed=4242, *, device="cuda"):
    """Row 0 of the pipeline at ``seed``: ``batch_at(0)`` of a
    ``DataConfig(seq_len, n_seqs, seed, vocab)``, as the reference's."""
    return calibration_tensor(cfg.vocab_size, n_seqs=n_seqs, seq_len=seq_len,
                              seed=seed, device=device)


def ppl(params, cfg, tokens) -> float:
    """Held-out perplexity (the paper's WikiText-2/C4 metric)."""
    return math.exp(float(calib_ce(forward(params, cfg, tokens), tokens,
                                   cfg.vocab_size)))


def emit(name: str, us_per_call: float, derived: str):
    """CSV row: name,us_per_call,derived."""
    print(f"{name},{us_per_call:.1f},{derived}")


def timed(fn, *args, device=None):
    """(fn(*args), microseconds of host wall clock); waits for the card
    first when ``device`` is a CUDA device."""
    t0 = time.perf_counter()
    out = fn(*args)
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e6
