"""End-to-end training driver (the reference's ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch opt-tiny \\
        --steps 200 --batch 8 --seq 256 --ckpt-dir /tmp/ckpt   # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu ...

Integrates: the deterministic step-indexed pipeline, the train step (forward,
autograd, AdamW), async checkpointing, the straggler watchdog and the
resilient restart. With ``--ckpt-dir`` a run resumes from the newest
checkpoint there (``resumed from step N``) and saves every ``--save-every``
steps; the checkpoints are the reference's format, so either package resumes
the other's run.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import CheckpointManager, latest_step
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, make_pipeline
from repro_torch.device import check_on_device, resolve_device
from repro_torch.dist.fault import StepWatchdog, run_resilient
from repro_torch.launch.steps import make_train_step
from repro_torch.models.config import check_supported
from repro_torch.models.model import init_params
from repro_torch.optim.adamw import AdamWConfig, adamw_init

__all__ = ["train", "main"]


def train(arch: str = "opt-tiny", steps: int = 100, batch: int = 8, seq: int = 256,
          lr: float = 3e-4, ckpt_dir: str = None, save_every: int = 50,
          reduced: bool = True, log_every: int = 10, seed: int = 0,
          params=None, cfg=None, device="cuda"):
    """Train for ``steps`` steps; returns (params, per-step losses, cfg).

    Initial params are ``params`` (already on ``device``) or
    ``init_params`` from a ``torch.Generator`` on ``device`` seeded with
    ``seed`` (the draws differ between the CPU and the card). The params,
    and so the step, keep ``cfg``'s dtypes (a bf16 config trains bf16
    params with f32 m and v). A resume reads a format-1 or a format-2
    checkpoint; saves are format 1."""
    dev = resolve_device(device)
    cfg = cfg or (get_config(arch).reduced() if reduced else get_config(arch))
    check_supported(cfg)
    if seq > cfg.max_seq_len:
        cfg = dataclasses.replace(cfg, max_seq_len=seq)
    opt_cfg = AdamWConfig(lr=lr, total_steps=steps, warmup_steps=max(steps // 20, 5))
    step_fn = make_train_step(cfg, opt_cfg)

    if params is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                             device=dev)
    check_on_device(params, dev)
    opt_state = adamw_init(params)

    data_cfg = DataConfig(seq_len=seq, global_batch=batch, vocab_size=cfg.vocab_size)
    batch_at = make_pipeline(data_cfg)

    ckpt = CheckpointManager(ckpt_dir, device=dev) if ckpt_dir else None
    start = 0
    if ckpt and latest_step(ckpt.dir) is not None:
        (params, opt_state), manifest = ckpt.restore()
        start = manifest["step"]
        print(f"[train] resumed from step {start}")

    watchdog = StepWatchdog()
    losses = []

    def one_step(state, step):
        p, o = state
        tokens = torch.from_numpy(batch_at(step).astype(np.int64)).to(dev)
        p, o, metrics = step_fn(p, o, {"tokens": tokens})
        losses.append(float(metrics["loss"]))
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step={step} loss={losses[-1]:.4f} "
                  f"lr={float(metrics['lr']):.2e} gnorm={float(metrics['grad_norm']):.2f}",
                  flush=True)
        return (p, o)

    t0 = time.monotonic()
    if ckpt:
        state, events = run_resilient(one_step, (params, opt_state), n_steps=steps,
                                      ckpt=ckpt, save_every=save_every,
                                      start_step=start, watchdog=watchdog)
        params, opt_state = state
    else:
        state = (params, opt_state)
        for s in range(start, steps):
            state = one_step(state, s)
        params, opt_state = state
    dt = time.monotonic() - t0
    print(f"[train] {steps - start} steps in {dt:.1f}s "
          f"({(steps - start) / max(dt, 1e-9):.2f} it/s); straggler flags: {watchdog.flagged}")
    return params, losses, cfg


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="opt-tiny")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--full", action="store_true", help="full-size config (not reduced)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    train(args.arch, args.steps, args.batch, args.seq, args.lr, args.ckpt_dir,
          args.save_every, reduced=not args.full, device=args.device)


if __name__ == "__main__":
    main()
