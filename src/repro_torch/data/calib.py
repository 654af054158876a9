"""Calibration-set extraction (paper §4.1: 32 sequences × 512 tokens; here
deterministic sequences from the synthetic source). ``calibration_tokens``
is the reference's numpy function verbatim; ``calibration_tensor`` puts the
same tokens on a device."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.pipeline import DataConfig, make_pipeline
from repro_torch.device import resolve_device

__all__ = ["calibration_tokens", "calibration_tensor"]


def calibration_tokens(vocab_size: int, n_seqs: int = 32, seq_len: int = 512,
                       seed: int = 99, source=None) -> np.ndarray:
    cfg = DataConfig(seq_len=seq_len, global_batch=n_seqs, seed=seed,
                     vocab_size=vocab_size)
    batch_at = make_pipeline(cfg, source=source)
    return batch_at(0)


def calibration_tensor(vocab_size: int, n_seqs: int = 32, seq_len: int = 512,
                       seed: int = 99, source=None,
                       device="cuda") -> torch.Tensor:
    """``calibration_tokens`` as a (n_seqs, seq_len) int64 tensor on
    ``device``."""
    dev = resolve_device(device)
    toks = calibration_tokens(vocab_size, n_seqs, seq_len, seed, source)
    return torch.from_numpy(toks.astype(np.int64)).to(dev)
