"""Calibration-set extraction (paper §4.1: 32 sequences × 512 tokens; here
deterministic sequences from the synthetic source). ``calibration_tokens``
and ``shard_calibration`` are the reference's functions verbatim (the latter
slices numpy arrays and tensors alike); ``calibration_tensor`` puts the
same tokens on a device."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.data.pipeline import DataConfig, make_pipeline
from repro_torch.device import resolve_device

__all__ = ["calibration_tokens", "calibration_tensor", "shard_calibration"]


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


def shard_calibration(calib, n_islands: int):
    """Per-island calibration slices (``SearchConfig(shard_calib=True)``):
    contiguous equal batch slices, one per island, so each chain climbs on
    its own data and islands exchange only objective estimates at migration.
    The slices of a tensor are views.

    ``n_islands == 1`` returns ``[calib]`` unchanged — the sharded lane is
    then the replicated lane bit-for-bit. Requires the batch to divide
    evenly: a ragged split would hand islands different-sized loss
    estimates, silently biasing migration races.
    """
    n = int(n_islands)
    if n <= 1:
        return [calib]
    B = int(calib.shape[0])
    if B % n != 0:
        raise ValueError(
            f"shard_calib needs the calibration batch ({B} seqs) to divide "
            f"evenly over {n} islands; pad or trim the batch")
    per = B // n
    return [calib[i * per:(i + 1) * per] for i in range(n)]
