"""Deterministic, stateless-indexable data pipeline (numpy; a copy of the
reference's ``repro.data.pipeline`` so the port imports nothing of it).

``batch_at(step)`` is a pure function of (seed, step, host_id), and the
synthetic source is the same Zipf-bigram process, so both packages draw the
same calibration tokens from the same seed.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SyntheticZipf", "DataConfig", "make_pipeline"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int = 256
    global_batch: int = 8
    seed: int = 1234
    vocab_size: int = 512
    n_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


class SyntheticZipf:
    """Deterministic Zipf-weighted bigram process.

    A fixed random bigram transition table (sparse, peaked) over the vocab
    gives the sequence real statistical structure: a trained LM reaches much
    lower CE than unigram entropy, and quantization visibly degrades it.
    """

    def __init__(self, vocab_size: int, seed: int = 7, branching: int = 8):
        self.vocab = vocab_size
        rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab_size + 1)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        # each token transitions to `branching` successors with Zipf weights
        self.next_tokens = rng.integers(0, vocab_size, size=(vocab_size, branching))
        w = 1.0 / np.arange(1, branching + 1)
        self.next_probs = w / w.sum()

    def sample(self, rng: np.random.Generator, length: int) -> np.ndarray:
        out = np.empty(length, np.int64)
        tok = rng.choice(self.vocab, p=self.unigram)
        for i in range(length):
            out[i] = tok
            if rng.random() < 0.1:  # occasional unigram reset
                tok = rng.choice(self.vocab, p=self.unigram)
            else:
                tok = self.next_tokens[tok, rng.choice(len(self.next_probs),
                                                       p=self.next_probs)]
        return out


def make_pipeline(cfg: DataConfig, source=None):
    """Returns batch_at(step) -> (host_batch, seq_len) int32."""
    source = source or SyntheticZipf(cfg.vocab_size)

    def batch_at(step: int) -> np.ndarray:
        rows = []
        for b in range(cfg.host_batch):
            # unique, reproducible stream per (step, global row)
            grow = cfg.host_id * cfg.host_batch + b
            rng = np.random.default_rng((cfg.seed, step, grow))
            rows.append(source.sample(rng, cfg.seq_len))
        return np.stack(rows).astype(np.int32)

    return batch_at
