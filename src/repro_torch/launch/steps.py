"""Serving step builders over the contiguous KV cache (the reference's
``repro.launch.steps``: ``make_serve_step`` and ``make_prefill_step``).

The steps are plain functions (PyTorch runs eagerly; the reference jits
them). The train step and the dry-run ``*_structs`` builders are not
ported yet.
"""
from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig

__all__ = ["make_serve_step", "make_prefill_step"]


def make_serve_step(cfg: ModelConfig):
    """(params_q, tokens (B, 1), cache, index) -> (next_token (B, 1), cache):
    one greedy decode step at host position ``index``, padded-vocab
    columns masked before the argmax; the cache is written in place."""

    def serve_step(params_q, tokens, cache, index):
        logits, cache = M.decode_step(params_q, cfg, tokens, cache, index)
        V = logits.shape[-1]
        if V > cfg.vocab_size:
            keep = torch.arange(V, device=logits.device) < cfg.vocab_size
            logits = torch.where(keep, logits, -torch.inf)
        return torch.argmax(logits[:, -1], dim=-1)[:, None], cache

    return serve_step


def make_prefill_step(cfg: ModelConfig, max_len: int):
    """(params_q, batch {"tokens": (B, S)}) -> (last-token logits (B, 1, V),
    cache of depth ``max_len``)."""

    def prefill_step(params_q, batch):
        logits, cache = M.prefill(params_q, cfg, batch["tokens"], max_len)
        return logits[:, -1:], cache

    return prefill_step
