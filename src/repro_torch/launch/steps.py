"""Step builders (the reference's ``repro.launch.steps``): the train step
(forward, autograd, AdamW), the serving steps over the contiguous KV
cache, and aliases of the paged serving steps in ``repro_torch.serving``.

The steps are plain functions (PyTorch runs eagerly; the reference jits
them). The dry-run ``*_structs`` builders and the remat policies, which
only the reference's dry-run reads, wait for ROADMAP Queue 1 item 15.
"""
from __future__ import annotations

import torch

from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                     cosine_schedule, tree_leaves, tree_map)

__all__ = ["make_train_step", "make_serve_step", "make_paged_serve_step",
           "make_paged_prefill_chunk_step", "make_page_copy_step",
           "make_prefill_step"]


def _value_and_grad(loss_of, params, mb):
    """(loss, grads) of ``loss_of(params, mb)`` by autograd on detached
    leaf copies of the param tensors (the inputs keep no grad state)."""
    tree = tree_map(lambda x: x.detach().requires_grad_(True), params)
    leaves = tree_leaves(tree)
    with torch.enable_grad():
        loss = loss_of(tree, mb)
        grads = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    return loss.detach(), tree_map(lambda x: grads[id(x)], tree)


def _loss_fn(cfg: ModelConfig):
    """(params, batch) -> the train step's f32 loss: the mean next-token CE
    of ``M.forward`` over ``batch["tokens"]`` (a vision stack's patch
    logits dropped), as the reference's step computes it."""
    prefix = cfg.frontend_len if cfg.frontend == "vision" else 0

    def loss_of(p, mb):
        # each layer reads its slice of the stacked (L, ...) block leaves:
        # by ``unbind``, whose backward stacks the L slice gradients once,
        # not by indexing, whose backward writes each slice into a fresh
        # zero-filled (L, ...) gradient and adds the L of them
        p = dict(p, **{k: tree_map(lambda x: x.unbind(0), p[k])
                       for k in ("blocks", "enc_blocks") if k in p})
        kw = {}
        if cfg.frontend == "vision":
            kw["vision_embeds"] = mb["vision_embeds"]
        if cfg.is_enc_dec:
            kw["enc_embeds"] = mb["enc_embeds"]
        tokens = mb["tokens"]
        logits = M.forward(p, cfg, tokens, **kw)
        if prefix:
            logits = logits[:, prefix:]
        return M.lm_loss(logits[:, :-1], tokens[:, 1:], cfg.vocab_size)

    return loss_of


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig = AdamWConfig(),
                    accum_steps: int = 1):
    """(params, opt_state, batch) -> (params, opt_state, metrics {"loss",
    "lr", "grad_norm"}); the inputs are not modified.

    ``batch``: {"tokens": (B, S) int}, plus ``"vision_embeds"`` (B, P, D)
    for a vision stack (``cfg.frontend == "vision"``: the loss drops the
    first ``cfg.frontend_len`` logits, the patches') and ``"enc_embeds"``
    (B, T, D) for an encoder-decoder stack, as the reference's step reads
    them (a batch without them raises ``KeyError``).

    ``accum_steps > 1`` splits every batch entry into equal microbatches
    (rows ``i·B/n .. (i+1)·B/n``), sums their f32 losses and gradients in
    order and divides by ``accum_steps``: activation memory scales down at
    the cost of ``accum_steps`` weight passes. A batch that ``accum_steps``
    does not divide raises ``ValueError`` (the reference's reshape raises
    too).
    """
    schedule = cosine_schedule(opt_cfg)
    loss_of = _loss_fn(cfg)

    def train_step(params, opt_state, batch):
        batch = dict(batch, tokens=batch["tokens"].long())
        tokens = batch["tokens"]
        if accum_steps == 1:
            loss, grads = _value_and_grad(loss_of, params, batch)
        else:
            B = tokens.shape[0]
            if B % accum_steps:
                raise ValueError(
                    f"batch of {B} rows does not split into accum_steps="
                    f"{accum_steps} equal microbatches")
            mb = B // accum_steps
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            for i in range(accum_steps):
                lo, g = _value_and_grad(
                    loss_of, params,
                    {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()})
                loss = loss + lo
                grads = tree_map(torch.add, grads, g)
                del g
            n = torch.tensor(float(accum_steps), device=tokens.device)
            loss = loss / n
            grads = tree_map(lambda g: g / n, grads)
        params2, opt2, metrics = adamw_update(params, grads, opt_state,
                                              opt_cfg, schedule)
        metrics["loss"] = loss
        return params2, opt2, metrics

    return train_step


def make_serve_step(cfg: ModelConfig):
    """(params_q, tokens (B, 1), cache, index) -> (next_token (B, 1), cache):
    one greedy decode step at host position ``index``, padded-vocab
    columns masked before the argmax; the cache is written in place (an
    encoder-decoder cache's cross-attention K/V are read, not written)."""

    def serve_step(params_q, tokens, cache, index):
        logits, cache = M.decode_step(params_q, cfg, tokens, cache, index)
        V = logits.shape[-1]
        if V > cfg.vocab_size:
            keep = torch.arange(V, device=logits.device) < cfg.vocab_size
            logits = torch.where(keep, logits, -torch.inf)
        return torch.argmax(logits[:, -1], dim=-1)[:, None], cache

    return serve_step


def make_paged_serve_step(cfg: ModelConfig):
    """(params_q, tokens (B, 1), pools, block_tables (B, P), seq_lens (B,))
    -> (next_token (B, 1), pools): the continuous-batching decode step
    (``serving.decode.make_paged_decode_step``), greedy."""
    from repro_torch.serving.decode import make_paged_decode_step
    return make_paged_decode_step(cfg)


def make_paged_prefill_chunk_step(cfg: ModelConfig):
    """(params_q, tokens (1, C), pools, block_tables (1, P), offset) ->
    (logits (1, C, V), pools): one chunk of paged prefill
    (``serving.prefill.make_paged_prefill_step``)."""
    from repro_torch.serving.prefill import make_paged_prefill_step
    return make_paged_prefill_step(cfg)


def make_page_copy_step(cfg: ModelConfig):
    """(pools, src, dst) -> pools with page ``dst`` <- page ``src`` on every
    leaf, in place: the batcher's copy-on-write fork
    (``serving.paged_cache.copy_page``)."""
    from repro_torch.serving.paged_cache import copy_page
    return copy_page


def make_prefill_step(cfg: ModelConfig, max_len: int):
    """(params_q, batch) -> (last-token logits (B, 1, V), cache of depth
    ``max_len``). ``batch``: {"tokens": (B, S)}, plus ``"vision_embeds"``
    (B, P, D) for a vision stack and ``"enc_embeds"`` (B, T, D) for an
    encoder-decoder stack (whose cache then holds the cross-attention K/V,
    read by ``make_serve_step``), as the reference's step reads them."""

    def prefill_step(params_q, batch):
        kw = {}
        if cfg.frontend == "vision":
            kw["vision_embeds"] = batch["vision_embeds"]
        if cfg.is_enc_dec:
            kw["enc_embeds"] = batch["enc_embeds"]
        logits, cache = M.prefill(params_q, cfg, batch["tokens"], max_len,
                                  **kw)
        return logits[:, -1:], cache

    return prefill_step
