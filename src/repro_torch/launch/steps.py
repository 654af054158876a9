"""Step builders (the reference's ``repro.launch.steps``): the train step
(forward, autograd, AdamW), the serving steps over the contiguous KV
cache, and aliases of the paged serving steps in ``repro_torch.serving``;
then the dry run's cells and inputs.

The steps are plain functions (PyTorch runs eagerly; the reference jits
them). ``SHAPES`` names the dry run's four step shapes (the reference's):

    train_4k     seq 4096   batch 256   -> train step (fwd + bwd + AdamW)
    prefill_32k  seq 32768  batch 32    -> prefill (packed weights)
    decode_32k   seq 32768  batch 128   -> serve step (1 new token, KV cache)
    long_500k    seq 524288 batch 1     -> serve step (SSM / hybrid only)

The ``*_structs`` builders and ``input_specs`` return trees of FAKE tensors
(``torch._subclasses.fake_tensor``), the counterpart of the reference's
``jax.eval_shape``: they run the port's own ``init_params``,
``adamw_init``, ``pack_model``, ``init_cache`` and ``PagedKVCache`` in a
``FakeTensorMode`` (the caller's ``fake_mode``, else one of their own), so
the specs cannot drift from what the port allocates, and nothing is
allocated. ``device`` defaults to :func:`fake_device`: the card's route,
``"cuda"``, where this PyTorch build has CUDA (a fake tensor needs no card),
else ``"meta"`` — a CPU-only build cannot index a fake CUDA tensor (its
Python indexing takes a CUDA device guard), and a meta tensor runs the same
ops with every kernel wrapper refusing it, as the card's route would have
it reach none.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quant import QuantConfig
from repro_torch.models import model as M
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     cosine_schedule, tree_leaves, tree_map)

__all__ = ["SHAPES", "shape_applicable", "fake_device", "new_fake_mode", "make_train_step",
           "make_serve_step", "make_paged_serve_step",
           "make_paged_prefill_chunk_step", "make_page_copy_step",
           "make_prefill_step", "input_specs", "param_structs",
           "opt_structs", "qparam_structs", "cache_structs",
           "paged_pool_structs"]


SHAPES = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}

_SUBQUADRATIC = ("ssm", "hybrid")


def shape_applicable(cfg: ModelConfig, shape: str) -> bool:
    if shape == "long_500k":
        return cfg.block_pattern in _SUBQUADRATIC
    return True


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


# ---------------------------------------------------------------------------
# Fake-tensor builders (no allocation: the dry run's inputs)
# ---------------------------------------------------------------------------

def fake_device() -> str:
    """The device the fake builders and the dry run trace on by default:
    "cuda" where this PyTorch build has CUDA, else "meta"."""
    return "cuda" if torch.backends.cuda.is_built() else "meta"


def new_fake_mode():
    """A ``FakeTensorMode`` for the builders and the dry run. Non-fake
    inputs are converted: on the meta device a ``torch.tensor`` constant
    stays a plain meta tensor."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def _fake(fake_mode):
    """The caller's ``FakeTensorMode``, else a new one."""
    return fake_mode or new_fake_mode()


def param_structs(cfg: ModelConfig, *, fake_mode=None, device=None):
    """``init_params(cfg)`` as fake tensors (the draws are not made)."""
    with _fake(fake_mode):
        return M.init_params(cfg, None, device=device or fake_device())


def opt_structs(cfg: ModelConfig, *, fake_mode=None, device=None):
    """``adamw_init`` over :func:`param_structs`."""
    mode = _fake(fake_mode)
    with mode:
        return adamw_init(param_structs(cfg, fake_mode=mode, device=device))


def qparam_structs(cfg: ModelConfig, qcfg: QuantConfig, *, fake_mode=None,
                   device=None):
    """The packed-QTensor param tree (``pack_model`` over
    :func:`param_structs`), the serving dry run's weights."""
    from repro_torch.quantized.qmodel import pack_model

    mode = _fake(fake_mode)
    with mode:
        return pack_model(param_structs(cfg, fake_mode=mode, device=device),
                          qcfg)


def cache_structs(cfg: ModelConfig, batch: int, max_len: int, *,
                  fake_mode=None, device=None):
    """``init_cache(cfg, batch, max_len)`` as fake tensors."""
    with _fake(fake_mode):
        return M.init_cache(cfg, batch, max_len,
                            device=device or fake_device())


def paged_pool_structs(cfg: ModelConfig, n_pages: int, page_size: int, *,
                       fake_mode=None, device=None):
    """The page pools of ``PagedKVCache`` itself, as fake tensors, so the
    dry-run specs cannot drift from the layout the batcher allocates."""
    from repro_torch.serving.paged_cache import PagedKVCache

    with _fake(fake_mode):
        return PagedKVCache(cfg, n_pages=n_pages, page_size=page_size,
                            max_pages_per_seq=1,
                            device=device or fake_device()).pools


def input_specs(cfg: ModelConfig, shape: str,
                qcfg: Optional[QuantConfig] = None, *, fake_mode=None,
                device=None):
    """(step kind, the step's arguments as fake tensors) for ``shape`` of
    :data:`SHAPES`, as the reference's ``input_specs`` builds them: tokens
    int32; a vision stack's ``vision_embeds`` (B, frontend_len, D) and an
    encoder-decoder stack's ``enc_embeds`` (B, S, D) in the compute dtype;
    the serving cells' weights packed at ``qcfg`` (2-bit g128 by default);
    a decode cell's cache ``max_len`` = seq deep (an encoder-decoder
    cache's ``"cross"`` K/V over ``frontend_len`` encoder positions) and
    its index the host int seq - 1: the port's attention reads the rows up
    to the index, so the step at the last position reads the whole cache,
    as the reference's step does at its traced index."""
    from repro_torch.models.frontends import frontend_spec

    info = SHAPES[shape]
    B, S = info["batch"], info["seq"]
    mode = _fake(fake_mode)
    device = device or fake_device()
    dt = getattr(torch, cfg.compute_dtype)

    def tokens(b, s):
        return torch.zeros((b, s), dtype=torch.int32, device=device)

    def frontends(batch):
        if cfg.frontend == "vision":
            batch["vision_embeds"] = frontend_spec(
                cfg, B, cfg.frontend_len, fake_mode=mode, device=device)
        if cfg.is_enc_dec:
            batch["enc_embeds"] = frontend_spec(cfg, B, S, fake_mode=mode,
                                                device=device)
        return batch

    with mode:
        if info["kind"] == "train":
            params = param_structs(cfg, fake_mode=mode, device=device)
            return "train", (params, adamw_init(params),
                             frontends({"tokens": tokens(B, S)}))
        params_q = qparam_structs(cfg, qcfg or QuantConfig(bits=2,
                                                           group_size=128),
                                  fake_mode=mode, device=device)
        if info["kind"] == "prefill":
            return "prefill", (params_q, frontends({"tokens": tokens(B, S)}))
        cache = cache_structs(cfg, B, S, fake_mode=mode, device=device)
        if cfg.is_enc_dec:
            enc = cfg.frontend_len or S
            kv = (cfg.n_layers, B, enc, cfg.n_kv_heads, cfg.resolved_head_dim)
            cache["cross"] = tuple(torch.zeros(kv, dtype=dt, device=device)
                                   for _ in range(2))
        return "decode", (params_q, tokens(B, 1), cache, S - 1)
