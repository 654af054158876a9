"""Paged decode step: one token for every batch slot, KV in pages (the
reference's ``repro.serving.decode``).

Per layer the step

  1. writes this step's K/V (quantized to int8 when configured) into each
     sequence's current page at ``(block_table[b, pos // psz], pos % psz)``,
     in place (``serving.paged_cache`` says why that is safe);
  2. attends over the pool through ``kernels.paged_decode`` — the
     hand-written CUDA kernel for a CUDA tensor, whose route follows the
     head layout (per query head for MHA, per KV head for GQA).

The block's FFN is the dense MLP or, for an MoE config, the reference's
MoE dispatch (``models.model.ffn_sublayer``); capacity is per row, so a
one-token decode row never drops a slot (``capacity(1) = 1``, and a
token's K experts are distinct).

Positions are PER-SEQUENCE (``seq_lens`` (B,)). Idle slots carry
``seq_len == 0`` and a null-page block table: their write lands in the
reserved page and their output is discarded.

Token selection is greedy by default. Sampling (one temperature and
top-k for the batch, or per request) draws Gumbel noise from a
``torch.Generator`` per sampled row on the logits' device, seeded by
``request_key(seed, token_index, device)`` from (seed, token index) ALONE,
so a preempted request resumes its own stream, and adds it to the
temperature-scaled (optionally top-k-restricted) logits before the argmax —
the Gumbel-max form of ``jax.random.categorical``. The noise is not
``jax.random``'s (nor the same on the card as on the CPU): sampled tokens
are held to the reference by their properties, greedy tokens exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels import paged_decode
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig, check_supported
from repro_torch.models.model import (dequant_tree, embed_tokens,
                                      ffn_sublayer, layer_slice,
                                      lm_head_logits)

__all__ = ["make_paged_decode_step", "paged_decode_logits",
           "paged_attention_block",
           "paged_block_body", "sample_logits", "sample_logits_per_seq",
           "request_key", "top_k_restrict"]


def request_key(seed: int, token_index: int, device) -> torch.Generator:
    """The sample stream of a request's ``token_index``-th generated token:
    a ``torch.Generator`` on ``device`` seeded from (seed, token index)
    alone."""
    state = np.random.SeedSequence([int(seed), int(token_index)]
                                   ).generate_state(2, np.uint32)
    return torch.Generator(device=device).manual_seed(
        (int(state[0]) << 31) ^ int(state[1]))


_TINY = torch.finfo(torch.float32).tiny


def _gumbel(keys, V: int, device) -> torch.Tensor:
    """(B, V) f32 Gumbel noise on ``device``, row b from generator
    ``keys[b]`` (zeros for a row whose key is None). The uniform draws lie
    in [finfo(f32).tiny, 1), as ``jax.random.gumbel``'s do: a draw of 0
    would give noise -inf and shut its token out whatever its logit."""
    rows = [torch.zeros(V, device=device) if g is None else
            -torch.log(-torch.log(torch.rand(V, generator=g, device=device)
                                  .clamp_min_(_TINY)))
            for g in keys]
    return torch.stack(rows)


def top_k_restrict(logits, top_k):
    """Per-row top-k: logits below the row's k-th largest become -inf;
    rows with ``top_k == 0`` are left as they are. ``top_k`` (B,)."""
    V = logits.shape[-1]
    top_k = torch.as_tensor(top_k, device=logits.device).long()
    srt = torch.sort(logits, dim=-1, descending=True).values
    kth = torch.gather(srt, -1, torch.clamp(top_k - 1, 0, V - 1)[:, None])
    restricted = torch.where(logits < kth, -torch.inf, logits)
    return torch.where((top_k > 0)[:, None], restricted, logits)


def sample_logits(logits, keys, *, temperature: float, top_k: int = 0):
    """Temperature / top-k sampling with one config for every row.

    logits (B, V); ``keys`` a list of B generators (``request_key``) on
    the logits' device.
    ``temperature <= 0`` is the greedy argmax. Returns (B,) int64 —
    deterministic in (logits, keys).
    """
    logits = logits.float()
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -torch.inf, logits)
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    return torch.argmax(logits / temperature
                        + _gumbel(keys, logits.shape[-1], logits.device),
                        dim=-1)


def sample_logits_per_seq(logits, keys, temperature, top_k):
    """Per-SEQUENCE temperature / top-k sampling (params as (B,) arrays).

    Each row carries its own ``temperature`` and ``top_k`` (0 =
    unrestricted); rows with ``temperature <= 0`` take the exact argmax, and
    ``keys[b]`` may be None for them. For a row with top_k == k the kept set
    is ``sample_logits``'s.
    """
    logits = logits.float()
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=logits.device)
    greedy = torch.argmax(logits, dim=-1)
    eff = top_k_restrict(logits, top_k)
    safe_t = torch.where(temperature > 0.0, temperature, 1.0)
    noisy = eff / safe_t[:, None] + _gumbel(keys, logits.shape[-1],
                                            logits.device)
    return torch.where(temperature > 0.0, torch.argmax(noisy, dim=-1), greedy)


def paged_block_body(pl, cfg: ModelConfig, carry, pool_slice, attn_sublayer):
    """One dense or MoE block over a paged pool slice, shared by the decode step
    and the prefill chunk step — ``attn_sublayer(attn_params, normed_x,
    pool_slice) -> (attn_out, pools)`` is the ONLY difference between them,
    so their numerics cannot drift (a re-admitted request resumes through
    the same block math). The dequant is a ``serve.dequant`` profiler
    range when ``obs.enable_profiler()`` is on."""
    with obs.profile_range("serve.dequant"):
        pl = dequant_tree(pl, getattr(torch, cfg.compute_dtype))
    a_in = L.apply_norm(carry, pl["ln1"], cfg.norm)
    a, pools = attn_sublayer(pl["attn"], a_in, pool_slice)
    hh, m_in = L.add_norm(carry, a, pl["ln2"], cfg.norm)
    return hh + ffn_sublayer(pl, cfg, m_in), pools


def write_rows(pool, idx, val):
    """pool[idx] <- val in place, cast to the pool's dtype."""
    pool[idx] = val.to(pool.dtype)


def paged_attention_block(p, cfg: ModelConfig, x, pools, block_tables,
                          seq_lens, *, gqa_pages_per_block: int = 1):
    """Attention sublayer over the paged cache (one layer's pool views).

    x: (B, 1, D) normed input; pools: {"k"/"v": (N, psz, Hkv, hd)[, scales]}
    written in place; block_tables (B, P) int32; seq_lens (B,) int32.
    Returns (attn_out (B, 1, D), pools). Each sequence's token sits at its
    write position ``seq_lens[b]`` (RoPE included).
    """
    q, k, v = L.attn_qkv(p, cfg, x, seq_lens.long()[:, None])
    psz = pools["k"].shape[1]
    lens = seq_lens.long()
    phys = torch.gather(block_tables.long(), 1,
                        (lens // psz)[:, None])[:, 0]   # (B,) physical page
    slot = lens % psz
    if "k_scale" in pools:  # int8 pool: same convention as the dense cache
        kq, vq, ks, vs = L.quantize_kv(k, v)
        for key, val in (("k", kq), ("v", vq), ("k_scale", ks),
                         ("v_scale", vs)):
            write_rows(pools[key], (phys, slot), val[:, 0])
    else:
        write_rows(pools["k"], (phys, slot), k[:, 0])
        write_rows(pools["v"], (phys, slot), v[:, 0])
    out = paged_decode(q[:, 0], pools["k"], pools["v"], block_tables,
                       seq_lens + 1, pools.get("k_scale"),
                       pools.get("v_scale"),
                       gqa_pages_per_block=gqa_pages_per_block)
    return L.attn_out(p, out[:, None].to(q.dtype)), pools


def paged_decode_logits(params_q, cfg: ModelConfig, tokens, pools,
                        block_tables, seq_lens, *,
                        gqa_pages_per_block: int = 1):
    """The decode step before token selection: (B, 1, V) vocab-masked
    logits of ``tokens`` (B, 1) at positions ``seq_lens``, and the pools
    with this step's K/V written in."""
    h = embed_tokens(params_q, cfg, tokens, seq_lens.long()[:, None])

    def attn(p, x, pool_slice):
        return paged_attention_block(p, cfg, x, pool_slice, block_tables,
                                     seq_lens,
                                     gqa_pages_per_block=gqa_pages_per_block)

    for i in range(cfg.n_layers):
        h, _ = paged_block_body(layer_slice(params_q["blocks"], i), cfg, h,
                                {k: v[i] for k, v in pools.items()}, attn)
    return lm_head_logits(params_q, cfg, h, mask_vocab=True), pools


def make_paged_decode_step(cfg: ModelConfig, *, temperature: float = 0.0,
                           top_k: int = 0, per_request: bool = False,
                           gqa_pages_per_block: int = 1):
    """(params_q, tokens (B,1), pools, block_tables (B,P), seq_lens (B,))
    -> (next_token (B,1) int64, pools), greedy.

    ``pools`` leaves carry a leading n_layers axis; layer ``i`` reads and
    writes its views ``leaf[i]``.

    With ``temperature > 0`` the step takes one more trailing argument,
    ``sample_keys``: a list of B generators (``request_key``'s kind) on the
    logits' device, one a row, and samples every row through
    ``sample_logits`` at this ``temperature`` and ``top_k``. With
    ``temperature <= 0`` it is the greedy step and ``top_k`` is ignored,
    as in the reference.

    ``per_request=True`` instead appends ``seeds``, ``token_indices``,
    ``temperatures`` and ``top_ks`` (host arrays, (B,)): keys come from
    ``request_key`` per sampled slot and selection routes through
    ``sample_logits_per_seq``. SSM and hybrid stacks raise ``ValueError``,
    as in the reference: they keep O(1) state per block, not pages.
    """
    check_supported(cfg)
    if cfg.block_pattern not in ("dense", "moe"):
        raise ValueError(f"paged decode requires attention blocks, "
                         f"got {cfg.block_pattern!r}")
    if cfg.is_enc_dec:
        raise ValueError("paged decode does not cover cross-attention caches")

    def logits_step(params_q, tokens, pools, block_tables, seq_lens):
        return paged_decode_logits(params_q, cfg, tokens, pools, block_tables,
                                   seq_lens,
                                   gqa_pages_per_block=gqa_pages_per_block)

    if per_request:
        def per_request_step(params_q, tokens, pools, block_tables, seq_lens,
                             seeds, token_indices, temperatures, top_ks):
            logits, pools = logits_step(params_q, tokens, pools,
                                        block_tables, seq_lens)
            keys = [request_key(s, i, logits.device) if t > 0.0 else None
                    for s, i, t in zip(seeds, token_indices, temperatures)]
            next_tok = sample_logits_per_seq(logits[:, -1], keys,
                                             temperatures, top_ks)
            return next_tok[:, None], pools
        return per_request_step

    if temperature > 0.0:
        def sampled_step(params_q, tokens, pools, block_tables, seq_lens,
                         sample_keys):
            logits, pools = logits_step(params_q, tokens, pools,
                                        block_tables, seq_lens)
            next_tok = sample_logits(logits[:, -1], sample_keys,
                                     temperature=temperature, top_k=top_k)
            return next_tok[:, None], pools
        return sampled_step

    def step(params_q, tokens, pools, block_tables, seq_lens):
        logits, pools = logits_step(params_q, tokens, pools, block_tables,
                                    seq_lens)
        return torch.argmax(logits[:, -1], dim=-1)[:, None], pools

    return step
