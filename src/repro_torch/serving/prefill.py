"""Chunked paged prefill: prompt K/V written straight into allocated pages
(the reference's ``repro.serving.prefill``).

The prompt is split into chunks of ``chunk_pages * page_size`` tokens (the
tail chunk padded up to a page multiple); each chunk's K/V is written in
place into the sequence's allocated pages, and the chunk attends over the
pool itself (``paged_prefill_attention``): one page per loop step with an
online-softmax (m, l, acc) carry, causally masked at absolute positions, so
no contiguous per-sequence cache ever exists. The reference runs this in
plain jnp (no Pallas kernel), and so does the port in plain PyTorch.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig, check_supported
from repro_torch.models.model import embed_tokens, layer_slice, lm_head_logits
from repro_torch.serving.decode import paged_block_body, write_rows

__all__ = ["paged_prefill_attention", "paged_prefill_block",
           "make_paged_prefill_step", "run_prefill_chunks"]

NEG = -1e30


def paged_prefill_attention(q, pools, block_tables, offset: int):
    """Causal attention of a prefill chunk over the page pool.

    q: (B, C, H, Dh) chunk queries at absolute positions ``offset + i``;
    pools: one layer's views {"k"/"v": (N, psz, Hkv, Dh)[, scales]};
    block_tables: (B, P) physical page ids; ``offset`` page aligned. Only
    the first ``min((offset + C) // psz, P)`` table entries can hold a
    causally reachable key, so only those pages are read. Returns
    (B, C, H, Dh) f32.
    """
    B, C, H, Dh = q.shape
    kp, vp = pools["k"], pools["v"]
    psz, Hkv = kp.shape[1], kp.shape[2]
    rep = H // Hkv
    P = block_tables.shape[1]
    ks, vs = pools.get("k_scale"), pools.get("v_scale")
    dev = q.device

    qf = (q.float() * Dh ** -0.5).transpose(1, 2)         # (B, H, C, Dh)
    q_pos = offset + torch.arange(C, device=dev)          # (C,) absolute
    m = torch.full((B, H, C), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, C), dtype=torch.float32, device=dev)  # noqa: E741
    acc = torch.zeros((B, H, C, Dh), dtype=torch.float32, device=dev)
    for p in range(min((offset + C) // psz, P)):
        pg = block_tables[:, p].long()                    # (B,) physical page
        kb = kp[pg].float()                               # (B, psz, Hkv, Dh)
        vb = vp[pg].float()
        if ks is not None:
            kb = kb * ks[pg][..., None].float()
            vb = vb * vs[pg][..., None].float()
        kb = kb.transpose(1, 2)                           # (B, Hkv, psz, Dh)
        vb = vb.transpose(1, 2)
        if rep > 1:
            kb = kb.repeat_interleave(rep, dim=1)
            vb = vb.repeat_interleave(rep, dim=1)
        s = qf @ kb.transpose(-1, -2)                     # (B, H, C, psz)
        k_pos = p * psz + torch.arange(psz, device=dev)
        mask = k_pos[None, :] <= q_pos[:, None]           # (C, psz) causal
        s = torch.where(mask, s, NEG)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        prob = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        acc = acc * corr[..., None] + prob @ vb
        l = l * corr + torch.sum(prob, dim=-1)  # noqa: E741
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.transpose(1, 2)                            # (B, C, H, Dh)


def paged_prefill_block(p, cfg: ModelConfig, x, pools, block_tables,
                        offset: int):
    """One layer's attention sublayer for a prefill chunk (write + attend).

    x: (1, C, D) normed input, C a page multiple, ``offset`` page-aligned.
    Writes the chunk's K/V into pages ``block_tables[0, offset//psz :
    offset//psz + C//psz]`` in place, then attends over the pool. The
    chunk's tokens sit at positions ``offset ..`` (RoPE included), so K in
    an aliased prefix page was rotated at the same absolute positions.
    Returns (attn_out, pools).
    """
    C = x.shape[1]
    psz = pools["k"].shape[1]
    positions = offset + torch.arange(C, device=x.device)[None]   # (1, C)
    q, k, v = L.attn_qkv(p, cfg, x, positions)
    ids = block_tables[0, offset // psz: offset // psz + C // psz].long()

    def rows(val):       # (1, C, ...) -> (n_pages, psz, ...)
        return val[0].reshape((ids.shape[0], psz) + tuple(val.shape[2:]))

    if "k_scale" in pools:
        kq, vq, kscale, vscale = L.quantize_kv(k, v)
        for key, val in (("k", kq), ("v", vq), ("k_scale", kscale),
                         ("v_scale", vscale)):
            write_rows(pools[key], ids, rows(val))
    else:
        write_rows(pools["k"], ids, rows(k))
        write_rows(pools["v"], ids, rows(v))
    out = paged_prefill_attention(q, pools, block_tables, offset)
    return L.attn_out(p, out.to(q.dtype)), pools


def run_prefill_chunks(chunk_fn, params_q, pools, full, block_table, *,
                       page_size: int, chunk_pages: int, start: int = 0):
    """Drive ``chunk_fn`` (a ``make_paged_prefill_step``) over
    ``full[start:]`` in page-aligned chunks.

    ``start`` must be a ``page_size`` multiple strictly below ``len(full)``
    — positions below it were aliased from already-populated pages and are
    skipped. Returns ``(last_logits_row, pools, n_chunks)``, where
    ``last_logits_row`` is the (V,) logits of the final prompt position.
    """
    plen = len(full)
    if not 0 <= start < plen:
        raise ValueError(f"start={start} outside prompt of {plen} tokens")
    if start % page_size:
        raise ValueError(f"start={start} not page aligned (psz={page_size})")
    chunk_tokens = max(chunk_pages, 1) * page_size
    off, last_off = start, start
    logits = None
    n_chunks = 0
    while off < plen:
        n_tok = min(chunk_tokens, plen - off)
        c = -(-n_tok // page_size) * page_size  # pad tail to a page multiple
        toks = np.zeros((1, c), np.int64)
        toks[0, :n_tok] = full[off: off + n_tok]
        logits, pools = chunk_fn(params_q,
                                 torch.from_numpy(toks).to(block_table.device),
                                 pools, block_table, off)
        n_chunks += 1
        last_off, off = off, off + n_tok
    return logits[0, (plen - 1) - last_off], pools, n_chunks


def make_paged_prefill_step(cfg: ModelConfig):
    """(params_q, tokens (1, C), pools, block_tables (1, P), offset int)
    -> (logits (1, C, V) vocab-masked, pools).

    One prefill CHUNK: C must be a ``page_size`` multiple and ``offset``
    page aligned. Padded tail positions write garbage into the chunk's own
    allocated pages, masked at every later read by causality and
    per-sequence lengths. SSM and hybrid stacks raise ``ValueError``, as in
    the reference.
    """
    check_supported(cfg)
    if cfg.block_pattern not in ("dense", "moe"):
        raise ValueError(f"paged prefill requires attention blocks, "
                         f"got {cfg.block_pattern!r}")
    if cfg.is_enc_dec:
        raise ValueError("paged prefill does not cover cross-attention caches")

    def chunk_step(params_q, tokens, pools, block_tables, offset: int):
        C = tokens.shape[1]
        positions = offset + torch.arange(C, device=tokens.device)
        h = embed_tokens(params_q, cfg, tokens, positions)

        def attn(p, x, pool_slice):
            return paged_prefill_block(p, cfg, x, pool_slice, block_tables,
                                       offset)

        for i in range(cfg.n_layers):
            h, _ = paged_block_body(layer_slice(params_q["blocks"], i), cfg,
                                    h, {k: v[i] for k, v in pools.items()},
                                    attn)
        return lm_head_logits(params_q, cfg, h, mask_vocab=True), pools

    return chunk_step
