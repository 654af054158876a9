"""Sequence-sharded decode attention via the partial-softmax (log-sum-exp)
merge (the reference's ``repro.dist.attention``, over ``torch.distributed``).

Each rank holds a slice of every sequence's KV cache and computes its
attention stats over it:

    acc_i = sum_s exp(s - m_i) * v_s      (unnormalized output)
    m_i   = max_s(scores)                 (running max)
    l_i   = sum_s exp(s - m_i)            (normalizer mass)

and the merge recovers EXACT dense softmax attention:

    m*  = max_i m_i
    out = sum_i exp(m_i - m*) acc_i / sum_i exp(m_i - m*) l_i

— the identity flash attention uses across KV blocks, applied across ranks.
Two collectives, both O(B*H*Dh) and independent of the sequence length: an
all-reduce MAX of m, then ONE all-reduce SUM of alpha·acc and alpha·l side
by side (the reference's fused psum). A fully masked shard has m = -1e30,
so its weight exp(m - m*) is exactly 0. ``merge_partials`` is the
collective-free merge of stacked stats (``kernels/ref.py``).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.dist import runtime
from repro_torch.kernels.ref import merge_partials

__all__ = ["partial_decode_attention", "merge_partials",
           "sharded_decode_attention", "sharded_paged_decode_attention"]

_MASKED = -1e30  # the kernels' masking value (finite: no NaN via inf-inf)


def partial_decode_attention(q, k, v, *, kv_len=None, start=0):
    """One-token attention stats over a local KV shard.

    q: (B, H, Dh); k/v: (B, S_shard, H, Dh). ``start`` is this shard's global
    sequence offset; positions >= ``kv_len`` are masked out. Returns
    (acc (B, H, Dh), m (B, H), l (B, H)) in float32, as the reference
    computes them (a fully masked shard: m = -1e30, weight 0 in a merge
    with any unmasked shard)."""
    dh = q.shape[-1]
    s = torch.einsum("bhd,bshd->bhs", q.float(), k.float()) * dh ** -0.5
    if kv_len is not None:
        pos = start + torch.arange(k.shape[1], device=q.device)
        s = torch.where(pos[None, None, :] < kv_len, s,
                        torch.tensor(_MASKED, device=q.device))
    m = torch.amax(s, dim=-1)
    p = torch.exp(s - m[..., None])
    l = torch.sum(p, dim=-1)  # noqa: E741 — softmax (m, l)
    acc = torch.einsum("bhs,bshd->bhd", p, v.float())
    return acc, m, l


def _merge_over(acc, m, l, group):  # noqa: E741 — softmax (m, l)
    """The two collectives of the cross-rank merge: all-reduce MAX of m,
    then one all-reduce SUM of [alpha·acc, alpha·l]. Returns (B, H, Dh)."""
    m_star = m.clone()
    if runtime.group_size(group) > 1:
        dist.all_reduce(m_star, op=dist.ReduceOp.MAX, group=group)
    alpha = torch.exp(m - m_star)
    fused = torch.cat([alpha[..., None] * acc, (alpha * l)[..., None]], -1)
    if runtime.group_size(group) > 1:
        dist.all_reduce(fused, op=dist.ReduceOp.SUM, group=group)
    num, den = fused[..., :-1], fused[..., -1]
    return num / torch.clamp_min(den, 1e-30)[..., None]


def sharded_decode_attention(q, k, v, group=None, *, shard_start=0,
                             kv_len=None):
    """Decode attention over a sequence-sharded contiguous KV cache.

    q: (B, H, Dh), the same on every rank; k/v: (B, S_local, H, Dh), this
    rank's sequence slice; ``shard_start`` its global offset (typically
    rank · S_local); ``kv_len`` the global length. Plain PyTorch."""
    acc, m, l = partial_decode_attention(q, k, v, kv_len=kv_len,  # noqa: E741
                                         start=shard_start)
    return _merge_over(acc, m, l, group)


def sharded_paged_decode_attention(q, k_pages, v_pages, block_tables,
                                   seq_lens, group=None, k_scale=None,
                                   v_scale=None, *, fused_gqa: bool = True,
                                   gqa_pages_per_block: int = 1):
    """Decode attention over a sequence-sharded PAGED cache.

    Each rank owns a page pool holding its slice of every sequence, with
    its block tables (B, P_local) and LOCAL lengths (B,). The paged-decode
    kernel (``kernels.ops.paged_decode`` with ``normalize=False``: the CUDA
    split-KV kernel on a CUDA tensor, its plain version on a CPU one) emits
    the (acc, m, l) partials this merge needs. Softmax weights depend only
    on scores, not positions, so local masking per rank merges exactly.
    ``fused_gqa`` / ``gqa_pages_per_block`` pick the kernel's route as in
    ``ops.paged_decode``."""
    from repro_torch.kernels import ops
    acc, m, l = ops.paged_decode(q, k_pages, v_pages,  # noqa: E741
                                 block_tables, seq_lens, k_scale, v_scale,
                                 normalize=False, fused_gqa=fused_gqa,
                                 gqa_pages_per_block=gqa_pages_per_block)
    return _merge_over(acc, m, l, group)
