"""Building blocks: norms, activation, RoPE, self- and cross-attention, MLP,
MoE.

Plain functions on tensors with the reference's layout (``x @ W``
orientation, (B, S, H, Dh) heads). RoPE and qk-norm are plain PyTorch, as
they are jnp in the reference. Attention is the reference's
``blocked_attention`` online softmax in plain PyTorch (jnp there, not a
Pallas kernel), except one-token decode over a contiguous cache with
``cfg.use_flash_decode``, which takes the ``flash_decode`` kernel (f32
whatever ``cfg.attn_softmax_dtype`` says, as the reference's kernel route;
the reference falls back to ``blocked_attention`` only at a traced cache
index, which the port's host-integer index never is).

In a bf16 model each operation rounds to bf16 where the reference's does
(its jnp ops on bf16 arrays, as XLA compiles them on the CPU): the norms
and RoPE compute in f32 and round once, ``silu`` rounds after each of its
four steps as ``jax.nn.silu`` (``x * sigmoid(x)``, the sigmoid as ``1 /
(1 + exp(-x))``) does, and ``blocked_attention`` keeps its scores in
``softmax_dtype`` with (m, l, acc) in f32. (``gelu``, which no bf16 config
uses, rounds once.)
Cross-attention (an encoder-decoder's decoder over the encoder's K/V) is
non-causal ``blocked_attention`` on every call, decode included: the
reference routes none of it through its flash kernel. The MoE
FFN is the reference's top-k dispatch with per-row capacity; its expert
products are plain matmuls, as they are ``jnp.einsum`` there.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.models.config import ModelConfig

__all__ = ["NEG_INF", "rmsnorm", "layernorm", "apply_norm", "add_norm",
           "init_norm",
           "activation_fn", "rope_cos_sin", "apply_rope", "attn_qkv",
           "attn_out", "blocked_attention", "self_attention",
           "cross_attention", "cross_kv", "mlp",
           "quantize_kv", "init_moe", "moe_top_k", "moe_route", "moe_ffn",
           "moe_aux_loss", "EXPERT_OVERRIDE"]

NEG_INF = -1e30


def rmsnorm(x, w, eps=1e-6, dtype=None):
    """RMSNorm in f32, rounded to ``dtype`` (x's by default), then times w."""
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dtype or x.dtype) * w


def layernorm(x, w, b, eps=1e-5, dtype=None):
    """LayerNorm in f32, rounded to ``dtype`` (x's by default), then w, b."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(dtype or x.dtype) * w + b


def _norm(x, p, kind, dtype):
    if kind == "layernorm":
        return layernorm(x, p["w"], p["b"], dtype=dtype)
    return rmsnorm(x, p["w"], dtype=dtype)


def apply_norm(x, p, kind):
    return _norm(x, p, kind, x.dtype)


def add_norm(h, a, p, kind):
    """The residual h + a and the next pre-norm of it: (the sum rounded to
    h's dtype, the norm ``p`` of the unrounded sum, rounded to h's dtype).
    The reference's blocks, as XLA compiles them, compute a bf16 residual
    sum that feeds the next norm's f32 upcast without rounding it, while
    the residual stream itself is rounded; in f32 the two are one tensor."""
    s = h.float() + a.float()
    return s.to(h.dtype), _norm(s, p, kind, h.dtype)


def init_norm(lead, d, kind, dtype, device):
    """Norm params with leading stack dims ``lead`` (a tuple)."""
    p = {"w": torch.ones(lead + (d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["b"] = torch.zeros(lead + (d,), dtype=dtype, device=device)
    return p


def _gelu_tanh(x):
    # jax.nn.gelu defaults to the tanh approximation
    return torch.nn.functional.gelu(x, approximate="tanh")


def _silu(x):
    """``jax.nn.silu``: in f32 one fused op; in a narrower dtype the
    reference's steps, each rounded to it: exp(-x), 1 + that, its
    reciprocal, x times that."""
    if x.dtype == torch.float32:
        return torch.nn.functional.silu(x)
    return x * torch.reciprocal(1.0 + torch.exp(-x))


def activation_fn(name):
    return {"relu": torch.relu, "silu": _silu, "gelu": _gelu_tanh}[name]


@functools.lru_cache(maxsize=16)
def _rope_inv_freq(head_dim: int, theta: float, device: torch.device):
    """The reference's ``1 / theta ** (arange(0, hd, 2) / hd)`` in f32. The
    exponents are f32 quotients as there; the power is taken in float64
    and rounded to f32, which gives XLA's f32 ``pow`` bit for bit (f32
    ``torch.pow`` is off by an ulp at theta 1e6 and 5e6), and the
    reciprocal is a division by a same-device f32 tensor (``core.quant``)."""
    x = np.arange(0, head_dim, 2, dtype=np.float32) / np.float32(head_dim)
    pw = (np.float64(theta) ** x.astype(np.float64)).astype(np.float32)
    one = torch.ones((), dtype=torch.float32, device=device)
    return one / torch.from_numpy(pw).to(device)


def rope_cos_sin(positions, head_dim: int, theta: float):
    """positions: (..., S) int -> cos/sin (..., S, head_dim // 2) f32.
    Under a fake trace (``launch.dryrun``) the inverse frequencies are made
    afresh, not cached: a cached fake tensor would stand in for them in
    later real runs."""
    inv_freq = _rope_inv_freq if torch._guards.active_fake_mode() is None \
        else _rope_inv_freq.__wrapped__
    inv = inv_freq(head_dim, float(theta), positions.device)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (B, S, H, Dh); cos/sin: (B, S, Dh//2) or (S, Dh//2). Rotates the
    two halves of Dh (not interleaved pairs), as the reference does."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    if cos.ndim == 2:
        cos, sin = cos[None], sin[None]
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def quantize_kv(k, v):
    """int8 KV quantize-on-write: absmax scale per (..., head) over head_dim
    (the reference's ``quantize_kv``). Divisions are by same-device tensors,
    so they round as the reference's do (see ``core.quant``); ``torch.round``
    is half to even like ``jnp.round``. Returns (k_int8, v_int8, k_scale,
    v_scale)."""
    c127 = torch.tensor(127.0, dtype=k.dtype, device=k.device)
    ks = torch.amax(torch.abs(k), dim=-1) / c127 + 1e-8
    vs = torch.amax(torch.abs(v), dim=-1) / c127 + 1e-8
    kq = torch.round(k / ks[..., None]).to(torch.int8)
    vq = torch.round(v / vs[..., None]).to(torch.int8)
    return kq, vq, ks, vs


def attn_qkv(p, cfg: ModelConfig, x, positions):
    """Project, qk-norm over Dh, RoPE at ``positions`` ((S,) or (B, S)).
    Returns q, k, v as (B, S, H, Dh)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"])
        k = rmsnorm(k, p["k_norm"])
    if cfg.pos_emb == "rope":
        cos, sin = rope_cos_sin(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def attn_out(p, x_attn):
    B, S = x_attn.shape[:2]
    out = x_attn.reshape(B, S, -1) @ p["wo"]
    if "bo" in p:
        out = out + p["bo"]
    return out


def blocked_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                      kv_len=None, chunk: int = 1024, k_scale=None,
                      v_scale=None, softmax_dtype=torch.float32,
                      repeat_kv: bool = False):
    """q: (B, Sq, Hq, Dh); k/v: (B, Sk, Hkv, Dh) -> (B, Sq, Hq, Dh).

    The reference's online-softmax (flash-attention recurrence) over KV
    chunks of ``chunk`` positions: ``q_offset`` is the absolute position of
    q[0] (decode), keys at or past ``kv_len`` are masked, and int8 caches
    come with (B, Sk, Hkv) ``k_scale``/``v_scale``, dequantised per chunk.
    Query head h reads KV head h // (Hq // Hkv); ``repeat_kv`` repeats the
    KV heads (and scales) to Hq first, as the reference's
    ``gqa_repeat_kv`` does (the same values). The port's ``kv_len`` is a
    host integer, so the keys past it are sliced off before the chunking
    (the reference masks whole chunks of them; a fully masked chunk leaves
    (m, l, acc) unchanged, so the result is the same).

    ``softmax_dtype`` is the scores' dtype, as in the reference: q (pre-
    scaled by Dh^-0.5 rounded to it), K, V, the scores, the mask value
    (-1e30 in f32, -3e38 otherwise) and the probabilities are in it; the
    running max, sum and accumulator stay f32, and P·V accumulates in f32.
    """
    B, Sq, Hq, Dh = q.shape
    if kv_len is not None and kv_len < k.shape[1]:
        k, v = k[:, :kv_len], v[:, :kv_len]
        if k_scale is not None:
            k_scale, v_scale = k_scale[:, :kv_len], v_scale[:, :kv_len]
    if repeat_kv and k.shape[2] < Hq:
        rep0 = Hq // k.shape[2]
        k = torch.repeat_interleave(k, rep0, dim=2)
        v = torch.repeat_interleave(v, rep0, dim=2)
        if k_scale is not None:
            k_scale = torch.repeat_interleave(k_scale, rep0, dim=2)
            v_scale = torch.repeat_interleave(v_scale, rep0, dim=2)
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    dev = q.device
    sdt = softmax_dtype
    neg = NEG_INF if sdt == torch.float32 else -3e38
    # Dh^-0.5 rounded to sdt, as the reference's jnp.asarray(scale, sdt)
    scale = float(torch.tensor(Dh ** -0.5, dtype=sdt))
    # (B, Hkv, rep, Sq, Dh), pre-scaled as the reference does
    qg = (q.to(sdt) * scale).reshape(B, Sq, Hkv, rep, Dh).permute(
        0, 2, 3, 1, 4)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, Hkv, rep, Sq), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, Hkv, rep, Sq), dtype=torch.float32,  # noqa: E741
                    device=dev)
    acc = torch.zeros((B, Hkv, rep, Sq, Dh), dtype=torch.float32, device=dev)
    chunk = max(min(chunk, Sk), 1)
    for start in range(0, Sk, chunk):
        kb = k[:, start:start + chunk].to(sdt)              # (B, C, Hkv, Dh)
        vb = v[:, start:start + chunk].to(sdt)
        if k_scale is not None:
            kb = kb * k_scale[:, start:start + chunk, :, None].to(sdt)
            vb = vb * v_scale[:, start:start + chunk, :, None].to(sdt)
        kb = kb.permute(0, 2, 1, 3)[:, :, None]             # (B, Hkv, 1, C, Dh)
        vb = vb.permute(0, 2, 1, 3)[:, :, None]
        s = qg @ kb.transpose(-1, -2)                       # (B, Hkv, rep, Sq, C)
        if causal:
            k_pos = start + torch.arange(kb.shape[3], device=dev)
            mask = q_pos[:, None] >= k_pos[None, :]         # (Sq, C)
            s = torch.where(mask, s, neg)
        m_new = torch.maximum(m, torch.amax(s, dim=-1).float())
        p = torch.exp(s - m_new[..., None].to(sdt))
        if causal:
            p = torch.where(mask, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1).float()  # noqa: E741
        acc = acc * corr[..., None] + p.float() @ vb.float()
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, Dh).to(q.dtype)


def self_attention(p, cfg: ModelConfig, x, positions, *, causal: bool = True,
                   cache=None, cache_index: int = 0):
    """Self-attention block body (no norm / residual). Returns (out, cache).
    ``positions`` ((S,) or (B, S)) feed RoPE.

    ``cache``: optional one-layer dict {"k", "v": (B, Smax, Hkv, Dh)[,
    "k_scale", "v_scale": (B, Smax, Hkv)]}: this call's K/V are written at
    positions ``cache_index ..`` IN PLACE (quantized to int8 first when
    ``cfg.kv_cache_dtype == "int8"``; the reference returns a new cache) and
    the queries attend over the first ``cache_index + S`` positions. A
    one-token call with ``cfg.use_flash_decode`` takes the ``flash_decode``
    kernel; every other call ``blocked_attention``.
    """
    q, k, v = attn_qkv(p, cfg, x, positions)
    kw = dict(chunk=cfg.attn_chunk,
              softmax_dtype=getattr(torch, cfg.attn_softmax_dtype),
              repeat_kv=cfg.gqa_repeat_kv)
    if cache is None:
        out = blocked_attention(q, k, v, causal=causal, **kw)
        return attn_out(p, out), None
    S = x.shape[1]
    rows = slice(cache_index, cache_index + S)
    if cfg.kv_cache_dtype == "int8":
        kq, vq, ks, vs = quantize_kv(k, v)
        writes = (("k", kq), ("v", vq), ("k_scale", ks), ("v_scale", vs))
    else:
        writes = (("k", k), ("v", v))
    for key, val in writes:
        cache[key][:, rows] = val.to(cache[key].dtype)
    kv_len = cache_index + S
    if cfg.use_flash_decode and S == 1:
        out = _flash_decode_step(q, cache, kv_len)
    else:
        out = blocked_attention(q, cache["k"], cache["v"], causal=causal,
                                q_offset=cache_index, kv_len=kv_len,
                                k_scale=cache.get("k_scale"),
                                v_scale=cache.get("v_scale"), **kw)
    return attn_out(p, out), cache


def _flash_decode_step(q, cache, kv_len: int):
    """A single decode token through ``kernels.flash_decode`` (the CUDA
    kernel for a CUDA tensor): GQA query heads read their KV head in the
    kernel (no repeated cache), int8 caches are dequantised there."""
    from repro_torch.kernels import flash_decode
    out = flash_decode(q[:, 0], cache["k"], cache["v"], cache.get("k_scale"),
                       cache.get("v_scale"), kv_len=kv_len)
    return out[:, None].to(q.dtype)


def cross_attention(p, cfg: ModelConfig, x, enc_kv):
    """Decoder cross-attention (no norm / residual): queries from x (B, S,
    D), keys and values ``enc_kv = (k, v)`` (B, T, Hkv, Dh) precomputed
    from the encoder's output (:func:`cross_kv`); non-causal, no RoPE."""
    B, S, _ = x.shape
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(B, S, cfg.n_heads, cfg.resolved_head_dim)
    k, v = enc_kv
    out = blocked_attention(q, k, v, causal=False, chunk=cfg.attn_chunk)
    return attn_out(p, out)


def cross_kv(p, cfg: ModelConfig, enc_h):
    """The cross-attention's (k, v), each (B, T, Hkv, Dh), from the
    encoder's output enc_h (B, T, D)."""
    B, T, _ = enc_h.shape
    hd = cfg.resolved_head_dim
    k = enc_h @ p["wk"]
    v = enc_h @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    return (k.reshape(B, T, cfg.n_kv_heads, hd),
            v.reshape(B, T, cfg.n_kv_heads, hd))


def mlp(p, cfg: ModelConfig, x):
    act = activation_fn(cfg.activation)
    up = x @ p["up"]
    if "b_up" in p:
        up = up + p["b_up"]
    if cfg.gated_mlp:
        g = x @ p["gate"]
        if "b_gate" in p:
            g = g + p["b_gate"]
        h = act(g) * up
    else:
        h = act(up)
    out = h @ p["down"]
    if "b_down" in p:
        out = out + p["b_down"]
    return out


# ---------------------------------------------------------------------------
# MoE (top-k routing, per-row capacity, scatter dispatch)
# ---------------------------------------------------------------------------

# key of a one-layer MoE tree that names one expert's candidate leaves:
# ``moe_ffn`` reads tree[EXPERT_OVERRIDE] = (e, {"up", "down"[, "gate"]}) in
# place of expert e's slice of the stacks (the search's unit override)
EXPERT_OVERRIDE = "expert_override"


def init_moe(lead, cfg: ModelConfig, normal):
    """The reference's ``init_moe`` shapes and scales with leading stack
    dims ``lead`` (a tuple): router (D, E), up / gate (E, D, F), down (E,
    F, D); ``normal(shape, scale)`` draws the values."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    p = {"router": normal(lead + (d, e), d ** -0.5),
         "up": normal(lead + (e, d, f), d ** -0.5),
         "down": normal(lead + (e, f, d), f ** -0.5)}
    if cfg.gated_mlp:
        p["gate"] = normal(lead + (e, d, f), d ** -0.5)
    return p


def moe_top_k(logits, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, equal values in ascending index order (a stable
    descending sort; ``torch.topk`` gives no order for ties)."""
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_route(p, cfg: ModelConfig, x):
    """The reference's routing of x (B, S, D): top-k of the router logits,
    softmax of the top-k logits in f32 cast to x's dtype, token-major slots
    (slot s·K + k is token s's k-th choice), each slot's position in its
    expert by a per-row cumsum, and ``keep = pos < C`` with C =
    ``capacity(S)``. Returns (gate_w (B, S, K), e_idx (B, S·K), pos (B,
    S·K), keep (B, S·K), C)."""
    B, S, _ = x.shape
    E, K = cfg.moe.num_experts, cfg.moe.top_k
    C = cfg.moe.capacity(S)
    gate_w, gate_idx = moe_top_k(x @ p["router"], K)
    gate_w = torch.softmax(gate_w.float(), dim=-1).to(x.dtype)
    e_idx = gate_idx.reshape(B, S * K)
    onehot = torch.nn.functional.one_hot(e_idx, E)
    pos_all = torch.cumsum(onehot, dim=1) - 1
    pos = torch.gather(pos_all, 2, e_idx[..., None])[..., 0]
    return gate_w, e_idx, pos, pos < C, C


def _expert(p, e: int):
    """Expert e's leaves: the candidate's when the tree names one for e."""
    over = p.get(EXPERT_OVERRIDE)
    if over is not None and over[0] == e:
        return over[1]
    return {k: p[k][e] for k in ("up", "gate", "down") if k in p}


def moe_ffn(p, cfg: ModelConfig, x):
    """x (B, S, D) -> (B, S, D): the reference's ``moe_ffn``.

    Each kept slot is written to its own (row, expert, position) of a (B,
    E, C, D) buffer (unique positions, no accumulation; dropped slots go to
    a spare position C that is never read), each expert's GEMMs run on its
    C rows, and each slot gathers its output (0 for a dropped slot) for the
    gate-weighted sum over its token's K choices. The experts run one after
    another on their own weight slices, so a candidate for one expert
    (``EXPERT_OVERRIDE``) computes exactly what a stack holding it would.
    """
    B, S, D = x.shape
    K = cfg.moe.top_k
    gate_w, e_idx, pos, keep, C = moe_route(p, cfg, x)
    E = cfg.moe.num_experts
    b_idx = torch.arange(B, device=x.device)[:, None].expand(B, S * K)
    buf = x.new_zeros((B, E, C + 1, D))
    buf[b_idx, e_idx, torch.where(keep, pos, C)] = torch.repeat_interleave(
        x, K, dim=1)
    act = activation_fn(cfg.activation)
    out_buf = x.new_empty((B, E, C, D))
    for e in range(E):
        w = _expert(p, e)
        xe = buf[:, e, :C]
        up = xe @ w["up"]
        h = act(xe @ w["gate"]) * up if cfg.gated_mlp else act(up)
        out_buf[:, e] = h @ w["down"]
    out_slots = out_buf[b_idx, e_idx, torch.clamp(pos, 0, C - 1)] \
        * keep[..., None].to(x.dtype)
    # the gate-weighted sum over the K choices in f32, rounded once: what the
    # reference's bf16 product and sum compile to (XLA keeps the products
    # unrounded inside the reduction)
    return torch.sum(out_slots.float().reshape(B, S, K, D)
                     * gate_w.float()[..., None], dim=2).to(x.dtype)


def moe_aux_loss(p, cfg: ModelConfig, x):
    """Load-balancing auxiliary loss (Switch-style), the reference's."""
    logits = x @ p["router"]
    probs = torch.softmax(logits.float(), dim=-1)
    E = cfg.moe.num_experts
    _, idx = moe_top_k(logits, cfg.moe.top_k)
    frac_tokens = torch.mean(
        torch.nn.functional.one_hot(idx, E).float(), dim=(0, 1, 2))
    frac_probs = torch.mean(probs, dim=(0, 1))
    return E * torch.sum(frac_tokens * frac_probs)
