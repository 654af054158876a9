"""Dense building blocks: norms, activation, RoPE, self-attention, MLP.

Plain functions on tensors with the reference's layout (``x @ W``
orientation, (B, S, H, Dh) heads). RoPE and qk-norm are plain PyTorch, as
they are jnp in the reference. Attention is the reference's
``blocked_attention`` online softmax in plain PyTorch (jnp there, not a
Pallas kernel), except one-token decode over a contiguous cache with
``cfg.use_flash_decode``, which takes the ``flash_decode`` kernel.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.models.config import ModelConfig

__all__ = ["NEG_INF", "rmsnorm", "layernorm", "apply_norm", "init_norm",
           "activation_fn", "rope_cos_sin", "apply_rope", "attn_qkv",
           "attn_out", "blocked_attention", "self_attention", "mlp",
           "quantize_kv"]

NEG_INF = -1e30


def rmsnorm(x, w, eps=1e-6):
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * w


def layernorm(x, w, b, eps=1e-5):
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * w + b


def apply_norm(x, p, kind):
    if kind == "layernorm":
        return layernorm(x, p["w"], p["b"])
    return rmsnorm(x, p["w"])


def init_norm(lead, d, kind, dtype, device):
    """Norm params with leading stack dims ``lead`` (a tuple)."""
    p = {"w": torch.ones(lead + (d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["b"] = torch.zeros(lead + (d,), dtype=dtype, device=device)
    return p


def _gelu_tanh(x):
    # jax.nn.gelu defaults to the tanh approximation
    return torch.nn.functional.gelu(x, approximate="tanh")


def activation_fn(name):
    return {"relu": torch.relu, "silu": torch.nn.functional.silu,
            "gelu": _gelu_tanh}[name]


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
    """positions: (..., S) int -> cos/sin (..., S, head_dim // 2) f32."""
    inv = _rope_inv_freq(head_dim, float(theta), positions.device)
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
                      v_scale=None):
    """q: (B, Sq, Hq, Dh); k/v: (B, Sk, Hkv, Dh) -> (B, Sq, Hq, Dh).

    The reference's online-softmax (flash-attention recurrence) over KV
    chunks of ``chunk`` positions, in fp32: ``q_offset`` is the absolute
    position of q[0] (decode), keys at or past ``kv_len`` are masked, and
    int8 caches come with (B, Sk, Hkv) ``k_scale``/``v_scale``, dequantised
    per chunk. Query head h reads KV head h // (Hq // Hkv). The port's
    ``kv_len`` is a host integer, so the keys past it are sliced off before
    the chunking (the reference masks whole chunks of them; a fully masked
    chunk leaves (m, l, acc) unchanged, so the result is the same).
    """
    B, Sq, Hq, Dh = q.shape
    if kv_len is not None and kv_len < k.shape[1]:
        k, v = k[:, :kv_len], v[:, :kv_len]
        if k_scale is not None:
            k_scale, v_scale = k_scale[:, :kv_len], v_scale[:, :kv_len]
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    dev = q.device
    # (B, Hkv, rep, Sq, Dh), pre-scaled as the reference does
    qg = (q.float() * Dh ** -0.5).reshape(B, Sq, Hkv, rep, Dh).permute(
        0, 2, 3, 1, 4)
    q_pos = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, Hkv, rep, Sq), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, Hkv, rep, Sq), dtype=torch.float32,  # noqa: E741
                    device=dev)
    acc = torch.zeros((B, Hkv, rep, Sq, Dh), dtype=torch.float32, device=dev)
    chunk = max(min(chunk, Sk), 1)
    for start in range(0, Sk, chunk):
        kb = k[:, start:start + chunk].float()              # (B, C, Hkv, Dh)
        vb = v[:, start:start + chunk].float()
        if k_scale is not None:
            kb = kb * k_scale[:, start:start + chunk, :, None].float()
            vb = vb * v_scale[:, start:start + chunk, :, None].float()
        kb = kb.permute(0, 2, 1, 3)[:, :, None]             # (B, Hkv, 1, C, Dh)
        vb = vb.permute(0, 2, 1, 3)[:, :, None]
        s = qg @ kb.transpose(-1, -2)                       # (B, Hkv, rep, Sq, C)
        if causal:
            k_pos = start + torch.arange(kb.shape[3], device=dev)
            mask = q_pos[:, None] >= k_pos[None, :]         # (Sq, C)
            s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        if causal:
            p = torch.where(mask, p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)  # noqa: E741
        acc = acc * corr[..., None] + p @ vb
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
    if cache is None:
        out = blocked_attention(q, k, v, causal=causal, chunk=cfg.attn_chunk)
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
                                chunk=cfg.attn_chunk,
                                k_scale=cache.get("k_scale"),
                                v_scale=cache.get("v_scale"))
    return attn_out(p, out), cache


def _flash_decode_step(q, cache, kv_len: int):
    """A single decode token through ``kernels.flash_decode`` (the CUDA
    kernel for a CUDA tensor): GQA query heads read their KV head in the
    kernel (no repeated cache), int8 caches are dequantised there."""
    from repro_torch.kernels import flash_decode
    out = flash_decode(q[:, 0], cache["k"], cache["v"], cache.get("k_scale"),
                       cache.get("v_scale"), kv_len=kv_len)
    return out[:, None].to(q.dtype)


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
