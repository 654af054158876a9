"""Dense building blocks: norms, activation, causal self-attention, MLP.

Plain functions on tensors with the reference's layout (``x @ W``
orientation, (B, S, H, Dh) heads). Attention is plain tensor ops — scores,
masked softmax in fp32, then ``@ v`` — the single-chunk case of the
reference's ``blocked_attention`` online softmax, which is jnp there and not
a Pallas kernel.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig

__all__ = ["NEG_INF", "rmsnorm", "layernorm", "apply_norm", "init_norm",
           "activation_fn", "attn_qkv", "attn_out", "causal_attention",
           "self_attention", "mlp", "quantize_kv"]

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


def attn_qkv(p, cfg: ModelConfig, x):
    """Project. Returns q, k, v as (B, S, H, Dh)."""
    B, S, _ = x.shape
    hd = cfg.resolved_head_dim
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, S, cfg.n_heads, hd),
            k.reshape(B, S, cfg.n_kv_heads, hd),
            v.reshape(B, S, cfg.n_kv_heads, hd))


def attn_out(p, x_attn):
    B, S = x_attn.shape[:2]
    out = x_attn.reshape(B, S, -1) @ p["wo"]
    if "bo" in p:
        out = out + p["bo"]
    return out


def causal_attention(q, k, v):
    """q: (B, S, Hq, Dh); k/v: (B, S, Hkv, Dh) -> (B, S, Hq, Dh).

    Query head h reads KV head h // (Hq // Hkv), the reference's grouping.
    Softmax in fp32 with the reference's order: scores of the pre-scaled q,
    masked max, exp, masked sum, ``(p @ v) / l``.
    """
    B, S, Hq, Dh = q.shape
    rep = Hq // k.shape[2]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    qh = (q.float() * Dh ** -0.5).transpose(1, 2)        # (B, H, S, Dh)
    kh = k.float().transpose(1, 2)
    vh = v.float().transpose(1, 2)
    s = qh @ kh.transpose(-1, -2)                        # (B, H, S, S)
    pos = torch.arange(S, device=q.device)
    mask = pos[:, None] >= pos[None, :]
    s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), torch.zeros((), device=q.device))
    l = torch.sum(p, dim=-1, keepdim=True)  # noqa: E741 — softmax (m, l)
    out = (p @ vh) / torch.clamp_min(l, 1e-30)
    return out.transpose(1, 2).to(q.dtype)


def self_attention(p, cfg: ModelConfig, x):
    """Causal self-attention block body (no norm / residual)."""
    q, k, v = attn_qkv(p, cfg, x)
    return attn_out(p, causal_attention(q, k, v))


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
