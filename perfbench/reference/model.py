"""Plain float32 forward of the two dense decoder families the benchmark
runs, written from their published descriptions:

- OPT (Zhang et al., arXiv:2205.01068): learned positions added to the token
  embedding, pre-LayerNorm blocks (eps 1e-5), multi-head attention and a
  ReLU FFN, all projections with biases, a final LayerNorm;
- Qwen3 (hf:Qwen/Qwen3-4B): RMSNorm (eps 1e-6), grouped-query attention
  with RMSNorm on each query and key head before rotary embeddings (the two
  halves of a head rotated, base ``rope_theta``), a SwiGLU FFN
  (silu(x W_gate) * (x W_up)) W_down, no biases.

Two departures, both the benchmark configuration's own (its file lists
them): OPT's positions start at 0 (the published model offsets them by 2),
and the LM head is a matrix of its own where the published models tie it
to the embedding.

Weights are the benchmark's own tree (``perfbench.weights``); a layer's
leaves come from ``layer(i)`` in float32, quantised or not as the caller
decides. Every product, the attention's QK^T and PV included, goes through
``lowp.matmul`` in ``precision``, and the residual stream through
``lowp.activation`` after the embedding and each sublayer; the norms and the
softmax are float32 arithmetic. No cache, no kernels, no batching beyond
the (B, S) block handed in.
"""
from __future__ import annotations

import torch

from perfbench.reference.lowp import activation, matmul

NEG = float("-inf")


def _norm(x, p, kind):
    if kind == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + 1e-5) * p["w"] + p["b"]
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * p["w"]


def _rms(x, w):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + 1e-6) * w


def _rope(x, pos, theta):
    """x (B, S, H, Dh); rotate the halves of Dh by angle pos · θ^(-2i/Dh)."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, device=x.device,
                                        dtype=torch.float64) / hd))
    ang = pos.double()[:, None] * inv[None, :]
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _linear(x, w, b, precision):
    y = matmul(x, w, precision)
    return y + b if b is not None else y


def attention(a, x, pos, arch, precision):
    B, S, _ = x.shape
    H, Hkv, hd = arch.n_heads, arch.n_kv_heads, arch.resolved_head_dim
    q = _linear(x, a["wq"], a.get("bq"), precision).reshape(B, S, H, hd)
    k = _linear(x, a["wk"], a.get("bk"), precision).reshape(B, S, Hkv, hd)
    v = _linear(x, a["wv"], a.get("bv"), precision).reshape(B, S, Hkv, hd)
    if arch.qk_norm:
        q, k = _rms(q, a["q_norm"]), _rms(k, a["k_norm"])
    if arch.pos_emb == "rope":
        q, k = _rope(q, pos, arch.rope_theta), _rope(k, pos, arch.rope_theta)
    rep = H // Hkv
    q = q.permute(0, 2, 1, 3)                                   # (B, H, S, hd)
    k = k.permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)
    v = v.permute(0, 2, 1, 3).repeat_interleave(rep, dim=1)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    out = torch.empty_like(q)
    for h in range(0, H, 8):       # a few heads at a time bounds the scores
        sc = matmul(q[:, h:h + 8], k[:, h:h + 8].transpose(-1, -2),
                    precision) * hd ** -0.5
        sc = sc.masked_fill(~causal, NEG)
        out[:, h:h + 8] = matmul(torch.softmax(sc, dim=-1), v[:, h:h + 8],
                                 precision)
    out = out.permute(0, 2, 1, 3).reshape(B, S, H * hd)
    return _linear(out, a["wo"], a.get("bo"), precision)


def ffn(m, x, arch, precision):
    up = _linear(x, m["up"], m.get("b_up"), precision)
    if arch.gated_mlp:
        g = _linear(x, m["gate"], m.get("b_gate"), precision)
        h = torch.nn.functional.silu(g) * up
    elif arch.activation == "relu":
        h = torch.relu(up)
    else:
        raise ValueError(f"activation {arch.activation!r} not in the reference")
    return _linear(h, m["down"], m.get("b_down"), precision)


def embed(params, arch, tokens, pos):
    h = params["embed"]["tok"][tokens].float()
    if arch.pos_emb == "learned":
        h = h + params["embed"]["pos"][pos].float()
    return h


def block(lp, h, pos, arch, precision):
    h = activation(h + attention(lp["attn"], _norm(h, lp["ln1"], arch.norm),
                                 pos, arch, precision), precision)
    return activation(h + ffn(lp["mlp"], _norm(h, lp["ln2"], arch.norm), arch,
                              precision), precision)


def head(params, arch, h, precision):
    """Final norm and LM head: float32 logits over the padded vocabulary,
    the padding set to -inf."""
    fn = {k: v.float() for k, v in params["final_norm"].items()}
    logits = matmul(_norm(h, fn, arch.norm), params["lm_head"].float(),
                    precision)
    V = logits.shape[-1]
    if V > arch.vocab_size:
        logits[..., arch.vocab_size:] = NEG
    return logits


def forward(params, arch, layer, tokens, *, n_taps: int = 0,
            precision: str = "float32"):
    """tokens (B, S) -> (logits (B, S, V_padded) float32, the first
    ``n_taps`` block outputs (n_taps, B, S, D))."""
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    h = activation(embed(params, arch, tokens, pos), precision)
    taps = []
    for i in range(arch.n_layers):
        h = block(layer(i), h, pos, arch, precision)
        if i < n_taps:
            taps.append(h)
    return head(params, arch, h, precision), (torch.stack(taps) if taps
                                              else None)


def lm_ce(logits, tokens):
    """Mean next-token cross-entropy (padding columns already -inf)."""
    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    return -lp.gather(-1, tokens[:, 1:, None].long())[..., 0].mean()
