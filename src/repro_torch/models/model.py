"""Dense model: init / forward / loss with the reference's param layout.

Params are plain nested dicts of tensors: stacked ``(L, ...)`` block leaves
under ``params["blocks"]`` and ``x @ W`` orientation, exactly the JAX tree
(``repro_torch.convert.params_from_numpy`` carries a reference tree across
leaf for leaf). The forward is a Python loop over the stacked layers; each
layer reads views ``leaf[i]`` of the stack, so nothing is copied.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig, check_supported

__all__ = ["init_params", "embed_tokens", "lm_head_logits", "forward",
           "lm_loss", "quantizable_paths", "layer_slice"]


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    """Random init with the reference's shapes and scales
    (``repro.models.model.init_params`` for the dense pattern). The draws do
    not reproduce ``jax.random``; ``generator`` must live on ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg.param_dtype)
    V, D, F, Lyr = cfg.padded_vocab, cfg.d_model, cfg.d_ff, cfg.n_layers
    hd = cfg.resolved_head_dim
    hq, hkv = cfg.n_heads, cfg.n_kv_heads

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, dtype=dt,
                           device=dev) * scale

    def zeros(shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    attn = {
        "wq": normal((Lyr, D, hq * hd), D ** -0.5),
        "wk": normal((Lyr, D, hkv * hd), D ** -0.5),
        "wv": normal((Lyr, D, hkv * hd), D ** -0.5),
        "wo": normal((Lyr, hq * hd, D), (hq * hd) ** -0.5),
    }
    if cfg.attn_qkv_bias or cfg.use_bias:
        attn["bq"] = zeros((Lyr, hq * hd))
        attn["bk"] = zeros((Lyr, hkv * hd))
        attn["bv"] = zeros((Lyr, hkv * hd))
    if cfg.use_bias:
        attn["bo"] = zeros((Lyr, D))
    mlp = {"up": normal((Lyr, D, F), D ** -0.5),
           "down": normal((Lyr, F, D), F ** -0.5)}
    if cfg.gated_mlp:
        mlp["gate"] = normal((Lyr, D, F), D ** -0.5)
    if cfg.use_bias:
        mlp["b_up"] = zeros((Lyr, F))
        mlp["b_down"] = zeros((Lyr, D))
        if cfg.gated_mlp:
            mlp["b_gate"] = zeros((Lyr, F))
    params = {
        "embed": {"tok": normal((V, D), 0.02)},
        "blocks": {"ln1": L.init_norm((Lyr,), D, cfg.norm, dt, dev),
                   "attn": attn,
                   "ln2": L.init_norm((Lyr,), D, cfg.norm, dt, dev),
                   "mlp": mlp},
        "final_norm": L.init_norm((), D, cfg.norm, dt, dev),
    }
    if cfg.pos_emb == "learned":
        params["embed"]["pos"] = normal((cfg.max_seq_len, D), 0.02)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((D, V), D ** -0.5)
    return params


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked block tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def _merge(tree, override):
    out = dict(tree)
    for k, v in override.items():
        out[k] = _merge(tree[k], v) if isinstance(v, dict) else v
    return out


def _dense_body(pl, cfg: ModelConfig, h):
    a_in = L.apply_norm(h, pl["ln1"], cfg.norm)
    h = h + L.self_attention(pl["attn"], cfg, a_in)
    m_in = L.apply_norm(h, pl["ln2"], cfg.norm)
    return h + L.mlp(pl["mlp"], cfg, m_in)


def embed_tokens(params, cfg: ModelConfig, tokens, positions):
    h = params["embed"]["tok"][tokens]
    if cfg.pos_emb == "learned":
        h = h + params["embed"]["pos"][positions]
    return h.to(_dtype(cfg.compute_dtype))


def lm_head_logits(params, cfg: ModelConfig, h):
    """Final norm + (tied or dedicated) LM head."""
    h = L.apply_norm(h, params["final_norm"], cfg.norm)
    head = params["embed"]["tok"].T if cfg.tie_embeddings else params["lm_head"]
    return h @ head.to(h.dtype)


def forward(params, cfg: ModelConfig, tokens, *, collect_hidden=False,
            layer_override=None):
    """Full-sequence causal forward -> logits (B, S, V_padded), plus the
    (L, B, S, D) per-block outputs when ``collect_hidden``.

    ``layer_override=(i, tree)`` makes layer ``i`` read the leaves of
    ``tree`` (e.g. ``{"mlp": {"up": ..., "down": ...}}``) instead of its
    slice of the stack — the search installs one candidate unit this way
    without copying the stack.
    """
    check_supported(cfg)
    B, S = tokens.shape
    h = embed_tokens(params, cfg, tokens, torch.arange(S, device=tokens.device))
    blocks = params["blocks"]
    hidden = []
    for i in range(cfg.n_layers):
        pl = layer_slice(blocks, i)
        if layer_override is not None and layer_override[0] == i:
            pl = _merge(pl, layer_override[1])
        h = _dense_body(pl, cfg, h)
        if collect_hidden:
            hidden.append(h)
    logits = lm_head_logits(params, cfg, h)
    if collect_hidden:
        return logits, torch.stack(hidden)
    return logits


def lm_loss(logits, labels, vocab_size: int, ignore_id: int = -1):
    """Mean next-token CE; positions with label == ignore_id are masked;
    padded vocab ids are masked out of the softmax."""
    V = logits.shape[-1]
    if V > vocab_size:
        keep = torch.arange(V, device=logits.device) < vocab_size
        logits = torch.where(keep, logits, L.NEG_INF)
    logp = torch.log_softmax(logits.float(), dim=-1)
    valid = labels != ignore_id
    safe = torch.where(valid, labels, 0).long()
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.sum(nll * valid) / torch.clamp_min(torch.sum(valid), 1)


_QUANT_KEYS = ("wq", "wk", "wv", "wo", "up", "gate", "down", "w_z", "w_x", "out_proj")
_SKIP_SUBSTR = ("embed", "ln", "norm", "router", "conv", "bias")


def quantizable_paths(params) -> list:
    """Paths (tuples of keys) of weight leaves the PTQ methods quantize."""
    out = []

    def walk(tree, path):
        if isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, path + (k,))
            return
        key = path[-1]
        if key in _QUANT_KEYS and not any(s in str(p) for p in path for s in _SKIP_SUBSTR):
            if hasattr(tree, "ndim") and tree.ndim >= 2:
                out.append(path)

    walk(params, ())
    return out
