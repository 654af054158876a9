"""Dense and MoE models: init / forward / loss / contiguous-cache decode
with the reference's param layout.

Params are plain nested dicts of tensors: stacked ``(L, ...)`` block leaves
under ``params["blocks"]`` and ``x @ W`` orientation, exactly the JAX tree
(``repro_torch.convert.params_from_numpy`` carries a reference tree across
leaf for leaf). The forward is a Python loop over the stacked layers; each
layer reads views ``leaf[i]`` of the stack, so nothing is copied. Any weight
leaf may be a packed ``QTensor``: it is dequantized per layer inside the
loop (``dequant_tree``), so only one layer's dense weights exist at a time.
An MoE block carries ``blocks["moe"]`` (router (L, D, E), experts (L, E,
...)) in place of ``blocks["mlp"]``; a layer's slice of it is (E, ...).
"""
from __future__ import annotations

import torch

from repro_torch.core.quant import QTensor
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig, check_supported

__all__ = ["init_params", "embed_tokens", "lm_head_logits", "forward",
           "lm_loss", "quantizable_paths", "layer_slice", "dequant_tree",
           "init_cache", "decode_step", "prefill", "ffn_sublayer"]


def _dtype(name: str) -> torch.dtype:
    return getattr(torch, name)


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda"):
    """Random init with the reference's shapes and scales
    (``repro.models.model.init_params`` for the dense and MoE patterns). The
    draws do not reproduce ``jax.random``; ``generator`` must live on
    ``device``."""
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
    if cfg.qk_norm:
        attn["q_norm"] = torch.ones((Lyr, hd), dtype=dt, device=dev)
        attn["k_norm"] = torch.ones((Lyr, hd), dtype=dt, device=dev)
    blocks = {"ln1": L.init_norm((Lyr,), D, cfg.norm, dt, dev),
              "attn": attn,
              "ln2": L.init_norm((Lyr,), D, cfg.norm, dt, dev)}
    if cfg.block_pattern == "moe":
        blocks["moe"] = L.init_moe((Lyr,), cfg, normal)
    else:
        mlp = {"up": normal((Lyr, D, F), D ** -0.5),
               "down": normal((Lyr, F, D), F ** -0.5)}
        if cfg.gated_mlp:
            mlp["gate"] = normal((Lyr, D, F), D ** -0.5)
        if cfg.use_bias:
            mlp["b_up"] = zeros((Lyr, F))
            mlp["b_down"] = zeros((Lyr, D))
            if cfg.gated_mlp:
                mlp["b_gate"] = zeros((Lyr, F))
        blocks["mlp"] = mlp
    params = {
        "embed": {"tok": normal((V, D), 0.02)},
        "blocks": blocks,
        "final_norm": L.init_norm((), D, cfg.norm, dt, dev),
    }
    if cfg.pos_emb == "learned":
        params["embed"]["pos"] = normal((cfg.max_seq_len, D), 0.02)
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((D, V), D ** -0.5)
    return params


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked block tree (views, no copies; a stacked
    QTensor gives layer ``i``'s QTensor)."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    return tree[i]


def dequant_tree(tree, dtype=None):
    """Materialise any QTensor leaves (applied to one layer's slice)."""
    if isinstance(tree, dict):
        return {k: dequant_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return tree.dequantize(dtype or torch.float32)
    return tree


def _merge(tree, override):
    out = dict(tree)
    for k, v in override.items():
        out[k] = _merge(tree[k], v) if isinstance(v, dict) else v
    return out


def _dense_body(pl, cfg: ModelConfig, h, positions, cache=None,
                cache_index: int = 0):
    pl = dequant_tree(pl, _dtype(cfg.compute_dtype))
    a_in = L.apply_norm(h, pl["ln1"], cfg.norm)
    a, cache = L.self_attention(pl["attn"], cfg, a_in, positions, cache=cache,
                                cache_index=cache_index)
    h = h + a
    return h + ffn_sublayer(pl, cfg, h), cache


def ffn_sublayer(pl, cfg: ModelConfig, h):
    """The block's FFN on the normed residual: ``moe_ffn`` when the layer's
    tree holds ``"moe"``, else the dense ``mlp``."""
    m_in = L.apply_norm(h, pl["ln2"], cfg.norm)
    if "moe" in pl:
        return L.moe_ffn(pl["moe"], cfg, m_in)
    return L.mlp(pl["mlp"], cfg, m_in)


def embed_tokens(params, cfg: ModelConfig, tokens, positions):
    """Token (+ learned position) embeddings; ``positions`` is (S,) or, for
    per-sequence depths, (B, S)."""
    h = params["embed"]["tok"][tokens]
    if cfg.pos_emb == "learned":
        h = h + params["embed"]["pos"][positions]
    return h.to(_dtype(cfg.compute_dtype))


def lm_head_logits(params, cfg: ModelConfig, h, *, mask_vocab: bool = False):
    """Final norm + (tied or dedicated, possibly QTensor) LM head.
    ``mask_vocab=True`` sets padded-vocab columns to -inf (the serving
    steps' convention before argmax/sampling)."""
    h = L.apply_norm(h, params["final_norm"], cfg.norm)
    head = params["embed"]["tok"].T if cfg.tie_embeddings else params["lm_head"]
    if isinstance(head, QTensor):
        head = head.dequantize(h.dtype)
    logits = h @ head.to(h.dtype)
    V = logits.shape[-1]
    if mask_vocab and V > cfg.vocab_size:
        keep = torch.arange(V, device=logits.device) < cfg.vocab_size
        logits = torch.where(keep, logits, -torch.inf)
    return logits


def forward(params, cfg: ModelConfig, tokens, *, collect_hidden=False,
            layer_override=None):
    """Full-sequence causal forward -> logits (B, S, V_padded), plus the
    (L, B, S, D) per-block outputs when ``collect_hidden``.

    ``layer_override=(i, tree)`` makes layer ``i`` read the leaves of
    ``tree`` (e.g. ``{"mlp": {"up": ..., "down": ...}}``, or for one expert
    ``{"moe": {layers.EXPERT_OVERRIDE: (e, unit)}}``) instead of its slice
    of the stack — the search installs one candidate unit this way without
    copying the stack.
    """
    check_supported(cfg)
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)
    h = embed_tokens(params, cfg, tokens, positions)
    blocks = params["blocks"]
    hidden = []
    for i in range(cfg.n_layers):
        pl = layer_slice(blocks, i)
        if layer_override is not None and layer_override[0] == i:
            pl = _merge(pl, layer_override[1])
        h, _ = _dense_body(pl, cfg, h, positions)
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


# ---------------------------------------------------------------------------
# Decode over a contiguous KV cache
# ---------------------------------------------------------------------------

def _single_kv(cfg: ModelConfig, batch: int, max_len: int, dt, device):
    """One block's empty KV cache (the ``init_cache`` leaf layout without the
    layer axis): (B, max_len, Hkv, hd) K/V in ``dt``, or int8 codes with
    (B, max_len, Hkv) scales in ``dt``."""
    shape = (batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim)
    if cfg.kv_cache_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], dtype=dt, device=device),
                "v_scale": torch.zeros(shape[:-1], dtype=dt, device=device)}
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device="cuda"):
    """Empty contiguous KV cache for every layer: the ``_single_kv`` leaves
    with a leading n_layers axis, on ``device`` (the card unless
    ``device="cpu"``). ``dtype`` defaults to the compute dtype."""
    check_supported(cfg)
    dt = dtype or _dtype(cfg.compute_dtype)
    one = _single_kv(cfg, batch, max_len, dt, resolve_device(device))
    return {k: v[None].repeat((cfg.n_layers,) + (1,) * v.ndim)
            for k, v in one.items()}


def _cached_blocks(params, cfg: ModelConfig, h, positions, cache, index: int):
    for i in range(cfg.n_layers):
        h, _ = _dense_body(layer_slice(params["blocks"], i), cfg, h, positions,
                           cache={k: v[i] for k, v in cache.items()},
                           cache_index=index)
    return h


def decode_step(params, cfg: ModelConfig, tokens, cache, index: int):
    """One decode step. tokens (B, 1) at position ``index`` (a host int);
    returns (logits (B, 1, V), cache).

    Each layer's K/V are written into ``cache`` (the ``init_cache`` tree) IN
    PLACE at ``index`` — the reference returns a new cache; the returned
    cache is the same object. Packed QTensor leaves are dequantized one
    layer at a time, as in the paged step. Every row sits at position
    ``index`` (RoPE included), as in the reference: left-padded rows of a
    batch rotate their pads too.
    """
    check_supported(cfg)
    index = int(index)
    positions = index + torch.arange(1, device=tokens.device)
    h = embed_tokens(params, cfg, tokens, positions)
    h = _cached_blocks(params, cfg, h, positions, cache, index)
    return lm_head_logits(params, cfg, h), cache


def prefill(params, cfg: ModelConfig, tokens, max_len: int):
    """Process a prompt (B, S) into a fresh ``init_cache(cfg, B, max_len)``
    on the tokens' device, written at positions 0..S-1. Returns (logits
    (B, S, V), cache)."""
    check_supported(cfg)
    B, S = tokens.shape
    cache = init_cache(cfg, B, max_len, device=tokens.device)
    positions = torch.arange(S, device=tokens.device)
    h = embed_tokens(params, cfg, tokens, positions)
    h = _cached_blocks(params, cfg, h, positions, cache, 0)
    return lm_head_logits(params, cfg, h), cache


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
