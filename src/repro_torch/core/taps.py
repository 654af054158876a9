"""Per-linear input capture ("taps") for calibration-based PTQ (GPTQ, AWQ,
OmniQuant).

Re-runs the dense decoder block math with the same ``models.layers``
primitives as the forward, emitting the input activations of every
quantizable linear:

    attn_in  (L, B, S, D)     — input of wq/wk/wv
    attn_mid (L, B, S, Hq·Dh) — input of wo
    mlp_in   (L, B, S, D)     — input of up/gate
    mlp_mid  (L, B, S, F)     — input of down

Dense decoder-only stacks, as in the reference (which asserts it): any
other pattern, and an encoder-decoder stack, raises ``ValueError`` here, so
GPTQ, AWQ and OmniQuant refuse an MoE, SSM, hybrid or encoder-decoder model
before they touch its weights. A vision stack's taps run on text (no
patches), as the reference's do. The layers run one after another
over views of the stacked weights, and each tap is written into a
preallocated (L, ...) tensor, so no stack is copied.
"""
from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig, check_supported
from repro_torch.models.model import dequant_tree, embed_tokens, layer_slice

__all__ = ["capture_dense_taps"]


def capture_dense_taps(params, cfg: ModelConfig, tokens):
    """tokens (B, S) int on the params' device -> dict of the four taps."""
    check_supported(cfg)
    if cfg.block_pattern != "dense":
        raise ValueError(
            f"capture_dense_taps needs block_pattern='dense', got "
            f"{cfg.block_pattern!r}: the calibrated base methods (GPTQ, AWQ, "
            f"OmniQuant) run on dense FFN blocks only, as in the reference")
    if cfg.is_enc_dec:
        raise ValueError(
            f"capture_dense_taps does not cover encoder-decoder stacks "
            f"({cfg.name}: encoder_layers={cfg.encoder_layers}): GPTQ, AWQ "
            f"and OmniQuant refuse them, as in the reference")
    B, S = tokens.shape
    dt = getattr(torch, cfg.compute_dtype)
    positions = torch.arange(S, device=tokens.device)
    h = embed_tokens(params, cfg, tokens, positions)
    width = cfg.n_heads * cfg.resolved_head_dim
    taps = {name: torch.empty((cfg.n_layers, B, S, d), dtype=dt,
                              device=h.device)
            for name, d in (("attn_in", cfg.d_model), ("attn_mid", width),
                            ("mlp_in", cfg.d_model), ("mlp_mid", cfg.d_ff))}
    act = L.activation_fn(cfg.activation)
    for i in range(cfg.n_layers):
        pl = dequant_tree(layer_slice(params["blocks"], i), dt)
        a_in = L.apply_norm(h, pl["ln1"], cfg.norm)
        q, k, v = L.attn_qkv(pl["attn"], cfg, a_in, positions)
        attn = L.blocked_attention(q, k, v, causal=True, chunk=cfg.attn_chunk)
        attn_mid = attn.reshape(B, S, -1)
        a = attn_mid @ pl["attn"]["wo"]
        if "bo" in pl["attn"]:
            a = a + pl["attn"]["bo"]
        h, m_in = L.add_norm(h, a, pl["ln2"], cfg.norm)
        mlp = pl["mlp"]
        up = m_in @ mlp["up"]
        if "b_up" in mlp:
            up = up + mlp["b_up"]
        if cfg.gated_mlp:
            g = m_in @ mlp["gate"]
            if "b_gate" in mlp:
                g = g + mlp["b_gate"]
            mid = act(g) * up
        else:
            mid = act(up)
        out = mid @ mlp["down"]
        if "b_down" in mlp:
            out = out + mlp["b_down"]
        h = h + out
        for name, t in (("attn_in", a_in), ("attn_mid", attn_mid),
                        ("mlp_in", m_in), ("mlp_mid", mid)):
            taps[name][i] = t
    return taps
