"""The benchmark's weights: a dense decoder's parameter tree, drawn from the
run's seed on the device, one draw per stacked leaf, in the model's type.

The tree has the layout the port's forward and quantisers read (stacked
``(L, ...)`` block leaves under ``blocks``, ``x @ W`` orientation) and the
port's scales (D^-1/2 for the projections into the hidden and FFN widths,
F^-1/2 for down, 0.02 for the embeddings). Norm weights are 1 + 0.05 z and
biases 0.02 z, so the norms' and biases' arithmetic is exercised too.
Both the program and the plain reference read this same tree; the
benchmark makes it, never the program.
"""
from __future__ import annotations

import torch


def make_weights(arch, seed: int, device, dtype):
    gen = torch.Generator(device=device).manual_seed(int(seed))
    L, D, F = arch.n_layers, arch.d_model, arch.d_ff
    H, Hkv, hd = arch.n_heads, arch.n_kv_heads, arch.resolved_head_dim
    V = arch.padded_vocab

    def normal(shape, scale, shift=0.0):
        t = torch.randn(shape, generator=gen, device=device, dtype=dtype)
        t.mul_(scale)
        if shift:
            t.add_(shift)
        return t

    def norm(lead):
        p = {"w": normal(lead + (D,), 0.05, 1.0)}
        if arch.norm == "layernorm":
            p["b"] = normal(lead + (D,), 0.02)
        return p

    attn = {"wq": normal((L, D, H * hd), D ** -0.5),
            "wk": normal((L, D, Hkv * hd), D ** -0.5),
            "wv": normal((L, D, Hkv * hd), D ** -0.5),
            "wo": normal((L, H * hd, D), (H * hd) ** -0.5)}
    mlp = {"up": normal((L, D, F), D ** -0.5),
           "down": normal((L, F, D), F ** -0.5)}
    if arch.gated_mlp:
        mlp["gate"] = normal((L, D, F), D ** -0.5)
    if arch.use_bias:
        attn.update(bq=normal((L, H * hd), 0.02), bk=normal((L, Hkv * hd), 0.02),
                    bv=normal((L, Hkv * hd), 0.02), bo=normal((L, D), 0.02))
        mlp.update(b_up=normal((L, F), 0.02), b_down=normal((L, D), 0.02))
        if arch.gated_mlp:
            mlp["b_gate"] = normal((L, F), 0.02)
    if arch.qk_norm:
        attn["q_norm"] = normal((L, hd), 0.05, 1.0)
        attn["k_norm"] = normal((L, hd), 0.05, 1.0)
    params = {"embed": {"tok": normal((V, D), 0.02)},
              "blocks": {"ln1": norm((L,)), "attn": attn, "ln2": norm((L,)),
                         "mlp": mlp},
              "final_norm": norm(())}
    if arch.pos_emb == "learned":
        params["embed"]["pos"] = normal((arch.max_seq_len, D), 0.02)
    params["lm_head"] = normal((D, V), D ** -0.5)
    return params


def layer(params, i: int):
    """Layer ``i``'s leaves (views) from the stacked ``blocks``."""
    def take(t):
        return {k: take(v) for k, v in t.items()} if isinstance(t, dict) \
            else t[i]
    return take(params["blocks"])
