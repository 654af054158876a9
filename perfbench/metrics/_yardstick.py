"""The benchmark's yardstick: the card's peaks, and the operations and bytes
the measured work needs, computed from shapes.

Frozen copies of ``chip_smoke.py``'s ``bound_ms``, ``tq_bytes``,
``dense_param_count`` and ``forward_flops`` (with the helpers they use), so that the numbers the benchmark holds a change to
cannot move with the program. ``arch`` is any object with the model's
sizes as attributes (``perfbench.harness.Arch``, or the port's
``ModelConfig``).
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates without sparsity; they assume the
# full 700 W power limit, so every share is reported beside the card's limit
HBM_BYTES_PER_S = 3.35e12      # 80 GB HBM3
FP32_OPS_PER_S = 67e12         # fp32 outside the tensor cores (TF32 off)
BF16_OPS_PER_S = 989e12        # bf16 tensor cores
PEAK_OPS_PER_S = {"float32": FP32_OPS_PER_S, "bfloat16": BF16_OPS_PER_S}


def bound_ms(nbytes, nops):
    """The least time the card could take: (ms, "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def tq_bytes(K, N, group, f, elem=4):
    """Bytes transform_quant must move: w read and fq written once
    (``elem`` bytes a value), scale and zero written (f32), pi (int64), s,
    cos and sin read once."""
    return 2 * K * N * elem + 2 * (K // group) * N * 4 + f * (8 + 4) + f * 4


def tq_bytes_per_proposal(arch, group, elem):
    """One fused candidate build of a dense FFN unit: "up" over (D, F), the
    gate (permuted only, same kernel) where the FFN is gated, "down" over
    (F, D)."""
    D, F = arch.d_model, arch.d_ff
    n_up = 2 if arch.gated_mlp else 1
    return n_up * tq_bytes(D, F, group, F, elem) + tq_bytes(F, D, group, F,
                                                            elem)


def dense_parts(arch):
    """(attention, FFN, norm) parameters of one dense block."""
    D, F = arch.d_model, arch.d_ff
    hd, hq, hkv = arch.resolved_head_dim, arch.n_heads, arch.n_kv_heads
    attn = 2 * D * hq * hd + 2 * D * hkv * hd
    if arch.use_bias:
        attn += (hq + 2 * hkv) * hd + D
    if arch.qk_norm:
        attn += 2 * hd
    n_ffn = 2 + int(arch.gated_mlp)
    mlp = n_ffn * D * F + ((n_ffn - 1) * F + D if arch.use_bias else 0)
    return attn, mlp, D * (2 if arch.norm == "layernorm" else 1)


def dense_param_count(arch) -> int:
    """Parameters of a dense model's tree."""
    D, V = arch.d_model, arch.padded_vocab
    attn, mlp, norm = dense_parts(arch)
    n = arch.n_layers * (attn + mlp + 2 * norm) + norm + V * D
    if arch.pos_emb == "learned":
        n += arch.max_seq_len * D
    if not arch.tie_embeddings:
        n += D * V
    return n


def matmul_params(arch) -> int:
    """Weights a forward multiplies by: every block's projections and the
    LM head (the token embedding is a lookup)."""
    D, F = arch.d_model, arch.d_ff
    hd, hq, hkv = arch.resolved_head_dim, arch.n_heads, arch.n_kv_heads
    per_layer = 2 * D * hq * hd + 2 * D * hkv * hd \
        + (2 + int(arch.gated_mlp)) * D * F
    return arch.n_layers * per_layer + D * arch.padded_vocab


def forward_flops(arch, B, S) -> int:
    """Operations of one forward over (B, S) tokens: 2 per weight per token,
    and causal attention's QK^T and PV over the S(S+1)/2 pairs a head."""
    return 2 * matmul_params(arch) * B * S + 2 * 2 * arch.n_layers * B \
        * (S * (S + 1) // 2) * arch.n_heads * arch.resolved_head_dim
