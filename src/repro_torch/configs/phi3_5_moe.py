"""Phi-3.5-MoE (42B total / 6.6B active) [MoE 16e top-2].

Source: hf:microsoft/Phi-3.5-MoE-instruct. head_dim=128 (32*128=4096).

Field for field the reference's ``repro/configs/phi3_5_moe.py``.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6400,
    vocab_size=32064,
    activation="silu",
    gated_mlp=True,
    pos_emb="rope",
    norm="layernorm",
    block_pattern="moe",
    moe=MoEConfig(num_experts=16, top_k=2, capacity_factor=1.25),
    max_seq_len=32768,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
