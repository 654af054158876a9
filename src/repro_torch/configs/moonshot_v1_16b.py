"""Moonlight-16B-A3B (moonshot-v1-16b-a3b) [MoE 64e top-6].

Source: hf:moonshotai/Moonlight-16B-A3B (DeepSeek-V3-style fine-grained MoE).

Field for field the reference's ``repro/configs/moonshot_v1_16b.py``.
"""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    activation="silu",
    gated_mlp=True,
    pos_emb="rope",
    rope_theta=5e4,
    norm="rmsnorm",
    block_pattern="moe",
    moe=MoEConfig(num_experts=64, top_k=6, capacity_factor=1.25),
    max_seq_len=32768,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
