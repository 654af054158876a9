"""Qwen3-4B [dense GQA, qk-norm]. Source: hf:Qwen/Qwen3-4B (family per Qwen/Qwen3-8B).

head_dim=128 (q proj 2560 -> 32*128=4096).

Field for field the reference's ``repro/configs/qwen3_4b.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    activation="silu",
    gated_mlp=True,
    qk_norm=True,
    pos_emb="rope",
    rope_theta=1e6,
    norm="rmsnorm",
    block_pattern="dense",
    max_seq_len=32768,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
