"""Zamba2-7B [hybrid] — Mamba2 blocks + shared attention block.

Source: arXiv:2411.15242 (Zamba2 suite). 81 blocks, d_model=3584, 32 heads
(kv=32), shared transformer block every 6th position, Mamba2 ssm_state=64.

Field for field the reference's ``repro/configs/zamba2_7b.py``.
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    activation="silu",
    gated_mlp=True,
    pos_emb="rope",
    norm="rmsnorm",
    block_pattern="hybrid",
    hybrid_period=6,
    ssm=SSMConfig(d_state=64, head_dim=64, conv_width=4, expand=2, n_groups=1, chunk=128),
    max_seq_len=524288,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
