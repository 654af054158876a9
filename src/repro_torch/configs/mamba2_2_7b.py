"""Mamba2-2.7B [pure SSM / SSD, attention-free]. Source: arXiv:2405.21060.

d_inner = 2*2560 = 5120, head_dim=64 -> 80 SSD heads, d_state=128.

Field for field the reference's ``repro/configs/mamba2_2_7b.py``.
"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    pos_emb="none",
    norm="rmsnorm",
    block_pattern="ssm",
    ssm=SSMConfig(d_state=128, head_dim=64, conv_width=4, expand=2, n_groups=1, chunk=128),
    max_seq_len=524288,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
