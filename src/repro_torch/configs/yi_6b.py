"""Yi-6B [dense GQA, llama-arch]. Source: arXiv:2403.04652 + hf:01-ai/Yi-6B.

Field for field the reference's ``repro/configs/yi_6b.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    activation="silu",
    gated_mlp=True,
    pos_emb="rope",
    rope_theta=5e6,
    norm="rmsnorm",
    block_pattern="dense",
    max_seq_len=32768,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
