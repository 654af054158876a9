"""InternLM2-1.8B [dense GQA]. Source: arXiv:2403.17297 + hf:internlm/internlm2-1_8b.

Field for field the reference's ``repro/configs/internlm2_1_8b.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-1.8b",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=92544,
    activation="silu",
    gated_mlp=True,
    pos_emb="rope",
    norm="rmsnorm",
    block_pattern="dense",
    max_seq_len=32768,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
