"""Command-R 35B [dense GQA, no-bias]. Source: hf:CohereForAI/c4ai-command-r-v01.

Field for field the reference's ``repro/configs/command_r_35b.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    n_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    activation="silu",
    gated_mlp=True,
    use_bias=False,
    pos_emb="rope",
    rope_theta=8e6,
    norm="layernorm",
    block_pattern="dense",
    max_seq_len=32768,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
