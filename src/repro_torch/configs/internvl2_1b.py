"""InternVL2-1B [VLM]: the Qwen2-0.5B language backbone and a STUB for the
InternViT frontend. Source: arXiv:2404.16821 + hf:OpenGVLab/InternVL2-1B.

The vision tower is a stub: precomputed patch embeddings
(``models/frontends.py::stub_vision_embeds``) are prepended to the token
embeddings. The Qwen2 backbone has attention qkv biases and tied
embeddings; 14 query heads share 2 KV heads (7 a group).

Field for field the reference's ``repro/configs/internvl2_1b.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    n_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    activation="silu",
    gated_mlp=True,
    attn_qkv_bias=True,
    pos_emb="rope",
    rope_theta=1e6,
    norm="rmsnorm",
    block_pattern="dense",
    frontend="vision",
    frontend_len=256,
    tie_embeddings=True,
    max_seq_len=32768,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
