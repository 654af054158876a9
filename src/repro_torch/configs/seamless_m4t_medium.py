"""SeamlessM4T-medium [audio enc-dec]. Source: arXiv:2308.11596.

Text enc-dec backbone: 12 encoder + 12 decoder layers, d=1024, 16 heads,
ReLU FFN, LayerNorm, learned positions on the decoder tokens (sinusoidal in
the original). The speech frontend is a STUB: precomputed frame embeddings
(``models/frontends.py::stub_audio_frames``) feed the encoder. ReLU makes
the paper's scaling invariance exact for this arch.

Field for field the reference's ``repro/configs/seamless_m4t_medium.py``.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    n_layers=12,
    encoder_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    activation="relu",
    gated_mlp=False,
    use_bias=True,
    pos_emb="learned",
    norm="layernorm",
    block_pattern="dense",
    frontend="audio",
    frontend_len=4096,
    max_seq_len=32768,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
