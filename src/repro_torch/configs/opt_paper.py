"""OPT family (the paper's own models, Zhang et al. 2022): ReLU FFN, learned
positions, LayerNorm, MHA, biases everywhere — the arch where the paper's
scaling invariance is EXACT. Same sizes as the reference's
``repro/configs/opt_paper.py``.
"""
from repro_torch.models.config import ModelConfig

_SIZES = {
    # n_layers, d_model, n_heads, d_ff
    "opt-125m": (12, 768, 12, 3072),
    "opt-1.3b": (24, 2048, 32, 8192),
    "opt-13b": (40, 5120, 40, 20480),
    "opt-tiny": (4, 128, 4, 512),
}


def config(arch: str = "opt-1.3b") -> ModelConfig:
    L, d, h, f = _SIZES[arch]
    return ModelConfig(
        name=arch,
        n_layers=L,
        d_model=d,
        n_heads=h,
        n_kv_heads=h,
        d_ff=f,
        vocab_size=50272 if arch != "opt-tiny" else 512,
        activation="relu",
        gated_mlp=False,
        use_bias=True,
        pos_emb="learned",
        norm="layernorm",
        block_pattern="dense",
        max_seq_len=2048 if arch != "opt-tiny" else 512,
        vocab_pad_multiple=16,
    )
