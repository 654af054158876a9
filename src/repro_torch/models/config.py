"""Model configuration for the port's dense path.

The fields are the subset of the reference's ``repro.models.config``
``ModelConfig`` that the dense forward reads, with the same names and
defaults; ``reduced()`` derives the same tiny configs the reference's tests
use. Features the port does not carry yet (RoPE, qk-norm, MoE, SSM, hybrid,
encoder-decoder) have no field here; :func:`check_supported` names the
roadmap item for the block patterns that wait.
"""
from __future__ import annotations

import dataclasses

__all__ = ["ModelConfig", "check_supported"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    n_layers: int = 2
    d_model: int = 64
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 256
    vocab_size: int = 512
    head_dim: int = 0                 # 0 => d_model // n_heads
    activation: str = "silu"          # relu | silu | gelu
    gated_mlp: bool = True
    use_bias: bool = False            # biases on mlp / attn out
    attn_qkv_bias: bool = False       # qwen2-style qkv bias
    pos_emb: str = "learned"          # learned | none
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    tie_embeddings: bool = False
    max_seq_len: int = 8192           # for learned positions
    block_pattern: str = "dense"
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    vocab_pad_multiple: int = 256

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family config for CPU tests (the reference's sizes)."""
        base = dict(
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=512,
            head_dim=16 if self.head_dim else 0,
            max_seq_len=256,
            param_dtype="float32",
            compute_dtype="float32",
        )
        base.update(overrides)
        return dataclasses.replace(self, **base)


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for what the port's dense path cannot run."""
    if cfg.block_pattern != "dense":
        raise NotImplementedError(
            f"block_pattern={cfg.block_pattern!r} is not ported yet "
            f"(ROADMAP Queue 1 item 12: other model families)")
    if cfg.pos_emb not in ("learned", "none"):
        raise NotImplementedError(
            f"pos_emb={cfg.pos_emb!r} is not ported yet "
            f"(ROADMAP Queue 1 item 11: other dense features)")
