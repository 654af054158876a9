"""Model configuration for the port's dense, encoder-decoder, vision, MoE,
SSM and hybrid paths.

The fields are the subset of the reference's ``repro.models.config``
``ModelConfig`` that these forwards read, with the same names, order and
defaults; ``reduced()`` derives the same tiny configs the reference's tests
use. Every block pattern of the reference runs: dense (with an encoder
stack and cross-attention when ``encoder_layers > 0``, and stub vision /
audio front ends), MoE, SSM and hybrid; :func:`check_supported` refuses a
pattern outside these and a family config without its sub-config.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

__all__ = ["MoEConfig", "SSMConfig", "ModelConfig", "check_supported"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25

    def capacity(self, seq_len: int) -> int:
        """Per-batch-row expert capacity (the reference's, on Python
        floats): slots each expert takes from one row of ``seq_len``
        tokens."""
        c = math.ceil(seq_len * self.top_k / self.num_experts * self.capacity_factor)
        return max(1, c)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD block shape (the reference's ``SSMConfig``)."""

    d_state: int = 128
    head_dim: int = 64
    conv_width: int = 4
    expand: int = 2
    n_groups: int = 1
    chunk: int = 128

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


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
    qk_norm: bool = False
    use_bias: bool = False            # biases on mlp / attn out
    attn_qkv_bias: bool = False       # qwen2-style qkv bias
    pos_emb: str = "rope"             # rope | learned | none
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    tie_embeddings: bool = False
    max_seq_len: int = 8192           # for learned positions
    block_pattern: str = "dense"      # dense | moe | ssm | hybrid
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid_period: int = 6            # hybrid: every Nth block = shared attn+mlp
    encoder_layers: int = 0           # >0 => encoder-decoder
    frontend: str = "none"            # none | vision | audio (stub embeddings)
    frontend_len: int = 0             # patches / frames prepended (vlm) or enc len
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    attn_chunk: int = 1024            # kv-chunk for blocked online-softmax attention
    vocab_pad_multiple: int = 256
    attn_softmax_dtype: str = "float32"   # float32 | bfloat16 score pipeline
                                          # of blocked_attention
    gqa_repeat_kv: bool = False       # repeat KV to the query heads before
                                      # blocked_attention
    kv_cache_dtype: str = "compute"   # compute | int8 (absmax-scaled KV cache)
    use_flash_decode: bool = False    # route 1-token decode attention over the
                                      # contiguous cache through the CUDA
                                      # flash_decode kernel

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // max(self.n_heads, 1)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attn_free(self) -> bool:
        return self.block_pattern == "ssm"

    def hybrid_layout(self) -> Tuple[int, int]:
        """(n_mamba_blocks, n_attn_applications) for hybrid stacks: block
        i in [0, n_layers) is an application of the shared attention block
        iff i % period == period - 1."""
        n_attn = self.n_layers // self.hybrid_period
        return self.n_layers - n_attn, n_attn

    def _attn_mlp_params(self):
        d, f = self.d_model, self.d_ff
        hd = self.resolved_head_dim
        attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) + (self.n_heads * hd) * d
        mlp = d * f + f * d + (d * f if self.gated_mlp else 0)
        return attn, mlp

    def param_count(self) -> int:
        """The reference's analytic parameter count (the embedding once if
        tied; 2·d a dense block for its norms; one shared dense block in a
        hybrid stack; an encoder-decoder stack adds its encoder blocks, with
        4·d² attention whatever the head layout, and each decoder block's
        cross-attention and its norm, as the reference counts them)."""
        check_supported(self)
        d, v = self.d_model, self.padded_vocab
        attn, mlp = self._attn_mlp_params()
        if self.block_pattern == "dense":
            n = self.n_layers * (attn + mlp + 2 * d)
        elif self.block_pattern == "moe":
            e = self.moe.num_experts
            n = self.n_layers * (attn + e * mlp + d * e + 2 * d)
        elif self.block_pattern == "ssm":
            n = self.n_layers * self._ssm_block_params()
        else:
            n_m, _ = self.hybrid_layout()
            n = n_m * self._ssm_block_params() + attn + mlp + 2 * d
        if self.is_enc_dec:
            f = self.d_ff
            n += self.encoder_layers * (4 * d * d + 2 * d * f + 2 * d)
            n += self.n_layers * (attn + 2 * d)    # cross-attention blocks
        n += v * d * (1 if self.tie_embeddings else 2)
        if self.pos_emb == "learned":
            n += self.max_seq_len * d
        return n

    def active_param_count(self) -> int:
        """Activated params per token (= param_count for non-MoE)."""
        if self.block_pattern != "moe":
            return self.param_count()
        attn, mlp = self._attn_mlp_params()
        d = self.d_model
        act = self.n_layers * (attn + self.moe.top_k * mlp + d * self.moe.num_experts + 2 * d)
        act += self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        return act

    def _ssm_block_params(self) -> int:
        d = self.d_model
        s = self.ssm
        di = s.d_inner(d)
        h = s.n_heads(d)
        g = s.n_groups
        in_proj = d * (2 * di + 2 * g * s.d_state + h)
        conv = s.conv_width * (di + 2 * g * s.d_state)
        out_proj = di * d
        return in_proj + conv + out_proj + 3 * h + di + d

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family config for CPU tests (the reference's sizes; a
        hybrid stack keeps one group and a tail block; at most 2 encoder
        layers, 8 frontend positions)."""
        base = dict(
            n_layers=min(self.n_layers,
                         2 if self.block_pattern != "hybrid"
                         else self.hybrid_period + 1),
            d_model=64,
            n_heads=min(self.n_heads, 4) if self.n_heads else 0,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=512,
            head_dim=16 if self.head_dim else 0,
            max_seq_len=256,
            frontend_len=8 if self.frontend != "none" else 0,
            encoder_layers=min(self.encoder_layers, 2),
            moe=dataclasses.replace(self.moe, num_experts=4, top_k=2) if self.moe else None,
            ssm=(dataclasses.replace(self.ssm, d_state=16, head_dim=16,
                                     chunk=32) if self.ssm else None),
            attn_chunk=64,
            param_dtype="float32",
            compute_dtype="float32",
        )
        base.update(overrides)
        return dataclasses.replace(self, **base)


def check_supported(cfg: ModelConfig) -> None:
    """Raise ValueError for a block pattern outside the reference's four
    (dense — with an encoder stack when ``encoder_layers > 0`` — MoE, SSM
    and hybrid), for a family config without its sub-config, and for a
    frontend the reference does not name."""
    if cfg.block_pattern not in ("dense", "moe", "ssm", "hybrid"):
        raise ValueError(
            f"unknown block_pattern={cfg.block_pattern!r}: the reference's "
            f"patterns are dense, moe, ssm and hybrid (an encoder-decoder "
            f"stack is dense with encoder_layers > 0)")
    if cfg.is_enc_dec and cfg.block_pattern != "dense":
        raise ValueError(f"an encoder-decoder stack is dense; got "
                         f"block_pattern={cfg.block_pattern!r}")
    if cfg.frontend not in ("none", "vision", "audio"):
        raise ValueError(f"unknown frontend={cfg.frontend!r}: none, vision "
                         f"or audio")
    if cfg.block_pattern == "moe" and cfg.moe is None:
        raise ValueError("block_pattern='moe' needs cfg.moe (a MoEConfig)")
    if cfg.block_pattern in ("ssm", "hybrid") and cfg.ssm is None:
        raise ValueError(f"block_pattern={cfg.block_pattern!r} needs cfg.ssm "
                         f"(an SSMConfig)")
