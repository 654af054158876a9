"""Architecture config registry: ``get_config(arch_id)`` / ``list_archs()``.

The port registers every id of the reference's registry, in its order: the
paper's own OPT family and the zoo's dense, vision, encoder-decoder, MoE,
SSM and hybrid architectures (RoPE, GQA, gated SwiGLU, qk-norm, qkv biases,
tied embeddings, stub frontends, cross-attention, top-k experts, Mamba2 /
SSD blocks, a shared attention block).
"""
from __future__ import annotations

import importlib

_ARCHS = {
    "zamba2-7b": "zamba2_7b",
    "internlm2-1.8b": "internlm2_1_8b",
    "qwen3-4b": "qwen3_4b",
    "command-r-35b": "command_r_35b",
    "yi-6b": "yi_6b",
    "mamba2-2.7b": "mamba2_2_7b",
    "internvl2-1b": "internvl2_1b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b",
    "opt-1.3b": "opt_paper",
    "opt-13b": "opt_paper",
    "opt-125m": "opt_paper",
    "opt-tiny": "opt_paper",
}


def list_archs(assigned_only: bool = True):
    """The registered ids, without the OPT family if ``assigned_only``."""
    ids = list(_ARCHS)
    return [a for a in ids if not a.startswith("opt-")] if assigned_only else ids


def get_config(arch: str):
    if arch not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCHS[arch]}")
    return mod.config(arch) if hasattr(mod, "config") else mod.CONFIG
