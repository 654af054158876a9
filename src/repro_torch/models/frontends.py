"""Modality frontend STUBS (the reference's ``repro.models.frontends``): the
zoo's ``[audio]`` / ``[vlm]`` entries specify the transformer backbone
only, and these helpers stand in for the speech and vision towers with
synthetic embeddings.

Both draw from an explicit ``torch.Generator`` on an explicit device (the
card unless ``device="cpu"``); they do not reproduce ``jax.random``, so
parity tests feed both packages the same numpy arrays. The dry-run's
``frontend_spec`` waits for the port's dry-run (ROADMAP Queue 1 item 15).
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig

__all__ = ["stub_vision_embeds", "stub_audio_frames", "frontend_spec"]


def _normal(generator, shape, cfg: ModelConfig, device):
    dev = resolve_device(device)
    return torch.randn(shape, generator=generator, dtype=getattr(
        torch, cfg.compute_dtype), device=dev) * 0.02


def stub_vision_embeds(generator: torch.Generator, cfg: ModelConfig,
                       batch: int, n_patches: int = None, device="cuda"):
    """Precomputed ViT patch embeddings (B, P, D) in the compute dtype, scale
    0.02 — stands in for InternViT. P is ``n_patches``, else
    ``cfg.frontend_len``, else 256."""
    n = n_patches or cfg.frontend_len or 256
    return _normal(generator, (batch, n, cfg.d_model), cfg, device)


def stub_audio_frames(generator: torch.Generator, cfg: ModelConfig,
                      batch: int, n_frames: int, device="cuda"):
    """Precomputed speech frame embeddings (B, T, D) in the compute dtype,
    scale 0.02 — stands in for the Seamless speech frontend (fbank +
    conformer downsampling)."""
    return _normal(generator, (batch, n_frames, cfg.d_model), cfg, device)


def frontend_spec(cfg: ModelConfig, batch: int, length: int, *,
                  fake_mode=None, device="cuda"):
    """A fake tensor (B, L, D) in the compute dtype on ``device``: the dry
    run's stand-in for precomputed patch / frame embeddings (the
    reference's ``ShapeDtypeStruct``). Made in ``fake_mode`` (a
    ``FakeTensorMode``), else in a mode of its own; nothing is allocated
    and no card is needed."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with fake_mode or FakeTensorMode(allow_non_fake_inputs=True):
        return torch.empty((batch, length, cfg.d_model),
                           dtype=getattr(torch, cfg.compute_dtype),
                           device=device)
