"""Explicit device resolution: the port's entry points run on the card unless
the caller asks for the CPU, and never drop to the CPU silently."""
from __future__ import annotations

import torch

__all__ = ["resolve_device", "check_on_device"]


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and no
    GPU is present (pass ``device="cpu"`` to run on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev


def check_on_device(tree, device: torch.device, what: str = "params") -> None:
    """Raise if any tensor leaf of a nested dict is not on ``device``."""
    def walk(x, path):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, path + (k,))
        elif isinstance(x, torch.Tensor) and x.device.type != device.type:
            raise ValueError(
                f"{what} leaf {'/'.join(path)} is on {x.device}, expected "
                f"{device}")

    walk(tree, ())
