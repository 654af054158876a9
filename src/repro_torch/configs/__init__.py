"""Architecture config registry: ``get_config(arch_id)``.

The port carries the paper's own OPT family; the other architectures of the
reference's zoo wait for their model families (ROADMAP Queue 1 items 11-12).
"""
from __future__ import annotations

from repro_torch.configs import opt_paper

_ARCHS = {
    "opt-1.3b": opt_paper,
    "opt-13b": opt_paper,
    "opt-125m": opt_paper,
    "opt-tiny": opt_paper,
}


def get_config(arch: str):
    if arch not in _ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCHS)}")
    return _ARCHS[arch].config(arch)
