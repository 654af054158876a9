"""Roofline terms for the dry run's cells (the reference's
``repro.launch.roofline``, with the H100's figures).

Three terms per (arch × shape × mesh), in seconds per step per device:

    compute    = FLOPs / peak FLOP/s       (989 TFLOP/s bf16 dense)
    memory     = bytes / HBM bandwidth     (3.35 TB/s)
    collective = collective bytes / link   (450 GB/s a direction, NVLink 4)

The port has no compiler's cost analysis: the dry run counts FLOPs with
``torch.utils.flop_counter.FlopCounterMode`` and bytes with a dispatch mode
over a fake-tensor trace (``launch.dryrun``), every layer included, so the
reference's Δ-trick is a linearity check there, not a correction.
:func:`collective_bytes` counts the collectives a region issues through
``torch.distributed`` (the reference parses them from HLO text).
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["HW", "collective_bytes", "extrapolate", "roofline_terms",
           "model_flops"]

# NVIDIA H100 SXM data sheet (the card ``chip_smoke.py`` runs on prints as
# "NVIDIA H100 80GB HBM3, 700.00 W"); the achieved figures measured there
# are in PERF.md (chip_smoke.py phase 16a)
HW = {
    "peak_flops": 989e12,   # bf16 dense
    "hbm_bw": 3.35e12,      # bytes/s, HBM3
    "link_bw": 450e9,       # bytes/s a direction, NVLink 4 (900 GB/s both)
}

# c10d op (as torch.distributed dispatches it) -> the reference's kind
_COLL_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast_": "broadcast", "reduce_": "reduce", "gather_": "gather",
    "scatter_": "scatter",
}


def _type_bytes(t: torch.Tensor) -> int:
    """Bytes of one tensor's elements (the reference parses them from HLO
    type strings with a table of dtype sizes; a tensor knows its own)."""
    return t.numel() * t.element_size()


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


class collective_bytes(TorchDispatchMode):
    """Per-op-kind byte counts of the collectives issued inside ``with
    collective_bytes() as c:`` (``c.counts``, the reference's dict): each
    ``torch.distributed`` collective reaches the dispatcher as a ``c10d``
    op, and counts max(result, operands) bytes — the tensors it returns
    against the other tensors it is given, the reference's conservative
    proxy for what a collective moves through the links. Object
    collectives count the byte tensors they pickle to; a barrier counts
    nothing."""

    def __init__(self):
        super().__init__()
        self.counts: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        kind = _COLL_KINDS.get(func._schema.name.split("::")[-1]) \
            if func.namespace == "c10d" else None
        if kind is not None:
            res = list(_tensors(out))
            ids = {id(t) for t in res}
            rb = sum(_type_bytes(t) for t in res)
            ob = sum(_type_bytes(t) for t in _tensors((args, kwargs))
                     if id(t) not in ids)
            self.counts[kind] += max(rb, ob)
        return out

    def as_dict(self) -> Dict[str, int]:
        return dict(self.counts)


def extrapolate(v2: float, v3: float, l2: int, l3: int, l_full: int) -> float:
    """Linear-in-layers extrapolation of a per-device cost."""
    slope = (v3 - v2) / max(l3 - l2, 1)
    return v2 + slope * (l_full - l2)


def roofline_terms(flops_dev: float, bytes_dev: float,
                   coll_dev: Optional[float]) -> dict:
    """The three terms (``collective_s`` None when ``coll_dev`` is None), the
    dominant one and the overlap fraction (the dominant term over the sum),
    both over the terms given."""
    terms = {
        "compute_s": flops_dev / HW["peak_flops"],
        "memory_s": bytes_dev / HW["hbm_bw"],
        "collective_s": None if coll_dev is None
        else coll_dev / HW["link_bw"],
    }
    given = {k: v for k, v in terms.items() if v is not None}
    bound = max(given.values())
    total = sum(given.values())
    terms["dominant"] = max(given, key=given.get)
    terms["overlap_fraction"] = bound / total if total > 0 else 0.0
    return terms


def model_flops(cfg, n_tokens: int, train: bool) -> float:
    """6·N·D (train) or 2·N·D (inference) with N = active params."""
    n = cfg.active_param_count()
    return (6.0 if train else 2.0) * n * n_tokens
