"""Mesh shapes (the reference's ``repro.launch.mesh``).

The port's mesh is its shape: a dict of axis name -> size over the ranks
of the ``torch.distributed`` world, one device a rank (``dist.sharding``
reads specs against it). ``make_production_mesh``, the TPU pod shape that
only the dry run reads, comes with the dry run.
"""
from __future__ import annotations

from repro_torch.dist import runtime

__all__ = ["make_local_mesh"]


def make_local_mesh() -> dict:
    """The world as a 1-D ``{"data": world size}`` mesh shape."""
    return {"data": runtime.process_count()}
