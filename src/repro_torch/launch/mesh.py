"""Mesh shapes (the reference's ``repro.launch.mesh``).

The port's mesh is its shape: a dict of axis name -> size over the ranks
of the ``torch.distributed`` world, one device a rank (``dist.sharding``
reads specs against it).
"""
from __future__ import annotations

from repro_torch.dist import runtime

__all__ = ["make_production_mesh", "make_local_mesh"]


def make_production_mesh(*, multi_pod: bool = False) -> dict:
    """The reference's TPU pod shapes, as mesh dicts: one pod
    ``{"data": 16, "model": 16}`` (256 chips), or with ``multi_pod`` two
    pods ``{"pod": 2, "data": 16, "model": 16}`` (512 chips, the leading
    "pod" axis crossing pods). They are kept so that the dry run
    (``launch.dryrun``) reads the same sharding tables as the reference's;
    they describe no H100 cluster the port has run on."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_local_mesh() -> dict:
    """The world as a 1-D ``{"data": world size}`` mesh shape."""
    return {"data": runtime.process_count()}
