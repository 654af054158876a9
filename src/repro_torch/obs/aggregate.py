"""Multi-process aggregation: one merged metrics report for the whole world
(the reference's ``repro.obs.aggregate``, over ``torch.distributed``).

``dist_snapshot()`` turns N per-rank registries into ONE snapshot,
identical on every rank:

  1. each rank takes its local ``Registry.snapshot()``;
  2. one ``dist.all_gather_object`` hands every rank every rank's snapshot
     (the reference pads JSON bytes into int32 rows for its all-gather);
  3. every rank folds them with ``merge_snapshots`` in rank order.

The gathered snapshots are the same everywhere and the merge is
deterministic, so every rank computes the SAME aggregate. Counters sum,
gauges keep (min, max, sum, n), histograms add bucket-wise (exact: fixed
edges). With no process group the world is one rank and the local snapshot
comes back normalized through the merge.

``write_snapshot()`` is rank 0's commit: it writes (or name-merges into)
``DEFAULT_METRICS_PATH`` so successive drivers accumulate into one report.
"""
from __future__ import annotations

import json
import pathlib
from typing import Optional

import torch.distributed as dist

from repro_torch.obs.registry import Registry, get_registry, merge_snapshots

__all__ = ["dist_snapshot", "write_snapshot", "DEFAULT_METRICS_PATH"]

# under the git-ignored build/ (relative to the working directory), so a
# CLI run from a checkout writes nothing that git tracks
DEFAULT_METRICS_PATH = "build/obs/metrics.json"


def _world(group=None) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _rank(group=None) -> int:
    return dist.get_rank(group) if dist.is_initialized() else 0


def dist_snapshot(registry: Optional[Registry] = None, *,
                  group=None) -> dict:
    """Every rank's snapshot of ``registry`` (the default registry when
    None) merged in rank order — a collective: every rank of ``group``
    calls it, and every rank gets the same dict."""
    local = (registry if registry is not None else get_registry()).snapshot()
    if _world(group) == 1:
        return merge_snapshots(local, {})   # normalize through the merge
    per_rank = [None] * _world(group)
    dist.all_gather_object(per_rank, local, group=group)
    merged: dict = {}
    for snap in per_rank:
        merged = merge_snapshots(merged, snap)
    return merged


def write_snapshot(snapshot: Optional[dict] = None,
                   path=DEFAULT_METRICS_PATH, *,
                   registry: Optional[Registry] = None,
                   merge: bool = True) -> Optional[pathlib.Path]:
    """Write a snapshot to ``path`` on rank 0 (other ranks write nothing
    and return None).

    ``snapshot=None`` takes ``dist_snapshot(registry)`` first (a collective:
    every rank calls this then). With ``merge=True`` an existing file's
    metrics are kept unless this snapshot carries the same name, so
    sequential runs accumulate into one report."""
    if snapshot is None:
        snapshot = dist_snapshot(registry)
    if _rank() != 0:
        return None
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    out = snapshot
    if merge and p.exists():
        try:
            prev = json.loads(p.read_text())
        except ValueError:
            prev = {}
        out = {**prev, **snapshot}
    p.write_text(json.dumps(out, indent=1, sort_keys=True))
    return p
