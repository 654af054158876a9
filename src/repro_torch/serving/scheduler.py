"""Pluggable admission + eviction policy for the continuous batcher.

The port's copy of the reference's ``repro.serving.scheduler`` (host code,
plain Python): it makes the same decisions on the same batcher state.

``ContinuousBatcher`` delegates every policy decision to a ``Scheduler``
(with refcounted shared pages the cheap-to-evict victim is not simply the
newest, and multi-tenant serving needs admission control FIFO cannot
express):

  pick_admit    which queued request (index into ``batcher.queue``) to admit
                next, or None to admit nothing this round
  pick_victim   which live slot index to preempt when the pool is exhausted
  admissible    whether a request may take ``n_pages`` more pages right now
                (per-tenant quota enforcement; also gates duplicate-admit
                aliasing, which allocates almost nothing but still holds
                references)

``FIFOScheduler`` (the default) admits the queue head or nothing and
evicts the newest admission.

``SLOScheduler`` is the production policy:

  admission   highest ``PagedRequest.priority`` first; FIFO (arrival order)
              within a priority class, so equal-priority tenants cannot
              starve each other. A request whose tenant is at its page quota
              is skipped — a later, under-quota request may admit past it.
  eviction    lowest priority first; among equals, the slot with the LEAST
              progress toward completion (fewest generated tokens — the
              cheapest SLO damage), and ties broken by RE-ADMIT COST: pages
              shared with the prefix cache or another sequence survive the
              victim's release and will be re-aliased on re-admit, so a
              victim holding mostly shared pages loses almost nothing.
  quota       ``tenant_quota`` bounds the pages a tenant's live slots may
              hold simultaneously (aliased pages count against every
              holder); ``quotas`` overrides the bound per tenant.
"""
from __future__ import annotations

from typing import Dict, Optional

__all__ = ["Scheduler", "FIFOScheduler", "SLOScheduler", "make_scheduler"]


class Scheduler:
    """Policy interface; see module docstring. Methods receive the batcher
    itself — policies read ``batcher.queue`` / ``batcher.slots`` / the
    allocator, and must not mutate them."""

    def pick_admit(self, batcher) -> Optional[int]:
        raise NotImplementedError

    def pick_victim(self, batcher) -> Optional[int]:
        raise NotImplementedError

    def admissible(self, batcher, req, n_pages: int) -> bool:
        return True


class FIFOScheduler(Scheduler):
    """The legacy hardwired policy: admit the queue head, evict the newest
    admission (max ticket). Never evicts the only runner — recompute
    preemption of the sole live sequence makes no forward progress."""

    def pick_admit(self, batcher) -> Optional[int]:
        return 0 if batcher.queue else None

    def pick_victim(self, batcher) -> Optional[int]:
        live = [(i, s) for i, s in enumerate(batcher.slots) if s is not None]
        if len(live) <= 1:
            return None
        return max(live, key=lambda t: t[1].ticket)[0]


class SLOScheduler(Scheduler):
    def __init__(self, tenant_quota: Optional[int] = None,
                 quotas: Optional[Dict[str, int]] = None):
        self.tenant_quota = tenant_quota
        self.quotas = dict(quotas or {})

    # -- quota -------------------------------------------------------------

    def _quota_of(self, tenant: str) -> Optional[int]:
        return self.quotas.get(tenant, self.tenant_quota)

    def _held_pages(self, batcher, tenant: str) -> int:
        # a shared page counts against every holder: quotas bound references
        # (what a tenant can pin), not exclusive bytes — otherwise one tenant
        # could pin the whole pool through the prefix cache for free
        return sum(len(s.page_ids) for s in batcher.slots
                   if s is not None and s.req.tenant == tenant)

    def admissible(self, batcher, req, n_pages: int) -> bool:
        quota = self._quota_of(req.tenant)
        if quota is None:
            return True
        return self._held_pages(batcher, req.tenant) + n_pages <= quota

    # -- admission ---------------------------------------------------------

    def pick_admit(self, batcher) -> Optional[int]:
        best = None
        for qi, req in enumerate(batcher.queue):
            need = batcher.pages_needed(req)
            if not self.admissible(batcher, req, need):
                continue
            key = (-req.priority, req.arrival)
            if best is None or key < best[0]:
                best = (key, qi)
        return None if best is None else best[1]

    # -- eviction ----------------------------------------------------------

    def pick_victim(self, batcher) -> Optional[int]:
        live = [(i, s) for i, s in enumerate(batcher.slots) if s is not None]
        if len(live) <= 1:
            return None

        alloc = batcher.cache.allocator
        psz = batcher.cache.page_size

        def score(item):
            i, s = item
            # pages with other owners (prefix cache or a co-owning sequence)
            # survive this slot's release: the re-admit re-aliases them, so
            # only exclusively-owned pages are genuine recompute cost
            exclusive = sum(1 for p in s.page_ids if alloc.refcount(p) == 1)
            progress = len(s.req.out) / max(s.req.max_new, 1)
            return (s.req.priority, progress, exclusive * psz, -s.ticket)

        return min(live, key=score)[0]


def make_scheduler(name: str, tenant_quota: Optional[int] = None,
                   quotas: Optional[Dict[str, int]] = None) -> Scheduler:
    """Flag-friendly factory: ``fifo`` (legacy-identical) or ``slo``."""
    if name == "fifo":
        return FIFOScheduler()
    if name == "slo":
        return SLOScheduler(tenant_quota=tenant_quota, quotas=quotas)
    raise ValueError(f"unknown scheduler {name!r} (want 'fifo' or 'slo')")
