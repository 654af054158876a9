"""Many-tenant shared-prefix request traces (bench + acceptance tests).

The port's copy of the reference's ``repro.serving.trace`` (numpy only):
the same seed gives the same trace.

The workload shape the prefix cache is built for: every request opens with
one SHARED system prompt, each tenant adds its own template on top, and only
a short user tail differs per request — so full-page prefix runs repeat both
across tenants (the system pages) and within a tenant (system + template
pages). A configurable slice of requests are exact duplicates of their
tenant's previous request (the dedup/COW path). ``build_trace`` returns plain
kwargs dicts so both ``launch.serve.Request`` and ``serving.PagedRequest``
can be constructed from one trace without import cycles.
"""
from __future__ import annotations

from typing import List

import numpy as np

__all__ = ["build_trace"]


def build_trace(vocab_size: int, *, n_tenants: int = 8, per_tenant: int = 3,
                dup_every: int = 4, page_size: int = 16, max_new: int = 8,
                sys_pages: int = 2, tpl_pages: int = 1,
                seed: int = 0) -> List[dict]:
    """A deterministic multi-tenant trace as a list of request kwargs.

    Layout per request: ``sys_pages`` pages shared by EVERY request,
    ``tpl_pages`` pages shared within the tenant, then a 4..(psz-2)-token
    random tail. Every ``dup_every``-th request (trace-wide) is instead an
    exact copy of its tenant's previous request — same prompt AND same
    ``max_new`` — so admission can dedup it outright. Requests interleave
    round-robin across tenants (the arrival order a multi-tenant frontend
    actually produces) with ``priority = tenant_index % 3``.
    """
    rng = np.random.default_rng(seed)
    sys_prompt = rng.integers(0, vocab_size,
                              size=sys_pages * page_size).astype(np.int32)
    tpl = {t: rng.integers(0, vocab_size,
                           size=tpl_pages * page_size).astype(np.int32)
           for t in range(n_tenants)}
    reqs: List[dict] = []
    prev_by_tenant: dict = {}
    for r in range(per_tenant):
        for t in range(n_tenants):
            i = len(reqs)
            if dup_every and i % dup_every == dup_every - 1 \
                    and t in prev_by_tenant:
                prev = prev_by_tenant[t]
                req = dict(prev, seed=i)    # own sample stream, same content
            else:
                tail = rng.integers(
                    0, vocab_size,
                    size=int(rng.integers(4, page_size - 1))).astype(np.int32)
                req = dict(prompt=np.concatenate([sys_prompt, tpl[t], tail]),
                           max_new=max_new, seed=i,
                           tenant=f"tenant{t}", priority=t % 3)
            prev_by_tenant[t] = req
            reqs.append(req)
    return reqs
