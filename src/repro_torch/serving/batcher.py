"""Continuous batching scheduler over the paged KV cache (the reference's
``repro.serving.batcher``, same stats dict, same obs instruments):

  admit     between decode steps, free batch slots are filled from the queue:
            the prompt is prefilled in PAGE-ALIGNED CHUNKS written straight
            into freshly allocated pages (``serving/prefill.py`` — no
            contiguous KV buffer, no scatter copy), and the slot joins the
            running batch.
  step      ONE decode step advances every live slot at once (each at its
            own depth — positions and lengths are per-sequence, and each
            slot carries its own sampling params), with one host sync: the
            read-back of the next tokens.
  reclaim   finished sequences return their pages to the free list and their
            slot to the admit pool immediately; nobody waits for a batch.
  evict     if a slot's next token needs a page and the pool is exhausted,
            a live sequence is preempted (vLLM-style recompute preemption):
            its page references are released and it re-queues with prompt +
            generated-so-far, to be re-prefilled when space frees.

Policy (WHICH request admits, WHO gets evicted, per-tenant quotas) lives in
``serving/scheduler.py`` — the default ``FIFOScheduler`` admits the queue
head and evicts the newest admission; ``SLOScheduler`` adds priority +
fairness admission, page quotas and least-progress / shared-aware eviction.

With ``prefix_cache`` enabled, pages are SHARED objects:

  alias     admit looks the prompt's full-page runs up in the content-
            addressed ``PrefixCache`` and aliases every matching page into
            the block table (retained, zero prefill), chunk-prefilling only
            the divergent tail. At least one tail token is always computed —
            the last position's logits seed the first generated token.
  publish   the tail's freshly computed full pages are indexed in the cache
            (which holds its own reference), so they outlive this sequence.
  dedup     a queued request with IDENTICAL content to a just-admitted one
            joins the batch by retaining that slot's pages outright — zero
            prefill, shared first-token logits (its own seed still draws its
            own stream).
  cow       before each decode step, a slot about to write into a page that
            still has other owners forks it (``fork_page`` copy, release the
            shared original) — no write ever mutates shared state, which is
            what keeps outputs bit-identical to sharing disabled.

Sampling is PER REQUEST: ``PagedRequest.temperature / top_k / seed`` ride
into the step as (B,) host arrays, so one step serves any greedy/sampled
mix. Keys derive from ``(seed, token index)`` alone (``decode.request_key``),
so a preempted request resumes its sample stream deterministically.
All-greedy batches use the 5-argument greedy step.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import check_on_device
from repro_torch.models.config import ModelConfig
from repro_torch.serving.decode import (make_paged_decode_step, request_key,
                                        sample_logits_per_seq)
from repro_torch.serving.paged_cache import (PagedKVCache, PrefixCache,
                                             chain_keys)
from repro_torch.serving.prefill import (make_paged_prefill_step,
                                         run_prefill_chunks)
from repro_torch.serving.scheduler import FIFOScheduler, Scheduler

__all__ = ["PagedRequest", "ContinuousBatcher"]


@dataclasses.dataclass
class PagedRequest:
    """One generation request; ``out`` accumulates across preemptions.

    ``temperature <= 0`` decodes greedily (the default); ``temperature > 0``
    samples, optionally
    top-k-restricted, from the stream seeded by ``seed``. ``tenant`` and
    ``priority`` are policy inputs for ``SLOScheduler`` (quotas / admission
    order); the default ``FIFOScheduler`` ignores both. ``arrival`` is
    stamped by ``submit`` (fairness tiebreak within a priority class).
    """

    prompt: np.ndarray              # (S,) int32
    max_new: int = 32
    out: List[int] = dataclasses.field(default_factory=list)
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0
    tenant: str = "default"
    priority: int = 0
    arrival: int = -1


@dataclasses.dataclass
class _Slot:
    req: PagedRequest
    page_ids: List[int]
    seq_len: int                    # tokens whose K/V are in the pool
    last_tok: int                   # next decode step's input token
    ticket: int = 0                 # admission order (FIFO eviction picks max)
    n_aliased: int = 0              # pages adopted from the cache / a twin


class ContinuousBatcher:
    """Serves requests over ``cache`` (whose device the params must share)."""

    def __init__(self, params_q, cfg: ModelConfig, cache: PagedKVCache,
                 max_batch: int = 4, prefill_chunk_pages: int = 4,
                 scheduler: Optional[Scheduler] = None,
                 prefix_cache: Union[bool, PrefixCache] = False,
                 prefix_cache_entries: Optional[int] = None,
                 gqa_pages_per_block: int = 1,
                 registry=None):
        check_on_device(params_q, cache.device)
        self.params = params_q
        self.cfg = cfg
        self.cache = cache
        self.device = cache.device
        self.B = max_batch
        self.slots: List[Optional[_Slot]] = [None] * max_batch
        self.queue: Deque[PagedRequest] = collections.deque()
        self.done: List[PagedRequest] = []
        self.step_fn = make_paged_decode_step(
            cfg, gqa_pages_per_block=gqa_pages_per_block)
        self.sampled_step_fn = make_paged_decode_step(
            cfg, per_request=True, gqa_pages_per_block=gqa_pages_per_block)
        self.prefill_chunk_pages = max(int(prefill_chunk_pages), 1)
        self._prefill_chunk = make_paged_prefill_step(cfg)
        self.scheduler = scheduler if scheduler is not None else FIFOScheduler()
        if isinstance(prefix_cache, PrefixCache):
            self.prefix: Optional[PrefixCache] = prefix_cache
        else:
            self.prefix = PrefixCache(cache.allocator,
                                      max_entries=prefix_cache_entries) \
                if prefix_cache else None
        self._ticket = 0
        self._arrival = 0
        self._t_submit: Dict[int, float] = {}
        self.stats = {"steps": 0, "prefills": 0, "prefill_chunks": 0,
                      "evictions": 0, "peak_pages": 0, "prefill_tokens": 0,
                      "prefill_tokens_saved": 0, "aliased_pages": 0,
                      "dedup_admits": 0, "cow_forks": 0}
        reg = registry if registry is not None else obs.get_registry()
        self.obs = {
            "ttft": reg.histogram(
                "serving_ttft_seconds", "Submit-to-first-token latency"),
            "tpot": reg.histogram(
                "serving_tpot_seconds",
                "One decode step (time per output token)"),
            "prefill": reg.histogram(
                "serving_prefill_seconds",
                "Chunked prefill latency per admitted request"),
            "queue_depth": reg.gauge(
                "serving_queue_depth", "Queued requests at the last step"),
            "pages_in_use": reg.gauge(
                "serving_pages_in_use",
                "Live (non-reserved) pages at the last step"),
            "page_util": reg.gauge(
                "serving_page_utilization",
                "Live pages / allocatable pages at the last step"),
            "shared_pages": reg.gauge(
                "serving_shared_pages",
                "Distinct live pages with refcount > 1 at the last step"),
            "prefill_tokens": reg.counter(
                "serving_prefill_tokens_total", "Prompt tokens prefilled"),
            "tokens_saved": reg.counter(
                "serving_prefill_tokens_saved_total",
                "Prompt tokens skipped via prefix aliasing / dedup"),
            "aliased": reg.counter(
                "serving_aliased_pages_total",
                "Pages adopted from the prefix cache or a twin slot"),
            "dedup": reg.counter(
                "serving_dedup_admits_total",
                "Requests admitted by duplicate-content aliasing"),
            "cow": reg.counter(
                "serving_cow_forks_total", "Copy-on-write page forks"),
            "lru_retired": reg.counter(
                "serving_prefix_lru_retired_total",
                "Prefix-cache pages retired under allocation backpressure"),
            "preempt": reg.counter(
                "serving_preemptions_total",
                "Recompute preemptions (labelled by triggering reason)"),
            "decode_steps": reg.counter(
                "serving_decode_steps_total", "Decode steps run"),
        }

    # -- admission ---------------------------------------------------------

    def submit(self, req: PagedRequest) -> None:
        if len(req.prompt) == 0:
            # the contiguous-prefill path silently decoded from a garbage
            # position here; generation with no conditioning is ill-defined
            raise ValueError("empty prompt: nothing to condition on")
        if len(req.prompt) + req.max_new > \
                self.cache.max_pages_per_seq * self.cache.page_size:
            raise ValueError("request exceeds max_pages_per_seq budget")
        req.arrival = self._arrival
        self._arrival += 1
        self._t_submit[id(req)] = time.monotonic()
        self.queue.append(req)

    def pages_needed(self, req: PagedRequest) -> int:
        """Pages an admit of ``req`` holds before any prefix aliasing (the
        scheduler's conservative quota estimate)."""
        plen = len(req.prompt) + len(req.out)
        extra = 1 if plen % self.cache.page_size == 0 else 0
        return self.cache.pages_for(plen) + extra

    def _record_first_token(self, req: PagedRequest) -> None:
        if not req.out:           # re-admits already produced their first token
            t0 = self._t_submit.pop(id(req), None)
            if t0 is not None:
                self.obs["ttft"].observe(time.monotonic() - t0)

    def _first_token(self, req: PagedRequest, logits_row) -> int:
        """Select the token that follows the prefilled prompt.

        Greedy requests take the argmax; sampling requests draw through the
        SAME selection function, key and logits width as the decode step
        (``sample_logits_per_seq`` over the full padded-vocab row, key from
        (seed, token index)) — the draws depend on the row width, so
        slicing to ``vocab_size`` here would fork a preempted request's
        sample stream on padded-vocab configs.
        """
        if req.temperature <= 0.0:
            return int(torch.argmax(logits_row[: self.cfg.vocab_size]))
        tok = sample_logits_per_seq(
            logits_row[None],
            [request_key(req.seed, len(req.out), logits_row.device)],
            [req.temperature], [req.top_k])
        return int(tok[0])

    def _alloc_pages(self, n: int) -> Optional[List[int]]:
        """Allocate with prefix-cache backpressure: when the pool is dry,
        unreferenced cached runs are retired (LRU) before giving up."""
        if n <= 0:
            return []
        got = self.cache.allocator.alloc(n)
        if got is None and self.prefix is not None:
            retired = self.prefix.evict_lru(n - self.cache.allocator.num_free)
            self.obs["lru_retired"].inc(retired)
            got = self.cache.allocator.alloc(n)
        return got

    def _admit_one(self) -> bool:
        """Admit one scheduled request into a free slot. False if blocked.

        With the prefix cache on, matching full-page prompt runs are ALIASED
        (retained, zero prefill) and only the divergent tail — always at
        least one token, whose logits seed the first generated token — is
        chunk-prefilled; the tail's full pages are then published back to
        the cache.
        """
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free or not self.queue:
            return False
        qi = self.scheduler.pick_admit(self)
        if qi is None:
            return False
        req = self.queue[qi]
        if len(req.out) >= req.max_new:     # nothing left to generate
            del self.queue[qi]
            self.done.append(req)
            return True
        psz = self.cache.page_size
        plen = len(req.prompt) + len(req.out)  # preempted: re-prefill both
        full = np.concatenate([req.prompt, np.asarray(req.out, np.int32)]) \
            if req.out else np.asarray(req.prompt, np.int32)
        keys: List[bytes] = []
        matched: List[int] = []
        if self.prefix is not None:
            keys = chain_keys(full, psz)
            # cap at (plen-1)//psz so >= 1 tail token is always computed
            matched = self.prefix.lookup(keys[: (plen - 1) // psz])
        # pages_needed includes the extra page a page-aligned prompt's first
        # decode write (position plen) needs — grabbed at admission so the
        # slot never scatters into the null page
        fresh = self._alloc_pages(self.pages_needed(req) - len(matched))
        if fresh is None:
            if matched:
                self.cache.allocator.release(matched)
            return False
        del self.queue[qi]
        page_ids = matched + fresh
        bt = torch.from_numpy(self.cache.block_table_row(page_ids)[None]
                              ).to(self.device)
        start = len(matched) * psz
        with obs.trace_span("serve.prefill", tokens=plen - start,
                            hist=self.obs["prefill"]):
            logits_row, self.cache.pools, n_chunks = run_prefill_chunks(
                self._prefill_chunk, self.params, self.cache.pools, full, bt,
                page_size=psz, chunk_pages=self.prefill_chunk_pages,
                start=start)
        self.stats["prefill_chunks"] += n_chunks
        self.stats["prefill_tokens"] += plen - start
        self.stats["prefill_tokens_saved"] += start
        self.stats["aliased_pages"] += len(matched)
        self.obs["prefill_tokens"].inc(plen - start)
        self.obs["tokens_saved"].inc(start)
        self.obs["aliased"].inc(len(matched))
        if self.prefix is not None:
            for i in range(len(matched), plen // psz):
                self.prefix.insert(keys[i], page_ids[i])
        nxt = self._first_token(req, logits_row)
        self.stats["prefills"] += 1
        self._ticket += 1
        slot = _Slot(req=req, page_ids=page_ids, seq_len=plen, last_tok=nxt,
                     ticket=self._ticket, n_aliased=len(matched))
        self._record_first_token(req)
        req.out.append(nxt)
        si = free[0]
        self.slots[si] = slot
        # duplicate-admit aliasing must run while this slot still holds its
        # pages (a finished-at-admit release would strand the twins)
        if self.prefix is not None:
            self._admit_twins(full, plen, page_ids, logits_row)
        self._finish_if_done(si)
        return True

    def _admit_twins(self, full, plen, page_ids, logits_row) -> None:
        """Admit queued requests whose CONTENT equals a just-admitted one by
        retaining its pages outright — zero prefill, zero fresh pages.

        The shared logits row is exactly what each twin's own prefill would
        have produced (same compiled programs, same inputs), and every twin
        samples its first token with its own (seed, index) key, so streams
        never fork. Divergence after that is handled by the decode-time COW
        fork: the first writer into the shared tail page copies it first.
        """
        qi = 0
        while qi < len(self.queue):
            free = [i for i, s in enumerate(self.slots) if s is None]
            if not free:
                return
            q = self.queue[qi]
            if len(q.out) >= q.max_new:     # drained by _admit_one's path
                qi += 1
                continue
            q_full = np.concatenate([q.prompt, np.asarray(q.out, np.int32)]) \
                if q.out else np.asarray(q.prompt, np.int32)
            if len(q_full) != plen or not np.array_equal(q_full, full) or \
                    not self.scheduler.admissible(self, q, len(page_ids)):
                qi += 1
                continue
            self.cache.allocator.retain(page_ids)
            del self.queue[qi]
            nxt = self._first_token(q, logits_row)
            self.stats["prefills"] += 1
            self.stats["dedup_admits"] += 1
            self.stats["prefill_tokens_saved"] += plen
            self.stats["aliased_pages"] += len(page_ids)
            self.obs["dedup"].inc()
            self.obs["tokens_saved"].inc(plen)
            self.obs["aliased"].inc(len(page_ids))
            self._ticket += 1
            slot = _Slot(req=q, page_ids=list(page_ids), seq_len=plen,
                         last_tok=nxt, ticket=self._ticket,
                         n_aliased=len(page_ids))
            self._record_first_token(q)
            q.out.append(nxt)
            si = free[0]
            self.slots[si] = slot
            self._finish_if_done(si)

    def _admit(self) -> None:
        while self._admit_one():
            pass

    # -- eviction / reclamation --------------------------------------------

    def _release(self, i: int) -> None:
        """Drop slot i's page references; shared pages survive their co-owners
        (the prefix cache or a duplicate-admit twin)."""
        slot = self.slots[i]
        self.cache.allocator.release(slot.page_ids)
        self.slots[i] = None

    def _evict_one(self, reason: str = "page_capacity") -> bool:
        """Preempt the scheduler's victim back to the queue head."""
        vi = self.scheduler.pick_victim(self)
        if vi is None:
            return False  # never evict the only runner: no forward progress
        self.stats["evictions"] += 1
        self.obs["preempt"].inc(reason=reason)
        self.queue.appendleft(self.slots[vi].req)
        self._release(vi)
        return True

    def _ensure_page_capacity(self) -> None:
        """Every live slot must own the page its next token writes into."""
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            while len(slot.page_ids) * self.cache.page_size <= slot.seq_len:
                got = self._alloc_pages(1)
                if got is not None:
                    slot.page_ids.extend(got)
                    break
                if not self._evict_one():
                    raise RuntimeError(
                        "page pool exhausted with a single live sequence; "
                        "grow n_pages or shrink max_new")
                if self.slots[i] is None:  # the victim was slot i itself
                    break

    def _ensure_cow(self) -> None:
        """Copy-on-write: no decode write may mutate a shared page.

        Each live slot's next token writes at ``(seq_len // psz, seq_len %
        psz)``; if that physical page still has other owners (a duplicate-
        admit twin — cached full-prefix pages are never the write target,
        they end strictly before position ``seq_len``), it is forked first:
        copy the rows into a fresh page, swap the block-table entry, release
        the shared original. Eviction of a co-owner can drop the count to 1
        mid-loop, in which case no fork is needed after all.
        """
        psz = self.cache.page_size
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            idx = slot.seq_len // psz   # _ensure_page_capacity ran: in range
            while self.cache.allocator.refcount(slot.page_ids[idx]) > 1:
                got = self._alloc_pages(1)
                if got is not None:
                    old = slot.page_ids[idx]
                    self.cache.fork_page(old, got[0])
                    slot.page_ids[idx] = got[0]
                    self.cache.allocator.release([old])
                    self.stats["cow_forks"] += 1
                    self.obs["cow"].inc()
                    break
                if not self._evict_one(reason="cow_fork"):
                    raise RuntimeError(
                        "page pool exhausted: cannot copy-on-write fork a "
                        "shared page; grow n_pages")
                if self.slots[i] is None:  # the victim was slot i itself
                    break

    def _finish_if_done(self, i: int) -> None:
        slot = self.slots[i]
        if slot is not None and len(slot.req.out) >= slot.req.max_new:
            self.done.append(slot.req)
            self._release(i)

    # -- the decode loop ---------------------------------------------------

    def _batch_arrays(self):
        """(tokens (B, 1), block tables (B, P), lengths (B,)) on the device.

        The table is cut to the widest live row (P = the most pages a live
        slot holds): no decode reads past its length, and the paged-decode
        split planner sizes its runs from P, so a table padded to
        ``max_pages_per_seq`` would split short contexts."""
        bt = np.zeros((self.B, self.cache.max_pages_per_seq), np.int32)
        lens = np.zeros((self.B,), np.int32)
        toks = np.zeros((self.B, 1), np.int64)
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            bt[i] = self.cache.block_table_row(slot.page_ids)
            lens[i] = slot.seq_len
            toks[i, 0] = slot.last_tok
        P = max([len(s.page_ids) for s in self.slots if s is not None],
                default=1)
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                     for a in (toks, bt[:, :P], lens))

    def _sampling_arrays(self):
        """Per-slot (seeds, token_indices, temperatures, top_ks), all (B,).

        Plain host-side int/float fills; the step builds each sampled
        slot's generator from (seed, index) on the host.
        """
        seeds = np.zeros((self.B,), np.int32)
        idx = np.zeros((self.B,), np.int32)
        temps = np.zeros((self.B,), np.float32)
        top_ks = np.zeros((self.B,), np.int32)
        for i, slot in enumerate(self.slots):
            if slot is None or slot.req.temperature <= 0.0:
                continue
            seeds[i] = slot.req.seed
            idx[i] = len(slot.req.out)
            temps[i] = slot.req.temperature
            top_ks[i] = slot.req.top_k
        return seeds, idx, temps, top_ks

    def step(self) -> int:
        """Admit + one decode step for all live slots. Returns #live."""
        self._admit()
        self._ensure_page_capacity()
        self._admit()  # eviction may have freed a slot a queued req fits in
        self._ensure_cow()  # after all admits: no write into a shared page
        live = [i for i, s in enumerate(self.slots) if s is not None]
        if not live:
            return 0
        alloc = self.cache.allocator
        in_use = alloc.n_pages - alloc.reserved - alloc.num_free
        self.stats["peak_pages"] = max(self.stats["peak_pages"], in_use)
        self.obs["queue_depth"].set(len(self.queue))
        self.obs["pages_in_use"].set(in_use)
        allocatable = max(alloc.n_pages - alloc.reserved, 1)
        self.obs["page_util"].set(in_use / allocatable)
        held = {pid for i in live for pid in self.slots[i].page_ids}
        self.obs["shared_pages"].set(
            sum(1 for pid in held if alloc.refcount(pid) > 1))
        toks, bt, lens = self._batch_arrays()
        with obs.trace_span("serve.decode_step", live=len(live),
                            hist=self.obs["tpot"]):
            if any(self.slots[i].req.temperature > 0.0 for i in live):
                seeds, idx, temps, top_ks = self._sampling_arrays()
                next_toks, self.cache.pools = self.sampled_step_fn(
                    self.params, toks, self.cache.pools, bt, lens, seeds,
                    idx, temps, top_ks)
            else:  # all-greedy: the 5-arg greedy step
                next_toks, self.cache.pools = self.step_fn(
                    self.params, toks, self.cache.pools, bt, lens)
            next_toks = next_toks.cpu().numpy()   # the device sync
        self.stats["steps"] += 1
        self.obs["decode_steps"].inc()
        for i in live:
            slot = self.slots[i]
            slot.seq_len += 1
            if len(slot.req.out) >= slot.req.max_new:
                # defensive: a full request must never grow past its budget
                self._finish_if_done(i)
                continue
            slot.last_tok = int(next_toks[i, 0])
            slot.req.out.append(slot.last_tok)
            self._finish_if_done(i)
        return len(live)

    def _reset_run_state(self) -> None:
        """Drop per-run bookkeeping (``done``, the submit stamps) so a reused
        batcher does not accumulate state across ``run()`` calls; durable
        metrics live in the registry."""
        self.done.clear()
        self._t_submit.clear()

    def run(self, requests) -> List[List[int]]:
        """Serve a request list to completion; outputs in submission order.

        ``out`` is bounded by ``max_new`` at generation time (admit and step
        both stop appending at the budget), so no output truncation is
        needed here.
        """
        self._reset_run_state()
        for r in requests:
            self.submit(r)
        while self.queue or any(s is not None for s in self.slots):
            n = self.step()
            if n == 0 and self.queue:
                raise RuntimeError(
                    "queue stalled: prompts cannot be admitted (pool too "
                    "small, or every queued tenant is over quota)")
        if self.prefix is not None:
            # end-of-run drain: drop the cache's page references so the
            # allocator returns to fully free between request batches (the
            # cache amortises prefills WITHIN a run / server lifetime)
            self.prefix.clear()
        return [r.out for r in requests]
