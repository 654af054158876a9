"""Paged KV-cache serving (continuous batching), the reference's
``repro.serving``.

- ``paged_cache``: page pool (written in place), refcounting allocator,
  block tables, content-addressed prefix cache
- ``prefill``: chunked paged prefill (prompt K/V written straight into pages)
- ``decode``: the paged decode step (K/V write + the CUDA paged-decode
  kernel), greedy or per-request sampling
- ``batcher``: admit / evict / reclaim loop between decode steps, with
  prefix-cache aliasing, duplicate-admit twins and copy-on-write forks
- ``scheduler``: FIFO and SLO admission/eviction policies
- ``trace``: the many-tenant shared-prefix request trace
"""
from repro_torch.serving.batcher import ContinuousBatcher, PagedRequest
from repro_torch.serving.decode import (make_paged_decode_step,
                                        paged_attention_block, request_key,
                                        sample_logits, sample_logits_per_seq)
from repro_torch.serving.paged_cache import (NULL_PAGE, PageAllocator,
                                             PagedKVCache, PrefixCache,
                                             chain_keys)
from repro_torch.serving.prefill import (make_paged_prefill_step,
                                         paged_prefill_attention,
                                         run_prefill_chunks)
from repro_torch.serving.scheduler import (FIFOScheduler, Scheduler,
                                           SLOScheduler, make_scheduler)
from repro_torch.serving.trace import build_trace

__all__ = ["PageAllocator", "PagedKVCache", "PrefixCache", "NULL_PAGE",
           "chain_keys", "make_paged_decode_step", "paged_attention_block",
           "make_paged_prefill_step", "paged_prefill_attention",
           "run_prefill_chunks", "request_key", "sample_logits",
           "sample_logits_per_seq", "ContinuousBatcher", "PagedRequest",
           "Scheduler", "FIFOScheduler", "SLOScheduler", "make_scheduler",
           "build_trace"]
