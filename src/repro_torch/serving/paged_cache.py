"""Paged KV-cache storage: a global page pool + per-sequence block tables
(the reference's ``repro.serving.paged_cache``).

Instead of one contiguous ``(B, max_len, ...)`` cache buffer per batch slot,
the cache is a pool of fixed-size pages shared by every sequence:

    k / v : (n_layers, n_pages, page_size, n_kv_heads, head_dim)

A sequence of length ``s`` holds exactly ``ceil(s / page_size)`` page ids
(the same ids index every layer's pool), so pool memory tracks the LIVE
token count. Page ids come from a refcounting free-list ``PageAllocator``;
physical page 0 is the reserved *null page* that idle batch slots point
their block tables at. ``PrefixCache`` indexes full prompt pages by the
chained hash of their tokens (``chain_keys``, the reference's blake2b
bytes), and duplicate-admit twins share pages until a decode write forks
them (``PagedKVCache.fork_page``).

With ``cfg.kv_cache_dtype == "int8"`` pages store int8 codes plus
per-(slot, head) absmax scales (``models.layers.quantize_kv``).

In-place pools. The reference updates the pools functionally (new arrays
out of every jitted step). The port keeps ``pools`` on the device and
writes them IN PLACE — decode and prefill ``index_put_`` into per-layer
views of the (L, N, psz, Hkv, Dh) leaves, ``fork_page`` copies rows — so no
step copies the whole pool. That is safe because the batcher runs every
copy-on-write fork before the decode step that would write into a shared
page, and each step writes a layer's new K/V before it reads that layer's
pool, exactly the order of the reference's ``new`` pools.
"""
from __future__ import annotations

import collections
import hashlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig

__all__ = ["PageAllocator", "PagedKVCache", "PrefixCache", "NULL_PAGE",
           "chain_keys", "copy_page"]

NULL_PAGE = 0


def copy_page(pools, src: int, dst: int):
    """{leaf: (L, N, ...)} with row ``dst`` <- row ``src`` on every leaf, IN
    PLACE; returns ``pools`` (the reference's ``_copy_page`` returns new
    pools)."""
    for pool in pools.values():
        pool[:, dst].copy_(pool[:, src])
    return pools


class PageAllocator:
    """Refcounting LIFO free-list over page ids [reserved, n_pages).

    ``alloc`` is all-or-nothing (a partial grant would deadlock the batcher:
    a sequence cannot attend over half its prompt) and hands pages out with
    refcount 1. ``retain`` adds an owner; ``release`` drops
    one and returns the page to the free list only when the count reaches
    zero. Releasing a page that is not live raises — an id returned twice
    means two owners believe they dropped the same reference, which silently
    corrupts attention output once the page is re-issued.
    """

    def __init__(self, n_pages: int, reserved: int = 1):
        if n_pages <= reserved:
            raise ValueError(f"need more than {reserved} pages, got {n_pages}")
        self.n_pages = n_pages
        self.reserved = reserved
        self._free: List[int] = list(range(n_pages - 1, reserved - 1, -1))
        self._ref: Dict[int, int] = {}       # live page id -> owner count

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_live(self) -> int:
        return len(self._ref)

    def refcount(self, i: int) -> int:
        """Current owner count of page ``i`` (0 if the page is free)."""
        return self._ref.get(i, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n page ids at refcount 1, or None (no side effects) if fewer free."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        ids = [self._free.pop() for _ in range(n)]
        for i in ids:
            self._ref[i] = 1
        return ids

    def retain(self, ids: Sequence[int]) -> None:
        """Add one owner to each live page; retaining a free page raises."""
        for i in ids:
            if i not in self._ref:
                raise ValueError(f"retain of free / foreign page id {i}")
        for i in ids:
            self._ref[i] += 1

    def release(self, ids: Sequence[int]) -> List[int]:
        """Drop one owner per id; returns the ids that actually went free."""
        freed = []
        for i in ids:
            n = self._ref.get(i, 0)
            if n <= 0:
                raise ValueError(f"double free / foreign page id {i}")
            if n == 1:
                del self._ref[i]
                self._free.append(i)
                freed.append(i)
            else:
                self._ref[i] = n - 1
        return freed

    # the reference's historical name: single-owner callers treat "free" as
    # "drop my reference", which is exactly what release does
    free = release


def chain_keys(tokens: np.ndarray, page_size: int) -> List[bytes]:
    """Content-addressed keys for every FULL page of ``tokens``.

    ``keys[i]`` commits to pages 0..i (the hash chains the previous key), so
    equal keys mean the whole prefix up to and including page ``i`` is
    token-identical — a page's K/V depends on every earlier position, so the
    prefix cache must never match on page content alone.
    """
    keys = []
    prev = b"paged-prefix-v1"
    toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
    for i in range(len(toks) // page_size):
        h = hashlib.blake2b(digest_size=16)
        h.update(prev)
        h.update(toks[i * page_size: (i + 1) * page_size].tobytes())
        prev = h.digest()
        keys.append(prev)
    return keys


class PrefixCache:
    """Content-addressed prefix index over the page pool.

    Maps ``chain_keys`` entries (the chained hash of a full-page prompt run)
    to the physical page holding that run's K/V. The cache holds ONE
    reference on every indexed page, so cached runs outlive the sequence
    that produced them; ``evict_lru`` retires entries whose page has no other
    owner (refcount 1) in least-recently-matched order when the allocator
    runs dry, and ``clear`` drops every cache reference (pages still owned
    by live slots survive — they just stop being findable).
    """

    def __init__(self, allocator: PageAllocator,
                 max_entries: Optional[int] = None):
        self.allocator = allocator
        self.max_entries = max_entries
        self._runs: "collections.OrderedDict[bytes, int]" = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._runs)

    def lookup(self, keys: Sequence[bytes]) -> List[int]:
        """Longest indexed prefix run of ``keys`` -> page ids, RETAINED for
        the caller (one new reference per returned page)."""
        run: List[int] = []
        for k in keys:
            pid = self._runs.get(k)
            if pid is None:
                self.misses += 1
                break
            self._runs.move_to_end(k)
            run.append(pid)
        self.hits += len(run)
        self.allocator.retain(run)
        return run

    def insert(self, key: bytes, page_id: int) -> bool:
        """Index ``page_id`` under ``key`` (cache takes its own reference).
        Returns False (no reference taken) if the key is already present."""
        if key in self._runs:
            self._runs.move_to_end(key)
            return False
        self.allocator.retain([page_id])
        self._runs[key] = page_id
        if self.max_entries is not None and len(self._runs) > self.max_entries:
            self.evict_lru(len(self._runs) - self.max_entries)
        return True

    def evict_lru(self, n_pages: int) -> int:
        """Retire up to ``n_pages`` unreferenced entries (LRU first).

        Only entries whose page the cache is the SOLE owner of (refcount 1)
        are retired — pages still aliased into live block tables must keep
        their index entry, releasing them would not free memory anyway.
        """
        freed = 0
        if n_pages <= 0:
            return 0
        for key in list(self._runs):
            pid = self._runs[key]
            if self.allocator.refcount(pid) == 1:
                del self._runs[key]
                self.allocator.release([pid])
                freed += 1
                if freed >= n_pages:
                    break
        return freed

    def clear(self) -> None:
        """Drop every cache reference (end-of-run drain)."""
        for pid in self._runs.values():
            self.allocator.release([pid])
        self._runs.clear()


class PagedKVCache:
    """Device page pools for every layer plus the host-side page allocator.

    ``pools`` maps ``"k"``/``"v"`` (and ``"k_scale"``/``"v_scale"`` for an
    int8 cache) to (L, n_pages, page_size, ...) tensors on ``device``,
    written in place by the serving steps.
    """

    def __init__(self, cfg: ModelConfig, n_pages: int, page_size: int,
                 max_pages_per_seq: int, device="cuda"):
        if cfg.block_pattern not in ("dense", "moe"):
            raise ValueError(
                f"paged KV cache requires an attention cache; "
                f"block_pattern={cfg.block_pattern!r} keeps O(1) state")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.page_size = page_size
        self.n_pages = n_pages
        self.max_pages_per_seq = max_pages_per_seq
        self.allocator = PageAllocator(n_pages)
        L, Hkv, hd = cfg.n_layers, cfg.n_kv_heads, cfg.resolved_head_dim
        self.quantized = cfg.kv_cache_dtype == "int8"
        dt = getattr(torch, cfg.compute_dtype)
        kv_dt = torch.int8 if self.quantized else dt
        shape = (L, n_pages, page_size, Hkv, hd)
        self.pools = {"k": torch.zeros(shape, dtype=kv_dt, device=self.device),
                      "v": torch.zeros(shape, dtype=kv_dt, device=self.device)}
        if self.quantized:
            for key in ("k_scale", "v_scale"):
                self.pools[key] = torch.zeros(shape[:-1], dtype=dt,
                                              device=self.device)

    # -- geometry ----------------------------------------------------------

    def pages_for(self, n_tokens: int) -> int:
        return max(1, -(-n_tokens // self.page_size))

    def pool_bytes(self) -> int:
        return sum(a.numel() * a.element_size() for a in self.pools.values())

    def dense_equiv_bytes(self, batch: int, max_len: int) -> int:
        """What a contiguous (B, max_len) cache would cost at the same dtype."""
        per_tok = sum(
            int(np.prod(a.shape[3:])) * a.element_size() * a.shape[0]
            for a in self.pools.values())
        return batch * max_len * per_tok

    # -- block tables ------------------------------------------------------

    def block_table_row(self, page_ids: Sequence[int]) -> np.ndarray:
        """(max_pages_per_seq,) int32 row, padded with the null page."""
        if len(page_ids) > self.max_pages_per_seq:
            raise ValueError(
                f"sequence needs {len(page_ids)} pages > "
                f"max_pages_per_seq={self.max_pages_per_seq}")
        row = np.full((self.max_pages_per_seq,), NULL_PAGE, np.int32)
        row[: len(page_ids)] = page_ids
        return row

    def gather_tokens(self, page_ids: Sequence[int], length: int) -> dict:
        """Read the first ``length`` token rows of a sequence back out of the
        pool: {key: (L, length, ...)} in token order. Test/debug helper — the
        serving path never materialises this contiguous view."""
        ids = torch.as_tensor(list(page_ids), dtype=torch.long,
                              device=self.device)
        out = {}
        for key, pool in self.pools.items():
            rows = pool[:, ids]                          # (L, n, psz, ...)
            rows = rows.reshape((rows.shape[0], -1) + tuple(rows.shape[3:]))
            out[key] = rows[:, :length]
        return out

    # -- copy-on-write fork ------------------------------------------------

    def fork_page(self, src: int, dst: int) -> None:
        """Copy page ``src``'s rows (every layer, every pool leaf) into
        ``dst`` — the copy-on-write fork run by the batcher before a decode
        write would mutate a page that still has other owners."""
        copy_page(self.pools, src, dst)

    # -- prefill write (the contiguous path) -------------------------------

    def write_prefill(self, page_ids: Sequence[int], cache: dict,
                      length: int) -> None:
        """Scatter a freshly prefilled contiguous cache into the pool, in
        place.

        ``cache`` is ``model.prefill``'s cache for ONE sequence (leaves
        (L, 1, S_pad, ...)) with ``S_pad >= len(page_ids) * page_size``
        covering the ``length``-token prompt. Rows past ``length`` inside
        the last page carry whatever the cache held there: reads mask them
        by the sequence's length.

        The batcher admits through the chunked paged prefill
        (``serving/prefill.py``) and never calls this; it is the path the
        equivalence tests compare that prefill against.
        """
        n = len(page_ids)
        need = self.pages_for(length)
        if n < need:
            raise ValueError(f"{n} pages cannot hold {length} tokens")
        ids = torch.as_tensor(list(page_ids), dtype=torch.long,
                              device=self.device)
        for key, pool in self.pools.items():
            src = cache[key][:, 0]                       # (L, S_pad, ...)
            if src.shape[1] < n * self.page_size:
                raise ValueError(
                    f"prefill cache depth {src.shape[1]} < {n} pages")
            src = src[:, : n * self.page_size]
            src = src.reshape((src.shape[0], n, self.page_size)
                              + tuple(src.shape[2:]))
            pool[:, ids] = src.to(device=pool.device, dtype=pool.dtype)
