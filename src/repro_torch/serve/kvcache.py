"""Paged KV cache of the port (counterpart of ``PagedCache`` in the JAX
``repro.serve.kvcache``, without its quotas, eviction, chunked allocation,
host tier, int8 pages and meshes).

Storage is a per-layer (L, P, page, KV, D) K and V pool on the device; each
slot owns a row of a host-side (B, M) int32 page table mapping logical page
-> physical page.  ``alloc`` reserves ``ceil(length / page)`` pages up front
(returning ``None`` to defer admission when the pool is short) and shares
full prompt pages between requests with the same token prefix: pages are
keyed by the prefix they causally depend on and refcounted.  Physical page 0
is the scratch page: never allocated, it is where freed slots' table rows
point, so masked writes of inactive slots land in garbage space.

All bookkeeping is host-side numpy.  Unlike the JAX cache, whose pools are
immutable values threaded through each dispatch, the pools here are written
in place by the prefill scatter and the decode step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.common import resolve_device


def kv_position_bytes(cfg, dtype: torch.dtype) -> int:
    """Bytes of K+V cache per token position (all layers)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return 2 * cfg.num_layers * cfg.num_kv_heads * cfg.resolved_head_dim \
        * itemsize


def decode_transient_bytes(cfg, page_size: int, dtype: torch.dtype) -> int:
    """Per-decode-step transient of the paged K/V read path, one layer: each
    (slot, kv-head) block of K1 holds one (page, D) K and V tile plus fp32
    softmax state (the JAX gather path's dense view never exists)."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    hd = cfg.resolved_head_dim
    g = cfg.num_heads // cfg.num_kv_heads
    return 2 * page_size * hd * itemsize + 4 * g * (hd + 2)


class CacheInvariantError(AssertionError):
    """Raised by ``PagedCache.verify`` when the allocator's bookkeeping
    breaks an invariant."""


@dataclass
class MemoryStats:
    backend: str
    bytes_total: int          # device bytes pinned by the pools
    bytes_reserved: int       # portion reserved by live requests
    page_size: int
    pages_total: int          # usable pages (scratch excluded)
    pages_in_use: int
    pages_shared: int         # pages with refcount > 1 (prefix sharing)


class PagedCache:
    backend = "paged"

    def __init__(self, cfg, batch: int, max_seq: int, page_size: int = 16,
                 num_pages: Optional[int] = None, prefix_sharing: bool = True,
                 device="cuda", dtype=torch.bfloat16):
        assert cfg.family == "dense", cfg.family
        self.cfg, self.B, self.S = cfg, batch, max_seq
        self.page = page_size
        self.max_pages = -(-max_seq // page_size)              # M, per slot
        if num_pages is None:
            # full dense-equivalent capacity plus the scratch page
            num_pages = batch * self.max_pages + 1
        assert num_pages >= 2, "need at least scratch + one usable page"
        self.P = num_pages
        self.device = resolve_device(device)
        self.dtype = dtype
        self.prefix_sharing = prefix_sharing
        shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        self.state = {"layers": {
            "k": torch.zeros(shape, dtype=dtype, device=self.device),
            "v": torch.zeros(shape, dtype=dtype, device=self.device)}}
        self.page_table = np.zeros((batch, self.max_pages), np.int32)
        self._page_table_dev: Optional[torch.Tensor] = None
        # free stack: pop() hands out the lowest id; scratch 0 never listed
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._ref = np.zeros(num_pages, np.int32)
        self._hash_to_page: Dict[bytes, int] = {}
        self._page_to_hash: Dict[int, bytes] = {}
        self._slot_pages: List[List[int]] = [[] for _ in range(batch)]
        self._slot_shared: List[int] = [0] * batch    # leading shared pages
        # pages each slot was promised but has not claimed: always 0 while
        # ``alloc`` claims whole footprints (chunked allocation is later work)
        self._slot_need: List[int] = [0] * batch

    # ------------------------------------------------------------ sizing ----
    def pages_needed(self, length: int) -> int:
        return -(-length // self.page)

    def usable_pages(self) -> int:
        return self.P - 1

    def can_ever_fit(self, length: int) -> bool:
        return (length <= self.S
                and self.pages_needed(length) <= self.usable_pages())

    # ------------------------------------------------------------- alloc ----
    def _banker_items(self):
        """(remaining need, pages freed on completion) per live slot;
        shared pages may outlive the slot, so only refcount-1 pages count."""
        return [(self._slot_need[s],
                 sum(int(self._ref[p] == 1) for p in self._slot_pages[s]))
                for s in range(self.B)
                if self._slot_pages[s] or self._slot_need[s]]

    @staticmethod
    def _safe(free: int, items) -> bool:
        """Banker's check: the live slots complete in some order iff, by
        ascending need, each fits in the pool grown by earlier frees."""
        for need, freeable in sorted(items):
            if need > free:
                return False
            free += freeable
        return True

    def _grant_safe(self, take: int, remaining: int) -> bool:
        """Would granting ``take`` fresh pages to a new slot that will still
        need ``remaining`` more leave the pool banker-safe?"""
        free = len(self._free)
        if take > free:
            return False
        return self._safe(free - take,
                          self._banker_items() + [(remaining, take)])

    def _key(self, prefix: np.ndarray, page_idx: int) -> bytes:
        # K/V in page i depend on tokens[: (i + 1) * page] and nothing else
        return np.ascontiguousarray(
            prefix[: (page_idx + 1) * self.page], np.int32).tobytes()

    def alloc(self, slot: int, length: int,
              prefix: Optional[np.ndarray] = None) -> Optional[int]:
        """Reserve pages covering ``length`` positions for ``slot``.
        ``prefix`` (the prompt) keys prefix sharing.  Returns the number of
        leading positions backed by shared pages, or ``None`` to defer."""
        assert not self._slot_pages[slot], f"slot {slot} already allocated"
        assert 0 < length <= self.S, (length, self.S)
        n_pages = self.pages_needed(length)
        shared: List[int] = []
        full = 0
        if self.prefix_sharing and prefix is not None:
            # only pages wholly inside the prompt are shareable: the page
            # holding the first decode write is always private
            full = min(len(prefix) // self.page, n_pages)
            for i in range(full):
                pid = self._hash_to_page.get(self._key(prefix, i))
                if pid is None:
                    break
                shared.append(pid)
        # bump shared refs before the check: a page going ref 1 -> 2 stops
        # being freeable by its first owner (rolled back on deferral)
        for pid in shared:
            self._ref[pid] += 1
        if not self._grant_safe(n_pages - len(shared), 0):
            for pid in shared:
                self._ref[pid] -= 1
            return None
        fresh = [self._free.pop() for _ in range(n_pages - len(shared))]
        for pid in fresh:
            self._ref[pid] = 1
        pages = shared + fresh
        # register this request's new full prompt pages (their content
        # lands in the same admission's prefill)
        if self.prefix_sharing and prefix is not None:
            for i in range(len(shared), full):
                key = self._key(prefix, i)
                if key not in self._hash_to_page:
                    self._hash_to_page[key] = pages[i]
                    self._page_to_hash[pages[i]] = key
        self.page_table[slot, :] = 0
        self.page_table[slot, :n_pages] = pages
        self._page_table_dev = None
        self._slot_pages[slot] = pages
        self._slot_shared[slot] = len(shared)
        return len(shared) * self.page

    # ----------------------------------------------------------- prefill ----
    def prefill_dest(self, slot: int, block_len: int, valid_len: int,
                     shared_len: int = 0) -> np.ndarray:
        """Flat pool rows (page * page_size + row) for a prefill block's
        positions [0, block_len): the position-0 case of ``chunk_dest``."""
        return self.chunk_dest(slot, 0, valid_len, block_len, shared_len)

    def chunk_dest(self, slot: int, start: int, end: int, chunk_len: int,
                   shared_len: int = 0) -> np.ndarray:
        """Flat pool rows for positions [start, start + chunk_len) of
        ``slot``, of which only [max(start, shared_len), end) land: padding
        and positions backed by shared pages route to flat row 0, the
        scratch sink."""
        pos = start + np.arange(chunk_len)
        logical = np.minimum(pos // self.page, self.max_pages - 1)
        idx = self.page_table[slot, logical] * self.page + pos % self.page
        write = (pos >= shared_len) & (pos < end)
        return np.where(write, idx, 0).astype(np.int32)

    def staged_write_prefill(self, kv_block, dest) -> None:
        """Scatter a prefill block into the pools in place.  kv_block:
        ``{"k": (L, n, Sblk, KV, D), "v": ...}``; dest (n, Sblk) flat rows
        from ``prefill_dest``.  Every scratch-routed position writes flat
        row 0; those duplicate writes race on CUDA, which is harmless
        because page 0 is never read by a live slot."""
        idx = dest.reshape(-1).long()
        for name, pool in self.state["layers"].items():
            big = pool.view(pool.shape[0], -1, *pool.shape[3:])
            small = kv_block[name]
            big[:, idx] = small.reshape(small.shape[0], -1,
                                        *small.shape[3:]).to(pool.dtype)

    # ------------------------------------------------------------ decode ----
    def decode_view(self):
        """Pools plus the (B, M) page table on the device; the table's
        device copy is reused until the next alloc or free."""
        if self._page_table_dev is None:
            self._page_table_dev = torch.from_numpy(self.page_table).to(
                self.device)
        return {**self.state, "page_table": self._page_table_dev}

    # -------------------------------------------------------------- free ----
    def free(self, slot: int) -> None:
        for pid in self._slot_pages[slot]:
            self._ref[pid] -= 1
            if self._ref[pid] == 0:
                key = self._page_to_hash.pop(pid, None)
                if key is not None:
                    del self._hash_to_page[key]
                self._free.append(pid)
        self._slot_pages[slot] = []
        self._slot_shared[slot] = 0
        self._slot_need[slot] = 0
        self.page_table[slot, :] = 0    # point the freed slot at scratch
        self._page_table_dev = None

    # ----------------------------------------------------------- checks ----
    def verify(self) -> None:
        """Check the allocator's invariants; raises CacheInvariantError
        naming the first one broken."""
        def check(cond, what):
            if not cond:
                raise CacheInvariantError(f"PagedCache.verify: {what}")

        owned = [pid for pages in self._slot_pages for pid in pages]
        free = list(self._free)
        check(0 not in owned and 0 not in free and self._ref[0] == 0,
              "scratch page 0 handed out, listed free, or refcounted")
        counts = (np.bincount(owned, minlength=self.P) if owned
                  else np.zeros(self.P, np.int64))
        check((self._ref == counts).all(),
              "refcounts drifted from live references")
        check(len(free) == len(set(free)), "duplicate page in free list")
        check(set(free).isdisjoint(owned), "page both free and owned")
        check(set(free) | set(owned) == set(range(1, self.P)),
              "free and owned pages do not partition the pool")
        for s in range(self.B):
            pages = self._slot_pages[s]
            row = self.page_table[s]
            check(list(row[:len(pages)]) == pages,
                  f"slot {s} page-table row != owned pages")
            check((row[len(pages):] == 0).all(),
                  f"slot {s} page-table tail not parked on scratch")
            check(0 <= self._slot_shared[s] <= len(pages),
                  f"slot {s} shared-page count out of range")
        check(len(self._hash_to_page) == len(self._page_to_hash),
              "prefix registry maps differ in size")
        for key, pid in self._hash_to_page.items():
            check(self._page_to_hash.get(pid) == key,
                  f"prefix registry maps disagree on page {pid}")
            check(self._ref[pid] > 0,
                  f"registered prefix page {pid} has no owner")
        st = self.memory_stats()
        pb = self.page * kv_position_bytes(self.cfg, self.dtype)
        check(st.pages_in_use == st.pages_total - len(free)
              and st.bytes_reserved == st.pages_in_use * pb
              and st.bytes_total == self.P * pb,
              "memory_stats byte math inconsistent")
        check(self._safe(len(free), self._banker_items()),
              "pool not banker-safe (a live slot can never complete)")

    def memory_stats(self) -> MemoryStats:
        pb = self.page * kv_position_bytes(self.cfg, self.dtype)
        usable = self.usable_pages()
        in_use = usable - len(self._free)
        return MemoryStats(
            backend=self.backend, bytes_total=self.P * pb,
            bytes_reserved=in_use * pb,
            page_size=self.page, pages_total=usable, pages_in_use=in_use,
            pages_shared=int((self._ref > 1).sum()))
