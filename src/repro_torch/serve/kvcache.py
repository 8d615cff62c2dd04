"""KV caches of the port: the paged cache (counterpart of ``PagedCache`` in
the JAX ``repro.serve.kvcache``, with its host-RAM page tier and its split
over 1-D and 2-D meshes) and the contiguous one (``ContiguousCache``: dense
(L, B, S, KV, D) rows, every slot reserving ``max_seq`` positions, written
in place).

Storage is a per-layer (L, P, page, KV, D) K and V pool on the device; each
slot owns a row of a host-side (B, M) int32 page table mapping logical page
-> physical page.  ``alloc`` reserves ``ceil(length / page)`` pages up front
(returning ``None`` to defer admission when the pool is short) and shares
full prompt pages between requests with the same token prefix: pages are
keyed by the prefix they causally depend on and refcounted.  Physical page 0
is the scratch page: never allocated, it is where freed slots' table rows
point, so masked writes of inactive slots land in garbage space.

With ``kv_dtype="int8"`` the pools hold int8 rows and two (L, P, page, KV)
fp32 pools, ``k_scale`` and ``v_scale``, hold one scale per row
(``repro_torch.kernels.quant.quantize_kv``): ``2·L·KV·(D + 4)`` bytes per
position instead of ``2·L·KV·D·itemsize``.  Rows are quantized before they
are written (``quantize_block`` for a prefill block, the attention block for
a decode row); the write helpers refuse a float block for an int8 pool.

Sharded pools (``pool_group``, a ``repro_torch.parallel.pagedkv.PoolGroup``
of n ranks): the pool is padded to a multiple of n pages and rank c holds
global pages ``[c*P/n, (c+1)*P/n)`` plus one sink page past them, where
writes that belong to another rank land (``memory_stats`` counts it).  Every
rank keeps the same host-side bookkeeping and the same global page table.
On a 2-D batch x pages mesh ``pool_group`` is the rank's model group and
``dp_group`` its dp group (the JAX ``dp_axis``): the pool is split over the
model group and replicated across the dp group, whose ranks split the
attention's batch rows.  The free list is per chip and locality-first: a
request's fresh pages come from the one chip that fits them with the fewest
to spare, or spill across chips from the fullest; admission depends only on
the total free count.  ``locality_chips`` partitions the free list the same
way without sharding the tensors (the JAX cache's mesh-free knob).

Multi-tenant serving: ``alloc``/``alloc_chunked`` take a ``tenant`` whose
whole footprint is charged against its page quota (``set_quota``) at
admission; a deny sets ``last_deny`` to ``"quota"`` or ``"pool"``, and
``evict`` releases a preempted slot.  Fault tolerance: ``poison_page``
writes NaN into a page in place (its scales on an int8 pool; on a sharded
pool only the rank holding it writes), ``unregister_pages`` takes suspect
pages out of prefix sharing, and ``fail_chip`` drains a chip's pages for
good, so ``usable_pages`` shrinks (on a sharded pool the rank keeps
running: the loss is simulated in the bookkeeping, as in JAX).

**Host-RAM page tier** (``host_pages``/``prefix_store``,
``repro_torch.serve.offload``): when a registered prefix page's last
reference drops, ``free`` enqueues its copy into a pinned host buffer on the
compute stream at once.  JAX takes an immutable slice there and reads it
later; here ``pool[:, pid]`` is a view of a pool that the next admission,
usually handed this very page, rewrites, so the copy has to be ordered
before that write.  ``drain_offloads`` (before a store lookup, in
``memory_stats`` and ``verify``) waits on each copy's event and puts the
page into the store.  An admission whose prompt runs past its device-shared
pages into pages the store holds claims fresh device pages for them and
copies the bytes in place (``_prefetch``), so the pools' addresses, which
the decode graph captured, never change; the copies' event fences the slab
slots they read.  Behind a split pool the owning rank copies the page and
the drain broadcasts it over the model group, so every rank's store is the
same and every rank's finite check of a prefetched payload agrees.

All bookkeeping is host-side numpy.  Unlike the JAX cache, whose pools are
immutable values threaded through each dispatch, the pools here are written
in place by the prefill scatter, the prefetch and the decode step, and
never re-allocated.  The device page table is one tensor for the life of the
cache (a ``StagedBuffer``), refreshed from the numpy table when alloc or
free has changed it, so a CUDA graph of the decode step reads it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.kernels.quant import check_pool_write, quantize_kv
from repro_torch.models.common import resolve_device
from repro_torch.models.transformer import init_cache
from repro_torch.parallel.pagedkv import (chip_of_page, chip_page_range,
                                          sharded_write_prefill)
from repro_torch.serve.offload import PrefixStore

#: fp32 bytes of the scale stored beside each int8 K/V row.
SCALE_BYTES = 4

KV_DTYPES = ("native", "int8")

#: float dtype -> (integer view, exponent mask): all exponent bits set is
#: NaN or Inf
_EXPONENT_BITS = {torch.bfloat16: (torch.int16, 0x7F80),
                  torch.float16: (torch.int16, 0x7C00),
                  torch.float32: (torch.int32, 0x7F800000)}


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def kv_position_bytes(cfg, dtype: torch.dtype,
                      kv_dtype: str = "native") -> int:
    """Bytes of K+V cache per token position (all layers): ``2·L·KV·D`` in
    ``dtype``, or for int8 pages ``2·L·KV·(D + 4)`` (a row and its
    scale)."""
    l, kvh, hd = cfg.num_layers, cfg.num_kv_heads, cfg.resolved_head_dim
    if kv_dtype == "int8":
        return 2 * l * kvh * (hd + SCALE_BYTES)
    assert kv_dtype == "native", kv_dtype
    return 2 * l * kvh * hd * _itemsize(dtype)


def contiguous_kv_bytes(cfg, batch: int, max_seq: int,
                        dtype: torch.dtype) -> int:
    """Device bytes of a dense cache: every slot reserves max_seq
    positions."""
    return batch * max_seq * kv_position_bytes(cfg, dtype)


def page_kv_bytes(cfg, page_size: int, dtype: torch.dtype,
                  kv_dtype: str = "native") -> int:
    """Device bytes of one physical page (all layers, K+V, int8 scales
    included)."""
    return page_size * kv_position_bytes(cfg, dtype, kv_dtype)


def decode_transient_bytes(cfg, batch: int, max_pages: int, page_size: int,
                           dtype: torch.dtype, decode_impl: str = "kernel",
                           kv_dtype: str = "native") -> int:
    """Per-decode-step transient of the paged K/V read path, one layer.

    ``"gather"`` builds two dense (B, M·page, KV, D) views; for int8 pages
    also the gathered scales and the views dequantized to ``dtype``.
    ``"kernel"`` (K1): each (slot, kv-head) block stages one (page, D) K and
    V tile (int8 rows and their scales in the int8 mode) plus fp32 softmax
    state, independent of B and M.  The JAX function's byte math, whose
    ``"pallas"`` is this ``"kernel"``."""
    itemsize = _itemsize(dtype)
    kvh, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    if decode_impl == "gather":
        rows = 2 * batch * max_pages * page_size * kvh
        if kv_dtype == "int8":
            return rows * (hd + SCALE_BYTES) + rows * hd * itemsize
        return rows * hd * itemsize
    assert decode_impl == "kernel", decode_impl
    g = cfg.num_heads // kvh
    if kv_dtype == "int8":
        return 2 * page_size * (hd + SCALE_BYTES) + 4 * g * (hd + 2)
    return 2 * page_size * hd * itemsize + 4 * g * (hd + 2)


def prefill_transient_bytes(cfg, group: int, block_len: int, dtype,
                            kv_dtype: str = "native") -> int:
    """Per-rank transient of the sharded paged prefill write path: the
    (group, block_len) staged K/V block each rank scatters from,
    O(group·block) and independent of the pool's width P (a replicated
    pool-sized temporary would be ``P · page_kv_bytes``).  The JAX
    function's byte math."""
    return group * block_len * kv_position_bytes(cfg, dtype, kv_dtype)


class StagedBuffer:
    """A device tensor of fixed shape, refreshed from a host copy.  ``dev``
    is the same tensor for the life of the buffer, so a CUDA graph can read
    it; ``set`` writes the host copy (pinned on CUDA) and enqueues its copy
    to the device without blocking the host.  On CUDA an event makes
    ``set`` wait until the previous copy has read the host copy."""

    def __init__(self, shape, dtype: torch.dtype, device: torch.device):
        cuda = device.type == "cuda"
        self.host = torch.zeros(shape, dtype=dtype, pin_memory=cuda)
        self.dev = torch.zeros(shape, dtype=dtype, device=device)
        self._copied = torch.cuda.Event() if cuda else None

    def set(self, values) -> None:
        if self._copied is not None:
            self._copied.synchronize()
        self.host.numpy()[...] = values
        self.dev.copy_(self.host, non_blocking=True)
        if self._copied is not None:
            self._copied.record()


class CacheInvariantError(AssertionError):
    """Raised by ``PagedCache.verify`` when the allocator's bookkeeping
    breaks an invariant."""


@dataclass
class MemoryStats:
    backend: str
    bytes_total: int          # device bytes pinned by the pools
    bytes_reserved: int       # portion reserved by live requests
    page_size: int = 0        # paged only
    pages_total: int = 0      # usable pages (scratch excluded)
    pages_in_use: int = 0
    pages_shared: int = 0     # pages with refcount > 1 (prefix sharing)
    kv_dtype: str = "native"  # page element format ("native" / "int8")
    bytes_scales: int = 0     # portion of bytes_total pinned by int8 scales
    mesh_chips: int = 1       # chips (ranks) the pool is split over
    bytes_per_chip: int = 0   # bytes_total / mesh_chips
    bytes_scales_per_chip: int = 0
    bytes_sink_per_chip: int = 0  # a sharded rank's sink page, beside it
    slots_total: int = 0
    slots_in_use: int = 0     # slots holding a request
    chips_failed: int = 0     # chips drained by fail_chip (degraded pool)
    # footprint pages charged per tenant (empty without tenant tags)
    tenant_pages: Dict[str, int] = field(default_factory=dict)
    # the host-RAM page tier: prefix pages resident in the PrefixStore's
    # host slabs (zero without the tier)
    host_pages_total: int = 0     # tier capacity (pages)
    host_pages_in_use: int = 0    # prefix pages stored
    host_bytes: int = 0           # wire bytes they pin in host RAM


class PagedCache:
    backend = "paged"

    def __init__(self, cfg, batch: int, max_seq: int, page_size: int = 16,
                 num_pages: Optional[int] = None, prefix_sharing: bool = True,
                 device="cuda", dtype=torch.bfloat16,
                 kv_dtype: str = "native", pool_group=None,
                 locality_chips: Optional[int] = None, dp_group=None,
                 host_pages: int = 0, prefix_store=None):
        assert cfg.family in ("dense", "vlm", "moe"), (
            "paged KV is attention-cache families only "
            f"(family={cfg.family})")
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype {kv_dtype!r} not in {KV_DTYPES}")
        self.cfg, self.B, self.S = cfg, batch, max_seq
        self.page = page_size
        self.max_pages = -(-max_seq // page_size)              # M, per slot
        if num_pages is None:
            # full dense-equivalent capacity plus the scratch page
            num_pages = batch * self.max_pages + 1
        assert num_pages >= 2, "need at least scratch + one usable page"
        if pool_group is not None and locality_chips is not None:
            raise ValueError("locality_chips partitions the free list "
                             "without a pool group; with one, the chip "
                             "count is the group's size")
        assert dp_group is None or pool_group is not None, (
            "dp_group splits dispatch batch rows over a 2-D mesh; pass "
            "pool_group=")
        self.pool_group = pool_group
        self.dp_group = dp_group
        self.chips = (pool_group.size if pool_group is not None
                      else locality_chips or 1)
        # pad the pool so every chip holds the same number of pages
        num_pages = -(-num_pages // self.chips) * self.chips
        self.P = num_pages
        self.pages_per_chip = num_pages // self.chips
        self.device = resolve_device(device)
        self.dtype = dtype                  # the compute dtype
        self.kv_dtype = kv_dtype
        self.quantized = kv_dtype == "int8"
        self.prefix_sharing = prefix_sharing
        # this rank's shard of the pages and its sink page, or all of them
        local_pages = (self.pages_per_chip + 1 if pool_group is not None
                       else num_pages)
        shape = (cfg.num_layers, local_pages, page_size, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        pool_dtype = torch.int8 if self.quantized else dtype
        layers = {name: torch.zeros(shape, dtype=pool_dtype,
                                    device=self.device) for name in "kv"}
        if self.quantized:
            # one fp32 scale per (layer, page, row, kv-head)
            for name in ("k_scale", "v_scale"):
                layers[name] = torch.zeros(shape[:4], dtype=torch.float32,
                                           device=self.device)
        self.state = {"layers": layers}
        self.page_table = np.zeros((batch, self.max_pages), np.int32)
        self._table = StagedBuffer(self.page_table.shape, torch.int32,
                                   self.device)
        self._table_stale = False
        # per-chip free stacks, pop() handing out the chip's lowest id;
        # scratch 0 (chip 0) never listed
        self._free_chip: List[List[int]] = [
            [pid for pid in reversed(chip_page_range(c, self.pages_per_chip))
             if pid != 0] for c in range(self.chips)]
        self._ref = np.zeros(num_pages, np.int32)
        self._hash_to_page: Dict[bytes, int] = {}
        self._page_to_hash: Dict[int, bytes] = {}
        self._slot_pages: List[List[int]] = [[] for _ in range(batch)]
        self._slot_shared: List[int] = [0] * batch    # leading shared pages
        # pages each chunked slot will still claim (``extend``)
        self._slot_need: List[int] = [0] * batch
        self._shielded: set = set()       # mid-prefill slots (decode_view)
        # tenancy: each slot's whole footprint is charged to its tenant at
        # admission, so a chunked slot's ``extend`` never meets its quota
        self._quota: Dict[str, int] = {}
        self._slot_tenant: List[Optional[str]] = [None] * batch
        self._slot_charge: List[int] = [0] * batch
        self._tenant_pages: Dict[str, int] = {}
        #: why the last ``alloc``/``alloc_chunked`` returned ``None``:
        #: "pool" (the engine stops admitting) or "quota" (it skips the
        #: request and admits others)
        self.last_deny: Optional[str] = None
        #: chips drained by ``fail_chip``: their pages never return
        self._failed_chips: set = set()
        # the host-RAM page tier: ``prefix_store`` is owned by the caller
        # and outlives this cache; ``host_pages`` alone builds a private
        # store.  The store key is the sharing key, so sharing is required
        self.store = None
        if prefix_store is not None or host_pages:
            assert prefix_sharing, (
                "the host page tier stores pages under the prefix-sharing "
                "key; construct the cache with prefix_sharing=True")
            self.store = (prefix_store if prefix_store is not None
                          else PrefixStore(host_pages))
            # one page of every pool: the pool's shape without its P dim
            self._page_spec = {name: ((t.shape[0], *t.shape[2:]), t.dtype)
                               for name, t in layers.items()}
            self.store.bind(self._page_spec, pin=self.device.type == "cuda")
        #: device-to-host page copies started by ``free`` and not yet in
        #: the store: (key, host buffer, owning rank, event), drained at
        #: the next lookup, stats or verify point
        self._pending_offload: List[tuple] = []
        self._pending_keys: set = set()

    # ------------------------------------------------------------ sizing ----
    def pages_needed(self, length: int) -> int:
        return -(-length // self.page)

    def usable_pages(self) -> int:
        """Pages the allocator can ever hand out: the pool minus scratch
        minus every failed chip's pages (scratch is on chip 0, so a failed
        chip 0 loses one page fewer)."""
        lost = sum(self.pages_per_chip - (1 if c == 0 else 0)
                   for c in self._failed_chips)
        return self.P - 1 - lost

    def can_ever_fit(self, length: int) -> bool:
        return (length <= self.S
                and self.pages_needed(length) <= self.usable_pages())

    # ------------------------------------------------------------- alloc ----
    def _free_count(self) -> int:
        return sum(len(f) for f in self._free_chip)

    def _take_fresh(self, need: int) -> List[int]:
        """Pop ``need`` pages, locality-first: from the chip that fits them
        with the fewest free pages to spare, else across chips from the
        fullest down.  The caller has checked ``need <= _free_count()``, so
        placement never decides admission."""
        fits = [c for c in range(self.chips)
                if len(self._free_chip[c]) >= need]
        order = ([min(fits, key=lambda c: (len(self._free_chip[c]), c))]
                 if fits else
                 sorted(range(self.chips),
                        key=lambda c: (-len(self._free_chip[c]), c)))
        out: List[int] = []
        for c in order:
            while self._free_chip[c] and len(out) < need:
                out.append(self._free_chip[c].pop())
        assert len(out) == need, (len(out), need)
        return out

    def slot_freeable(self, slot: int) -> int:
        """Pages ``free(slot)``/``evict(slot)`` would return: shared pages
        may outlive the slot, so only refcount-1 pages count."""
        return sum(int(self._ref[p] == 1) for p in self._slot_pages[slot])

    def _banker_items(self, skip: Optional[int] = None):
        """(remaining need, pages freed on completion) per live slot but
        ``skip``."""
        return [(self._slot_need[s], self.slot_freeable(s))
                for s in range(self.B)
                if s != skip and (self._slot_pages[s] or self._slot_need[s])]

    @staticmethod
    def _safe(free: int, items) -> bool:
        """Banker's check: the live slots complete in some order iff, by
        ascending need, each fits in the pool grown by earlier frees."""
        for need, freeable in sorted(items):
            if need > free:
                return False
            free += freeable
        return True

    def _grant_safe(self, take: int, remaining: int,
                    skip: Optional[int] = None,
                    extra_freeable: int = 0) -> bool:
        """Would granting ``take`` fresh pages to a slot that will still
        need ``remaining`` more leave the pool banker-safe?  ``skip`` names
        the grantee when it is live already: its entry is replaced by the
        post-grant one, which frees ``extra_freeable`` more pages."""
        free = self._free_count()
        if take > free:
            return False
        return self._safe(free - take, self._banker_items(skip)
                          + [(remaining, take + extra_freeable)])

    # ------------------------------------------------------------ tenancy ----
    def set_quota(self, tenant: str, pages: Optional[int]) -> None:
        """Cap ``tenant``'s charged footprint pages (``None`` lifts the cap).
        A quota below current use only blocks new admissions."""
        if pages is None:
            self._quota.pop(tenant, None)
        else:
            assert pages >= 1, pages
            self._quota[tenant] = pages

    def tenant_pages(self, tenant: str) -> int:
        return self._tenant_pages.get(tenant, 0)

    def _quota_ok(self, tenant: Optional[str], n_total: int) -> bool:
        if tenant is None or tenant not in self._quota:
            return True
        return self.tenant_pages(tenant) + n_total <= self._quota[tenant]

    def _charge(self, slot: int, tenant: Optional[str], n_total: int) -> None:
        if tenant is None:
            return
        self._slot_tenant[slot] = tenant
        self._slot_charge[slot] = n_total
        self._tenant_pages[tenant] = self.tenant_pages(tenant) + n_total

    def evict(self, slot: int) -> int:
        """Preempt ``slot``: release its pages and its quota charge; returns
        how many pages re-entered the free pool.  The engine re-queues the
        request for a recompute-on-resume prefill, which re-shares its
        prompt pages if they are still registered."""
        freed = self.slot_freeable(slot)
        self.free(slot)
        return freed

    def _key(self, prefix: np.ndarray, page_idx: int) -> bytes:
        # K/V in page i depend on tokens[: (i + 1) * page] and nothing else
        return np.ascontiguousarray(
            prefix[: (page_idx + 1) * self.page], np.int32).tobytes()

    def alloc(self, slot: int, length: int,
              prefix: Optional[np.ndarray] = None,
              tenant: Optional[str] = None) -> Optional[int]:
        """Reserve pages covering ``length`` positions for ``slot``.
        ``prefix`` (the tokens to prefill) keys prefix sharing; ``tenant``
        is charged the footprint against its quota.  Returns the number of
        leading positions backed by shared pages, device-shared or
        prefetched from the host tier, or ``None`` to defer, with
        ``last_deny`` "quota" or "pool"."""
        assert not self._slot_pages[slot], f"slot {slot} already allocated"
        assert 0 < length <= self.S, (length, self.S)
        n_pages = self.pages_needed(length)
        self.last_deny = None
        if not self._quota_ok(tenant, n_pages):
            self.last_deny = "quota"
            return None                 # the tenant's cap, not the pool
        # only pages wholly inside the prompt are shareable: the page
        # holding the first decode write is always private
        shared, _, host_hits = self._match_shared(prefix, n_pages)
        # bump shared refs before the check: a page going ref 1 -> 2 stops
        # being freeable by its first owner (rolled back on deferral).
        # Host-tier hits still take fresh device pages: the check sees a
        # cold request's demand, only the recompute is saved
        for pid in shared:
            self._ref[pid] += 1
        if not self._grant_safe(n_pages - len(shared), 0):
            for pid in shared:
                self._ref[pid] -= 1
            self.last_deny = "pool"
            return None
        fresh = self._take_fresh(n_pages - len(shared))
        for pid in fresh:
            self._ref[pid] = 1
        pages = shared + fresh
        # granted: the host hits land in the first fresh pages (their
        # logical pages continue the device-shared run)
        self._prefetch(host_hits, fresh[:len(host_hits)])
        covered = len(shared) + len(host_hits)
        self.page_table[slot, :] = 0
        self.page_table[slot, :n_pages] = pages
        self._table_stale = True
        self._slot_pages[slot] = pages
        self._slot_shared[slot] = covered
        self._charge(slot, tenant, n_pages)
        # register this request's new full prompt pages now: their content
        # lands in the same admission's prefill
        if prefix is not None:
            self.register_landed(slot, prefix, len(prefix))
        return covered * self.page

    def _match_shared(self, prefix: Optional[np.ndarray], n_pages: int):
        """The prompt's leading full pages that need no recompute: returns
        ``(shared, full, host_hits)``.  ``shared`` are registered device
        pages, in order up to the first miss; ``host_hits`` continue the
        run with pages the host tier holds, ``(logical page, key,
        payload)`` for the caller to prefetch once its admission passes;
        ``full`` counts the shareable pages.  A host payload that is not
        finite is quarantined (a poisoned miss) and ends the run, so it
        never reaches the pools."""
        shared: List[int] = []
        host_hits: List[tuple] = []
        full = 0
        if self.prefix_sharing and prefix is not None:
            full = min(len(prefix) // self.page, n_pages)
            i = 0
            while i < full:
                pid = self._hash_to_page.get(self._key(prefix, i))
                if pid is None:
                    break
                shared.append(pid)
                i += 1
            if self.store is not None and i < full:
                self.drain_offloads()
                while i < full:
                    key = self._key(prefix, i)
                    payload = self.store.lookup(key)
                    if payload is None:
                        break
                    if not self._payload_finite(payload):
                        self.store.quarantine(key)
                        break
                    host_hits.append((i, key, payload))
                    i += 1
        return shared, full, host_hits

    # ------------------------------------------------------ host tier ----
    @staticmethod
    def _payload_finite(payload: Dict[str, torch.Tensor]) -> bool:
        """The prefetch's corruption guard: every float payload of the page
        (for int8 pages the scales, which carry a poison) is finite.  An
        IEEE value is NaN or Inf exactly when its exponent bits are all
        ones; testing them on an integer view of the slab reads a bf16
        page several times faster than ``torch.isfinite`` on the host."""
        for a in payload.values():
            if not a.is_floating_point():
                continue
            if a.dtype in _EXPONENT_BITS:
                view, mask = _EXPONENT_BITS[a.dtype]
                if bool(((a.view(view) & mask) == mask).any()):
                    return False
            elif not bool(torch.isfinite(a).all()):
                return False
        return True

    def _local_page(self, pid: int) -> Optional[int]:
        """``pid``'s index in this rank's pools, ``None`` if another rank
        of the split pool holds it."""
        if self.pool_group is None:
            return pid
        if chip_of_page(pid, self.pages_per_chip) != self.pool_group.rank:
            return None
        return pid - self.pool_group.rank * self.pages_per_chip

    def _prefetch(self, host_hits: List[tuple], pids: List[int]) -> None:
        """Copy ``host_hits``'s payloads from the slabs into the freshly
        claimed pages ``pids``, in place (only the rank holding a page
        writes it), and register their keys: the content has landed, so a
        later admission of the same batch shares it at once.  On the card
        the copies are asynchronous; their event fences the slab slots
        they read."""
        assert len(host_hits) == len(pids)
        if not host_hits:
            return
        wrote = False
        for (_, _, payload), pid in zip(host_hits, pids):
            local = self._local_page(pid)
            if local is None:
                continue
            for name, pool in self.state["layers"].items():
                check_pool_write(pool, payload[name], f"_prefetch[{name}]")
                pool[:, local].copy_(payload[name], non_blocking=True)
            wrote = True
        if wrote and self.device.type == "cuda":
            event = torch.cuda.Event()
            event.record()
            self.store.tier.fence(event)
        for (_, key, _), pid in zip(host_hits, pids):
            self._hash_to_page[key] = pid
            self._page_to_hash[pid] = key
        self.store.note_prefetch(len(host_hits))

    def _page_buffer(self) -> torch.Tensor:
        """A host buffer of one page's payloads: one flat uint8 tensor,
        pinned on the card (PyTorch's host allocator caches the blocks), so
        a copy into it is asynchronous and one broadcast moves it over a
        split pool."""
        return torch.empty(self.store.tier.page_bytes, dtype=torch.uint8,
                           pin_memory=self.device.type == "cuda")

    def _page_views(self, buf: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``buf``'s payloads, typed views in the pools' order."""
        views, at = {}, 0
        for name, (shape, dt) in self._page_spec.items():
            n = math.prod(shape) * _itemsize(dt)
            views[name] = buf[at:at + n].view(dt).view(shape)
            at += n
        return views

    def _offload(self, key: bytes, pid: int) -> None:
        """Start the device-to-host copy of page ``pid`` under ``key`` (from
        ``free``, as its last reference drops).  The copy is enqueued now,
        on the compute stream, so it reads the page before any later write
        into the pools; ``drain_offloads`` puts it into the store.  A key
        the store holds, or that is on its way, is only LRU-refreshed."""
        if self.store.has(key) or key in self._pending_keys:
            self.store.touch(key)
            return
        buf = self._page_buffer()
        local, event = self._local_page(pid), None
        if local is not None:
            views = self._page_views(buf)
            for name, pool in self.state["layers"].items():
                views[name].copy_(pool[:, local], non_blocking=True)
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
        owner = chip_of_page(pid, self.pages_per_chip)
        self._pending_offload.append((key, buf, owner, event))
        self._pending_keys.add(key)

    def drain_offloads(self) -> None:
        """Put every pending offloaded page into the store, in the order the
        pages were freed: wait on its copy's event, and behind a split pool
        broadcast its bytes from the owning rank over the model group
        (every rank drains at the same points, so the broadcasts pair up).
        Called before store lookups, from ``memory_stats`` and ``verify``,
        and harmlessly when nothing is pending."""
        if not self._pending_offload:
            return
        for key, buf, owner, event in self._pending_offload:
            if event is not None:
                event.synchronize()
            if self.pool_group is not None:
                self.pool_group.broadcast(buf, owner)
            self.store.put(key, self._page_views(buf))
        self._pending_offload.clear()
        self._pending_keys.clear()

    # ------------------------------------------------- chunked allocation ----
    def alloc_chunked(self, slot: int, length: int, first: int,
                      prefix: Optional[np.ndarray] = None,
                      tenant: Optional[str] = None) -> Optional[int]:
        """Admit ``slot`` for chunked prefill: claim the pages covering its
        first ``first`` positions now and record the rest of the
        ``length``-position footprint as the slot's remaining need, which
        ``extend`` claims chunk by chunk.  Admission needs the pool to stay
        banker-safe after the grant, a weaker demand than ``alloc``'s.
        Sharing matches only registered pages, whose content has landed.
        ``tenant`` is charged the whole footprint now.  Returns the leading
        positions backed by shared or prefetched pages, or ``None`` to defer
        (``last_deny`` as in ``alloc``)."""
        assert not self._slot_pages[slot], f"slot {slot} already allocated"
        assert 0 < first <= length <= self.S, (first, length, self.S)
        n_total = self.pages_needed(length)
        self.last_deny = None
        if not self._quota_ok(tenant, n_total):
            self.last_deny = "quota"
            return None
        shared, _, host_hits = self._match_shared(prefix, n_total)
        # host-tier hits are claimed and landed up front with the first
        # chunk: the chunks they cover skip their forward, so a later claim
        # would only bring the recompute back; the check still guards the
        # whole grant
        n_first = max(self.pages_needed(first) - len(shared), 0)
        n_first = max(n_first, len(host_hits))
        remaining = n_total - len(shared) - n_first
        for pid in shared:          # bumped before the check, as in alloc
            self._ref[pid] += 1
        if not self._grant_safe(n_first, remaining):
            for pid in shared:
                self._ref[pid] -= 1
            self.last_deny = "pool"
            return None
        fresh = self._take_fresh(n_first)
        for pid in fresh:
            self._ref[pid] = 1
        pages = shared + fresh
        self._prefetch(host_hits, fresh[:len(host_hits)])
        covered = len(shared) + len(host_hits)
        self.page_table[slot, :] = 0
        self.page_table[slot, :len(pages)] = pages
        self._table_stale = True
        self._slot_pages[slot] = pages
        self._slot_shared[slot] = covered
        self._slot_need[slot] = remaining
        self._charge(slot, tenant, n_total)
        return covered * self.page

    def extend(self, slot: int, cover: int) -> bool:
        """Grow ``slot``'s pages to cover ``cover`` positions (the next
        chunk's end, or the whole footprint on the final chunk).  Returns
        ``False`` when the grant is not banker-safe now: the chunk waits for
        completions to free pages, and some live slot can always
        complete."""
        have = len(self._slot_pages[slot])
        assert have > 0, f"slot {slot} has no chunked allocation"
        need = self.pages_needed(cover) - have
        if need <= 0:
            return True
        assert need <= self._slot_need[slot], (need, self._slot_need[slot])
        if not self._grant_safe(need, self._slot_need[slot] - need,
                                skip=slot,
                                extra_freeable=self.slot_freeable(slot)):
            return False
        fresh = self._take_fresh(need)
        for pid in fresh:
            self._ref[pid] = 1
        self.page_table[slot, have:have + need] = fresh
        self._table_stale = True
        self._slot_pages[slot].extend(fresh)
        self._slot_need[slot] -= need
        return True

    def register_landed(self, slot: int, prefix: np.ndarray,
                        upto: int) -> None:
        """Register ``slot``'s full prompt pages whose content has landed
        (positions [0, upto) written) for prefix sharing; idempotent."""
        if not self.prefix_sharing or prefix is None:
            return
        pages = self._slot_pages[slot]
        full = min(min(upto, len(prefix)) // self.page, len(pages))
        for i in range(self._slot_shared[slot], full):
            key, pid = self._key(prefix, i), pages[i]
            if key not in self._hash_to_page and \
                    pid not in self._page_to_hash:
                self._hash_to_page[key] = pid
                self._page_to_hash[pid] = key

    def table_row(self, slot: int) -> np.ndarray:
        """The slot's real (M,) table row, which a chunk dispatch reads
        (``decode_view`` may be shielding it)."""
        return self.page_table[slot].copy()

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

    def quantize_block(self, kv_block):
        """A prefill block in the pools' format: as it is for native pools;
        for int8 pools ``{"k", "v", "k_scale", "v_scale"}``, each row
        quantized with its own scale (the JAX ``_quantize_block``)."""
        if not self.quantized:
            return kv_block
        block = {}
        for name in ("k", "v"):
            block[name], block[name + "_scale"] = quantize_kv(kv_block[name])
        return block

    def staged_write_prefill(self, kv_block, dest) -> None:
        """Scatter a prefill block into the pools in place.  kv_block:
        ``{"k": (L, n, Sblk, KV, D), "v": ...}`` in the pools' format (for
        int8 pools from ``quantize_block``, with ``k_scale``/``v_scale``
        (L, n, Sblk, KV), which land through the same flat rows); dest
        (n, Sblk) flat rows from ``prefill_dest``.  Every scratch-routed
        position writes flat row 0; those duplicate writes race on CUDA,
        which is harmless because page 0 is never read by a live slot.  On
        a sharded pool each rank writes its own rows and sends the rest to
        its sink (``pagedkv.sharded_write_prefill``)."""
        pools = self.state["layers"]
        if set(kv_block) != set(pools):
            raise ValueError(f"staged_write_prefill: block holds "
                             f"{sorted(kv_block)}, the pools "
                             f"{sorted(pools)}")
        if self.pool_group is not None:
            sharded_write_prefill(self.pool_group, pools, kv_block, dest)
            return
        idx = dest.reshape(-1).long()
        for name, pool in pools.items():
            small = kv_block[name]
            check_pool_write(pool, small, f"staged_write_prefill[{name}]")
            big = pool.view(pool.shape[0], -1, *pool.shape[3:])
            big[:, idx] = small.reshape(small.shape[0], -1,
                                        *small.shape[3:]).to(pool.dtype)

    # ------------------------------------------------------------ decode ----
    def set_decode_shield(self, slot: int, shielded: bool) -> None:
        """Hide or expose ``slot``'s table row in ``decode_view``.  The
        decode step writes every slot, parked ones at position 0, which for
        a mid-prefill slot is its own first page; a shielded row reads as
        scratch, so that write lands there."""
        if shielded:
            self._shielded.add(slot)
        else:
            self._shielded.discard(slot)
        self._table_stale = True

    def decode_view(self):
        """Pools plus the (B, M) page table on the device: the same table
        tensor for the life of the cache, its contents refreshed here when
        an alloc, extend, free or shield has changed it; shielded rows are
        zero (scratch).  Sharded, the pools are this rank's shards with
        their sink pages and the table holds global ids."""
        if self._table_stale:
            table = self.page_table
            if self._shielded:
                table = table.copy()
                table[sorted(self._shielded)] = 0
            self._table.set(table)
            self._table_stale = False
        return {**self.state, "page_table": self._table.dev}

    # -------------------------------------------------------------- free ----
    def free(self, slot: int) -> None:
        for pid in self._slot_pages[slot]:
            self._ref[pid] -= 1
            if self._ref[pid] == 0:
                key = self._page_to_hash.pop(pid, None)
                if key is not None:
                    del self._hash_to_page[key]
                    # a registered page's content is a landed prefix: it
                    # spills to the host tier before the page is recycled
                    # (poison-recovered pages were unregistered first)
                    if self.store is not None:
                        self._offload(key, pid)
                # a failed chip's page leaves the pool with its last owner
                chip = chip_of_page(pid, self.pages_per_chip)
                if chip not in self._failed_chips:
                    self._free_chip[chip].append(pid)
        self._slot_pages[slot] = []
        self._slot_shared[slot] = 0
        self._slot_need[slot] = 0
        self._shielded.discard(slot)
        tenant = self._slot_tenant[slot]
        if tenant is not None:
            left = self._tenant_pages[tenant] - self._slot_charge[slot]
            if left:
                self._tenant_pages[tenant] = left
            else:
                del self._tenant_pages[tenant]
            self._slot_tenant[slot] = None
            self._slot_charge[slot] = 0
        self.page_table[slot, :] = 0    # point the freed slot at scratch
        self._table_stale = True

    # ---------------------------------------------------- fault tolerance ----
    def poison_page(self, pid: int) -> None:
        """Overwrite page ``pid``'s content with NaN, in place (the
        ``poison_page`` fault: corruption in device memory).  An int8 row
        has no NaN, so on an int8 pool the page's scales are poisoned.  On
        a sharded pool only the rank holding the page writes it, at its
        local index.  The bookkeeping is untouched: the reader (the decode
        step's non-finite guard) has to find it."""
        assert 0 < pid < self.P, (pid, self.P)
        local = pid
        if self.pool_group is not None:
            if chip_of_page(pid, self.pages_per_chip) != self.pool_group.rank:
                return
            local = pid - self.pool_group.rank * self.pages_per_chip
        names = ("k_scale", "v_scale") if self.quantized else ("k", "v")
        for name in names:
            self.state["layers"][name][:, local] = float("nan")

    def unregister_pages(self, pages: List[int]) -> None:
        """Take ``pages`` out of prefix sharing (content lost or suspect):
        their sharers keep them, but no new request maps them, so a
        poisoned prompt page cannot re-share into a resume prefill."""
        for pid in pages:
            key = self._page_to_hash.pop(pid, None)
            if key is not None:
                del self._hash_to_page[key]

    def fail_chip(self, chip: int) -> List[int]:
        """Drain ``chip`` from the pool (a lost card): its free pages leave
        the free lists for good and its pages leave prefix sharing; returns
        the slots holding a page there, for the engine to recover.  A
        sharded pool keeps every rank running and merging: the loss is in
        the bookkeeping.  Idempotent per chip.  A chunked slot whose
        remaining need outgrew the surviving pool stalls until the watchdog
        recovers it."""
        assert 0 <= chip < self.chips, (chip, self.chips)
        if chip in self._failed_chips:
            return []
        self._failed_chips.add(chip)
        self._free_chip[chip] = []
        span = chip_page_range(chip, self.pages_per_chip)
        self.unregister_pages([p for p in span if p in self._page_to_hash])
        return [s for s in range(self.B)
                if any(span.start <= p < span.stop
                       for p in self._slot_pages[s])]

    # ----------------------------------------------------------- checks ----
    def verify(self) -> None:
        """Check the allocator's invariants; raises CacheInvariantError
        naming the first one broken."""
        def check(cond, what):
            if not cond:
                raise CacheInvariantError(f"PagedCache.verify: {what}")

        owned = [pid for pages in self._slot_pages for pid in pages]
        free = [pid for chip in self._free_chip for pid in chip]
        check(0 not in owned and 0 not in free and self._ref[0] == 0,
              "scratch page 0 handed out, listed free, or refcounted")
        counts = (np.bincount(owned, minlength=self.P) if owned
                  else np.zeros(self.P, np.int64))
        check((self._ref == counts).all(),
              f"refcounts drifted from live references "
              f"(ref={self._ref.tolist()} vs owned={sorted(owned)})")
        check(len(free) == len(set(free)), "duplicate page in free lists")
        check(set(free).isdisjoint(owned),
              f"pages both free and owned: {set(free) & set(owned)}")
        lost = {p for c in self._failed_chips
                for p in chip_page_range(c, self.pages_per_chip)}
        check(not lost & set(free), "failed-chip page still listed free")
        check(not lost & set(owned), "failed-chip page still owned")
        check(set(free) | set(owned) == set(range(1, self.P)) - lost,
              "free and owned pages do not partition the pool")
        for c, chip in enumerate(self._free_chip):
            check(all(chip_of_page(pid, self.pages_per_chip) == c
                      for pid in chip),
                  f"page filed under wrong chip's free list ({c})")
        for s in range(self.B):
            pages = self._slot_pages[s]
            row = self.page_table[s]
            check(list(row[:len(pages)]) == pages,
                  f"slot {s} page-table row != owned pages")
            check((row[len(pages):] == 0).all(),
                  f"slot {s} page-table tail not parked on scratch")
            check(0 <= self._slot_shared[s] <= len(pages),
                  f"slot {s} shared-page count out of range")
            check(self._slot_need[s] >= 0,
                  f"slot {s} negative chunked-prefill need")
            check((self._slot_tenant[s] is None) ==
                  (self._slot_charge[s] == 0),
                  f"slot {s} tenant/charge mismatch")
        check(len(self._hash_to_page) == len(self._page_to_hash),
              "prefix registry maps differ in size")
        for key, pid in self._hash_to_page.items():
            check(self._page_to_hash.get(pid) == key,
                  f"prefix registry maps disagree on page {pid}")
            check(self._ref[pid] > 0,
                  f"registered prefix page {pid} has no owner")
        charges: Dict[str, int] = {}
        for s in range(self.B):
            t = self._slot_tenant[s]
            if t is not None:
                charges[t] = charges.get(t, 0) + self._slot_charge[s]
        check(charges == self._tenant_pages,
              f"tenant accounting drifted: {charges} "
              f"vs {self._tenant_pages}")
        st = self.memory_stats()
        pb = page_kv_bytes(self.cfg, self.page, self.dtype, self.kv_dtype)
        pools = self.state["layers"].values()
        pinned = (st.bytes_total if self.pool_group is None
                  else st.bytes_per_chip + st.bytes_sink_per_chip)
        check(st.pages_total == self.usable_pages()
              and st.pages_in_use == st.pages_total - len(free)
              and st.bytes_reserved == st.pages_in_use * pb
              and st.bytes_total == self.P * pb
              and pinned == sum(t.numel() * t.element_size() for t in pools),
              "memory_stats byte math inconsistent")
        if not self._failed_chips:
            # a chip failure may strand a chunked need (the watchdog's
            # case), so banker safety holds on intact pools only
            check(self._safe(len(free), self._banker_items()),
                  "pool not banker-safe (a live slot can never complete)")
        if self.store is not None:
            # memory_stats drained the offloads: the store is settled
            self.store.verify()
            check(st.host_pages_total == self.store.capacity
                  and st.host_pages_in_use == self.store.pages_in_use()
                  and st.host_bytes == self.store.bytes_in_use(),
                  "memory_stats host-tier accounting drifted from store")
            check(self.store.tier.page_bytes == pb,
                  "host tier page bytes != device wire page bytes")

    def memory_stats(self) -> MemoryStats:
        """The pools' byte and page accounting; with the host tier it first
        drains the pending offloads, so the host numbers are settled."""
        if self.store is not None:
            self.drain_offloads()
        pb = page_kv_bytes(self.cfg, self.page, self.dtype, self.kv_dtype)
        usable = self.usable_pages()
        in_use = usable - self._free_count()
        scale_b = (self.P * self.page * 2 * self.cfg.num_layers
                   * self.cfg.num_kv_heads * SCALE_BYTES
                   if self.quantized else 0)
        return MemoryStats(
            backend=self.backend, bytes_total=self.P * pb,
            bytes_reserved=in_use * pb,
            page_size=self.page, pages_total=usable, pages_in_use=in_use,
            pages_shared=int((self._ref > 1).sum()), kv_dtype=self.kv_dtype,
            bytes_scales=scale_b, mesh_chips=self.chips,
            bytes_per_chip=self.P * pb // self.chips,
            bytes_scales_per_chip=scale_b // self.chips,
            bytes_sink_per_chip=pb if self.pool_group is not None else 0,
            slots_total=self.B,
            slots_in_use=sum(bool(p) for p in self._slot_pages),
            chips_failed=len(self._failed_chips),
            tenant_pages=dict(self._tenant_pages),
            host_pages_total=self.store.capacity if self.store else 0,
            host_pages_in_use=(self.store.pages_in_use()
                               if self.store else 0),
            host_bytes=self.store.bytes_in_use() if self.store else 0)


class ContiguousCache:
    """Dense (L, B, S, KV, D) K and V rows, one row of ``max_seq`` positions
    per slot (the JAX ``ContiguousCache``).  ``alloc`` always succeeds
    (capacity is reserved up front, the memory ``PagedCache`` exists to
    save) and nothing is shared, so ``bytes_reserved == bytes_total``.  The
    rows are written in place by the prefill scatter and the decode step,
    and never re-allocated; ``decode_view`` is the cache ``decode_step``
    takes directly (no page table).  Inactive slots decode at position 0
    into row 0 of their own rows, which the next prefill rewrites."""

    backend = "contiguous"
    quantized = False           # int8 pages are a paged-format feature
    chips = 1
    store = None                # no pages, so no host tier
    last_deny = None            # alloc never fails, so never a deny reason

    def __init__(self, cfg, batch: int, max_seq: int, device="cuda",
                 dtype=torch.bfloat16):
        self.cfg, self.B, self.S = cfg, batch, max_seq
        self.device = resolve_device(device)
        self.dtype = dtype
        self.state = init_cache(cfg, batch, max_seq, self.device, dtype)
        self._in_use = np.zeros(batch, bool)
        self._bytes = sum(t.numel() * t.element_size()
                          for t in self.state["layers"].values())

    def can_ever_fit(self, length: int) -> bool:
        return length <= self.S

    def alloc(self, slot: int, length: int,
              prefix: Optional[np.ndarray] = None,
              tenant: Optional[str] = None) -> Optional[int]:
        """Reserve ``slot`` (its rows are always there): never defers, no
        position is shared and no quota is metered."""
        assert not self._in_use[slot], f"slot {slot} already allocated"
        assert 0 < length <= self.S, (length, self.S)
        self._in_use[slot] = True
        return 0

    def quantize_block(self, kv_block):
        return kv_block

    def staged_write_prefill(self, kv_block, slots) -> None:
        """Write a prefill block into its slots' rows in place.  kv_block:
        ``{"k": (L, n, Sblk, KV, D), "v": ...}``; slots (n,) slot ids.  Rows
        [0, Sblk) of each slot are overwritten, prompt padding included,
        which stays behind the decode mask until decode rewrites it."""
        slots = slots.long()
        rows = torch.arange(next(iter(kv_block.values())).shape[2],
                            device=slots.device)
        for name, cache in self.state["layers"].items():
            small = kv_block[name]
            check_pool_write(cache, small, f"staged_write_prefill[{name}]")
            cache[:, slots[:, None], rows[None, :]] = small.to(cache.dtype)

    def decode_view(self):
        return self.state

    def free(self, slot: int) -> None:
        self._in_use[slot] = False

    def memory_stats(self) -> MemoryStats:
        return MemoryStats(backend=self.backend, bytes_total=self._bytes,
                           bytes_reserved=self._bytes,
                           bytes_per_chip=self._bytes, slots_total=self.B,
                           slots_in_use=int(self._in_use.sum()))
