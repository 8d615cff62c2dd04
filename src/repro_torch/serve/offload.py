"""Host-RAM page tier and persistent prefix store behind ``PagedCache`` (the
port's copy of the JAX ``repro.serve.offload``).

The device pool holds the hot KV pages of live requests; a shared prefix
whose last device reference drops spills to preallocated host slabs, and a
later admission whose prompt hash-hits the stored prefix copies the pages
back instead of recomputing them.  The store outlives a cache: pass one
``PrefixStore`` to successive engines and the later ones prefetch what the
earlier ones computed.

Two classes, layered as in JAX:

* :class:`HostPageTier`: a slab allocator over one host tensor per pool
  payload ("k", "v", and for int8 pools "k_scale", "v_scale").  Pages are
  stored in the pools' wire format (int8 rows and their fp32 scales for an
  int8 pool), so a round trip is a byte-exact copy.
* :class:`PrefixStore`: the map from a prefix key (the token bytes a page
  causally depends on) to a tier slot, indexed by a short blake2b digest;
  every entry keeps the full key, verified on each lookup, so a digest
  collision is a counted miss and never another prefix's bytes.  LRU
  eviction.

The one difference from JAX: the slabs are torch CPU tensors (numpy has no
bfloat16), pinned when the cache lives on a card, so the copies between
them and the pools are asynchronous.  ``read`` and ``lookup`` return views
of one slab slot.  A host-to-device copy out of a slot reads it after the
host has moved on, so the cache hands the copy's event to ``fence``, and
the tier waits on it before the host writes a slab again (``write``, after
an LRU eviction freed the slot, and ``PrefixStore.poison``).
"""
from __future__ import annotations

import hashlib
import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch


class HostTierError(AssertionError):
    """Raised by ``PrefixStore.verify`` / ``HostPageTier.verify`` when the
    host tier's bookkeeping breaks an invariant (the host-side sibling of
    ``CacheInvariantError``)."""


class HostPageTier:
    """Slab allocator over preallocated host page buffers.

    ``capacity`` pages; ``bind(spec)`` fixes the per-page payload layout
    (name -> (shape, torch dtype)) on first use and checks every later bind
    against it: a persistent store serves only caches with the identical
    page format.  The slabs are allocated at the first bind, one tensor a
    payload, pinned with ``pin=True``."""

    def __init__(self, capacity: int):
        assert capacity >= 1, capacity
        self.capacity = int(capacity)
        self._spec: Optional[Dict[str, Tuple[tuple, torch.dtype]]] = None
        self._slabs: Dict[str, torch.Tensor] = {}
        self._free: List[int] = list(range(capacity - 1, -1, -1))
        self._used: set = set()
        self._reads: list = []         # events of copies still reading slabs
        self.page_bytes = 0            # wire bytes of one page's payload

    def bind(self, spec: Dict[str, Tuple[tuple, torch.dtype]],
             pin: bool = False) -> None:
        norm = {name: (tuple(shape), dt) for name, (shape, dt) in spec.items()}
        if self._spec is not None:
            if norm != self._spec:
                raise HostTierError(
                    f"host tier bound to a different page format: "
                    f"{self._spec} vs {norm} (a persistent prefix store is "
                    f"reusable only across caches with identical page "
                    f"shape/dtype)")
            return
        self._spec = norm
        for name, (shape, dt) in norm.items():
            self._slabs[name] = torch.zeros((self.capacity, *shape), dtype=dt,
                                            pin_memory=pin)
        self.page_bytes = sum(
            math.prod(shape) * torch.empty((), dtype=dt).element_size()
            for shape, dt in norm.values())

    @property
    def bound(self) -> bool:
        return self._spec is not None

    def in_use(self) -> int:
        return len(self._used)

    def alloc_slot(self) -> Optional[int]:
        if not self._free:
            return None
        slot = self._free.pop()
        self._used.add(slot)
        return slot

    def free_slot(self, slot: int) -> None:
        assert slot in self._used, slot
        self._used.discard(slot)
        self._free.append(slot)

    def fence(self, event) -> None:
        """Hold the next host write to the slabs until ``event`` (a CUDA
        event recorded after copies that read slab slots) has completed."""
        self._reads.append(event)

    def settle(self) -> None:
        """Wait for every fenced copy: the slabs are then the host's to
        write."""
        for event in self._reads:
            event.synchronize()
        self._reads.clear()

    def write(self, slot: int, arrays) -> None:
        assert slot in self._used, slot
        assert set(arrays) == set(self._slabs), (
            set(arrays), set(self._slabs))
        self.settle()
        for name, a in arrays.items():
            self._slabs[name][slot].copy_(torch.as_tensor(a))

    def read(self, slot: int) -> Dict[str, torch.Tensor]:
        assert slot in self._used, slot
        return {name: slab[slot] for name, slab in self._slabs.items()}

    def verify(self) -> None:
        if sorted(self._free + list(self._used)) != list(range(self.capacity)):
            raise HostTierError(
                "host tier free/used slots do not partition the slab")


@dataclass
class _Entry:
    key: bytes          # the FULL prefix key bytes, verified on every lookup
    slot: int           # the tier slot holding the page's payload


class PrefixStore:
    """Digest-indexed, collision-verified, LRU host store of prefix pages.

    The key is ``PagedCache._key``'s token-prefix bytes, the whole causal
    input of the page's K/V, so a verified key match means the stored bytes
    are the page a recomputed prefill would write.  ``lookup`` verifies the
    full key (digest collisions count in ``stats()["collisions"]`` and
    miss); a consumer that finds the payload non-finite calls
    ``quarantine``, which drops the entry and records a poisoned miss."""

    #: digest width (bytes) of the index key, short on purpose: collisions
    #: must be handled, not made unlikely (tests shrink it to 1)
    digest_size = 16

    def __init__(self, host_pages: int):
        self.tier = HostPageTier(host_pages)
        self._entries: "OrderedDict[bytes, _Entry]" = OrderedDict()
        self._stats = {"hits": 0, "misses": 0, "collisions": 0,
                       "evictions": 0, "poisoned": 0, "offloads": 0,
                       "offload_bytes": 0, "prefetch_bytes": 0}

    # ------------------------------------------------------------- keys ----
    def _digest(self, key: bytes) -> bytes:
        return hashlib.blake2b(key, digest_size=self.digest_size).digest()

    # ------------------------------------------------------------ sizing ----
    @property
    def capacity(self) -> int:
        return self.tier.capacity

    def pages_in_use(self) -> int:
        return len(self._entries)

    def bytes_in_use(self) -> int:
        return len(self._entries) * self.tier.page_bytes

    def bytes_total(self) -> int:
        return self.tier.capacity * self.tier.page_bytes

    def bind(self, spec, pin: bool = False) -> None:
        self.tier.bind(spec, pin)

    # -------------------------------------------------------------- ops ----
    def has(self, key: bytes) -> bool:
        """Key present (full key verified)?  No stats: the offload path's
        dedup probe, not a serving lookup."""
        e = self._entries.get(self._digest(key))
        return e is not None and e.key == key

    def touch(self, key: bytes) -> None:
        d = self._digest(key)
        e = self._entries.get(d)
        if e is not None and e.key == key:
            self._entries.move_to_end(d)

    def put(self, key: bytes, arrays) -> None:
        """Store (or refresh) ``key``'s page payload, LRU-evicting to make
        room.  A digest collision replaces the resident entry: the store is
        a cache, and the full-key check on lookup keeps either choice
        correct; replacing favours recency."""
        d = self._digest(key)
        e = self._entries.get(d)
        if e is not None:
            if e.key == key:
                self._entries.move_to_end(d)     # already stored: refresh
                return
            self._stats["collisions"] += 1
            self._evict_digest(d)
        slot = self.tier.alloc_slot()
        if slot is None:
            self._evict_digest(next(iter(self._entries)))   # LRU victim
            self._stats["evictions"] += 1
            slot = self.tier.alloc_slot()
            assert slot is not None
        self.tier.write(slot, arrays)
        self._entries[d] = _Entry(key=key, slot=slot)
        self._stats["offloads"] += 1
        self._stats["offload_bytes"] += self.tier.page_bytes

    def lookup(self, key: bytes) -> Optional[Dict[str, torch.Tensor]]:
        """Views of ``key``'s page payload in the slabs, or ``None`` (a
        counted miss).  A digest hit with another full key is a collision
        and a miss, never another prefix's bytes."""
        d = self._digest(key)
        e = self._entries.get(d)
        if e is None:
            self._stats["misses"] += 1
            return None
        if e.key != key:
            self._stats["collisions"] += 1
            self._stats["misses"] += 1
            return None
        self._stats["hits"] += 1
        self._entries.move_to_end(d)
        return self.tier.read(e.slot)

    def note_prefetch(self, n_pages: int) -> None:
        """Count ``n_pages`` host-to-device page copies that landed (the
        cache calls it after the device write, so a lookup whose admission
        was then denied never counts prefetch bytes)."""
        self._stats["prefetch_bytes"] += n_pages * self.tier.page_bytes

    def quarantine(self, key: bytes) -> None:
        """Drop ``key`` after its payload failed the consumer's finite
        check: the hit stands (the counters only grow), a miss and a
        poisoned drop are recorded too, and the bytes are never served
        again."""
        d = self._digest(key)
        e = self._entries.get(d)
        if e is not None and e.key == key:
            self._evict_digest(d)
        self._stats["misses"] += 1
        self._stats["poisoned"] += 1

    def drop(self, key: bytes) -> None:
        d = self._digest(key)
        e = self._entries.get(d)
        if e is not None and e.key == key:
            self._evict_digest(d)

    def _evict_digest(self, d: bytes) -> None:
        e = self._entries.pop(d)
        self.tier.free_slot(e.slot)

    # ------------------------------------------------------------ faults ----
    def poison(self, key: bytes) -> bool:
        """Overwrite ``key``'s stored payload with NaN (the host-resident
        arm of the ``poison_page`` fault): float payloads directly, and for
        int8 payloads, which have no NaN, their fp32 scales, as on the
        device.  Returns whether the key was resident."""
        e = self._entries.get(self._digest(key))
        if e is None or e.key != key:
            return False
        floats = [a for a in self.tier.read(e.slot).values()
                  if a.is_floating_point()]
        assert floats, "page payload has no float arrays to poison"
        self.tier.settle()
        for a in floats:
            a.fill_(float("nan"))      # slab views: the writes land in it
        return True

    # ------------------------------------------------------------- state ----
    def stats(self) -> Dict[str, int]:
        return dict(self._stats)

    def keys(self) -> List[bytes]:
        return [e.key for e in self._entries.values()]

    def verify(self) -> None:
        """Host-tier invariants (called from ``PagedCache.verify``): entries
        fit the capacity, every tier slot is owned once and by the entry
        that claims it, and every index digest matches its entry's key."""
        def check(cond, what):
            if not cond:
                raise HostTierError(f"PrefixStore.verify: {what}")

        check(len(self._entries) <= self.tier.capacity,
              "more store entries than tier capacity")
        slots = [e.slot for e in self._entries.values()]
        check(len(slots) == len(set(slots)),
              "two store entries share a tier slot")
        check(set(slots) == self.tier._used,
              "store entries and tier used-slots disagree")
        for d, e in self._entries.items():
            check(self._digest(e.key) == d,
                  "store index digest does not match entry key")
        self.tier.verify()
