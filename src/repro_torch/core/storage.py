"""Two-tier storage: object store (COS analogue) fronted by a parallel-FS
write-back cache (Spectrum Scale + AFM analogue, §2.1.3).

Bandwidth/latency constants are the paper's published numbers:
  COS           5 GB/s write path,   high per-op latency
  NFS           1 GB/s read,         heavy contention variance (~50% step jitter)
  Scale cache   40 GB/s read / 15 GB/s write, low variance

The simulator charges transfer costs against a (virtual or wall) clock and
exports cache/traffic metrics; the AFM queue drains asynchronously so writes
(checkpoints) never gate the training job (the paper's Fig 7).

A copy of the JAX package's ``core/storage.py``: the same numpy
``default_rng`` jitter streams, so equal seeds charge equal op times.
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from repro_torch.core.clock import Clock, VirtualClock
from repro_torch.core.telemetry import MetricsRegistry

GB = 1e9


@dataclass
class TierSpec:
    name: str
    read_bw: float               # bytes/s
    write_bw: float
    latency: float               # per-op seconds
    jitter: float = 0.0          # multiplicative stddev on op duration


COS = TierSpec("cos", read_bw=2 * GB, write_bw=5 * GB, latency=0.10,
               jitter=0.20)
NFS = TierSpec("nfs", read_bw=1 * GB, write_bw=0.8 * GB, latency=0.01,
               jitter=0.50)    # limited concurrency -> ~50% variance (paper)
SCALE = TierSpec("scale", read_bw=40 * GB, write_bw=15 * GB, latency=0.001,
                 jitter=0.05)


class BlobStore:
    """One storage tier: keeps blob sizes (contents optional) and charges
    transfer time against the clock."""

    def __init__(self, spec: TierSpec, clock: Clock,
                 registry: Optional[MetricsRegistry] = None, seed: int = 0):
        self.spec = spec
        self.clock = clock
        self.blobs: Dict[str, int] = {}
        self.data: Dict[str, bytes] = {}
        self.rng = np.random.default_rng(seed)
        self.reg = registry
        self._lock = threading.Lock()

    def _charge(self, seconds: float, op: str):
        if self.spec.jitter:
            seconds *= max(0.05, 1.0 + self.rng.normal(0, self.spec.jitter))
        self.clock.advance(seconds)
        if self.reg:
            self.reg.histogram("storage_op_seconds").observe(
                seconds, {"tier": self.spec.name, "op": op})
        return seconds

    def write(self, key: str, nbytes: int, payload: Optional[bytes] = None):
        t = self._charge(self.spec.latency + nbytes / self.spec.write_bw,
                         "write")
        with self._lock:
            self.blobs[key] = nbytes
            if payload is not None:
                self.data[key] = payload
        if self.reg:
            self.reg.counter("storage_bytes_written").inc(
                nbytes, {"tier": self.spec.name})
        return t

    def read(self, key: str) -> float:
        nbytes = self.blobs[key]
        t = self._charge(self.spec.latency + nbytes / self.spec.read_bw,
                         "read")
        if self.reg:
            self.reg.counter("storage_bytes_read").inc(
                nbytes, {"tier": self.spec.name})
        return t

    def exists(self, key: str) -> bool:
        return key in self.blobs

    def size(self, key: str) -> int:
        return self.blobs[key]


class ScaleCache:
    """AFM-style read-write cache over an object store.

    * read miss: fetch from COS into cache (charged at COS read bw), then
      serve at cache speed; hit: cache speed only.
    * write: lands in the cache at Scale speed and is queued for async
      upload to COS; ``drain_async()`` models the background AFM mover and
      charges its time to a *separate* clock so the training job isn't gated.
    * LRU eviction of clean (uploaded) entries when over capacity.
    """

    def __init__(self, backing: BlobStore, clock: Clock,
                 capacity_bytes: float = 140e12,   # 140 TB (paper)
                 spec: TierSpec = SCALE,
                 registry: Optional[MetricsRegistry] = None, seed: int = 1):
        self.cache = BlobStore(spec, clock, registry, seed)
        self.backing = backing
        self.clock = clock
        self.capacity = capacity_bytes
        self.lru: "OrderedDict[str, int]" = OrderedDict()
        self.dirty: Dict[str, int] = {}
        self.reg = registry
        self.async_clock = VirtualClock()   # AFM mover's own timeline

    @property
    def used(self) -> int:
        return sum(self.lru.values())

    def _touch(self, key: str, nbytes: int):
        self.lru.pop(key, None)
        self.lru[key] = nbytes
        self._evict()

    def _evict(self):
        while self.used > self.capacity:
            for key in list(self.lru):
                if key not in self.dirty:      # only clean entries evictable
                    self.lru.pop(key)
                    if self.reg:
                        self.reg.counter("scale_evictions").inc()
                    break
            else:
                break   # everything dirty: AFM must drain first

    def read(self, key: str) -> float:
        if key in self.lru:
            if self.reg:
                self.reg.counter("scale_cache_hits").inc()
            t = self.cache._charge(
                self.cache.spec.latency
                + self.lru[key] / self.cache.spec.read_bw, "read")
            self._touch(key, self.lru[key])
            return t
        if self.reg:
            self.reg.counter("scale_cache_misses").inc()
        t = self.backing.read(key)            # on-demand AFM fetch
        nbytes = self.backing.size(key)
        self._touch(key, nbytes)
        return t

    def write(self, key: str, nbytes: int) -> float:
        t = self.cache.write(key, nbytes)
        self.dirty[key] = nbytes
        self._touch(key, nbytes)
        if self.reg:
            self.reg.gauge("scale_dirty_bytes").set(sum(self.dirty.values()))
        return t

    def drain_async(self) -> float:
        """Background AFM upload of dirty entries; returns mover seconds spent
        (NOT charged to the foreground clock)."""
        total = 0.0
        for key in list(self.dirty):
            nbytes = self.dirty.pop(key)
            saved_clock = self.backing.clock
            self.backing.clock = self.async_clock
            try:
                total += self.backing.write(key, nbytes)
            finally:
                self.backing.clock = saved_clock
        if self.reg:
            self.reg.gauge("scale_dirty_bytes").set(0.0)
        return total


@dataclass
class StorageStack:
    """What a training job sees: dataset reads + checkpoint writes through a
    selected tier ('scale' | 'nfs' | 'cos')."""
    clock: Clock
    registry: Optional[MetricsRegistry] = None
    seed: int = 0
    cos: BlobStore = field(init=False)
    nfs: BlobStore = field(init=False)
    scale: ScaleCache = field(init=False)

    def __post_init__(self):
        self.cos = BlobStore(COS, self.clock, self.registry, self.seed)
        self.nfs = BlobStore(NFS, self.clock, self.registry, self.seed + 1)
        self.scale = ScaleCache(self.cos, self.clock,
                                registry=self.registry, seed=self.seed + 2)

    def dataset_read(self, key: str, tier: str) -> float:
        if tier == "scale":
            return self.scale.read(key)
        if tier == "nfs":
            if not self.nfs.exists(key):
                self.nfs.blobs[key] = self.cos.size(key)
            return self.nfs.read(key)
        return self.cos.read(key)

    def checkpoint_write(self, key: str, nbytes: int, tier: str) -> float:
        if tier == "scale":
            return self.scale.write(key, nbytes)
        return self.cos.write(key, nbytes)
