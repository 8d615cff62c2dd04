"""Sharded paged serving over ``torch.distributed`` (counterpart of the JAX
``repro.parallel.pagedkv``), over a 1-D split of the pool or a 2-D batch x
pages mesh.

The KV pool's page dimension is split over the n ranks of a process group:
rank c holds the global page ids ``[c*P/n, (c+1)*P/n)`` (P padded to a
multiple of n by ``PagedCache``), so each rank pins P/n pages.  Where the
JAX engine is one controller over a ``shard_map``, the port is SPMD: every
rank runs the same engine with the same weights and the same host-side
scheduler, computes the same replicated q/K/V, and holds only its own pool
shard.  The (B, M) page table keeps GLOBAL ids on every rank.

Every pool access is built from three verbs:

1. **Local scatter** — the rank owning a row's page commits it at its local
   index; every other rank writes it into its shard's sink page, one page
   past its window (``attention.scatter_paged_kv_local`` for decode rows,
   ``attention.scatter_chunk_paged_local`` for prefill rows).  Torch has no
   ``mode="drop"`` scatter; the sink neither syncs with the host nor races
   with a live page, and ``memory_stats`` counts its bytes.
2. **Local partials** — each rank attends to the live pages in its window
   and skips the rest like dead pages, giving the raw online-softmax
   triple (acc, l, m): K1's partials mode
   (``ops.paged_decode_partials``) or the gathered view
   (``attention.paged_gather_partials``; ``paged_gather_chunk_partials``
   for a prefill chunk's C rows).
3. **Merge** — ``attention.merge_paged_partials`` (C rows:
   ``merge_paged_chunk_partials``): one all_reduce MAX and
   one all_reduce SUM give ``sum(acc·w) / sum(l·w)``, ``w = exp(m - max
   m)``, the same on every rank, so everything downstream is too.

The merge moves B·KV·G·(D+2) fp32 per layer, independent of the pool and
of the sequence length.  Backends: ``nccl`` when each rank has its own card;
``gloo`` on the CPU, and when ranks share one card (gloo's all_reduce takes
CUDA tensors and stages them through the host itself).

**2-D batch × pages meshes** (``dp_group``, the JAX ``dp_axis``): D·M ranks,
rank r at (d, m) = (r // M, r % M).  The pool is split over the M ranks of
a row (the *model* group, the ``PoolGroup``) and replicated across the D
rows; the ranks of a column form the *dp* group.  Every replica applies the
whole batch's writes, which every rank computes the same, so the D replicas
of a shard stay bitwise equal.  When D > 1 divides the dispatch's batch
(``dp_rows``, the JAX ``_dp_or_none``), replica d attends only rows
``[d·B/D, (d+1)·B/D)`` of q, the table and the positions, merges over its
model group alone, and the (B/D)-row outputs are all_gathered over the dp
group; a batch D does not divide runs replicated.

The host tier behind a split pool (``PagedCache(host_pages=)``): the rank
owning a page that leaves the device copies it to the host, and the next
drain broadcasts the bytes over the model group (``PoolGroup.broadcast``),
so every rank's ``PrefixStore`` holds the same keys and bytes.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

from repro_torch.kernels import ops
from repro_torch.kernels.quant import quantize_kv
from repro_torch.models import attention as attn


def chip_of_page(pid: int, pages_per_chip: int) -> int:
    """The rank owning global page id ``pid`` under the contiguous P/n split
    (rank c owns ``[c*P/n, (c+1)*P/n)``)."""
    return pid // pages_per_chip


def chip_page_range(chip: int, pages_per_chip: int) -> range:
    """The global page ids rank ``chip`` owns (scratch page 0 included when
    chip 0: callers that mean usable pages skip id 0)."""
    return range(chip * pages_per_chip, (chip + 1) * pages_per_chip)


@dataclass(frozen=True)
class PoolGroup:
    """This rank's place in the process group a KV pool is split over.
    ``group`` is a ``torch.distributed`` process group (``None``: the
    default group); the writes need only ``rank`` and ``size``, the merge
    and ``same_on_every_rank`` run collectives on ``group``."""
    group: Any
    rank: int
    size: int

    @classmethod
    def of(cls, group=None) -> "PoolGroup":
        return cls(group, dist.get_rank(group), dist.get_world_size(group))

    def all_max(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Overwrite the CPU tensor ``t`` on every rank with group rank
        ``src``'s; over nccl through a copy on this rank's card."""
        root = src if self.group is None else dist.get_global_rank(
            self.group, src)
        if dist.get_backend(self.group) == "gloo":
            dist.broadcast(t, root, group=self.group)
        else:
            dev = t.to(torch.device("cuda", torch.cuda.current_device()))
            dist.broadcast(dev, root, group=self.group)
            t.copy_(dev)
        return t

    def all_gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along dim 0 in group-rank
        order (the dp group's all_gather of its replicas' batch rows)."""
        parts = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(parts, t.contiguous(), group=self.group)
        return torch.cat(parts)

    def same_on_every_rank(self, payload: bytes) -> bool:
        """Whether every rank passed the same bytes: a 56-bit digest and its
        negation, max-reduced, agree only if the minimum equals the
        maximum.  On the CPU for gloo, on this rank's card for nccl."""
        h = int.from_bytes(hashlib.sha256(payload).digest()[:7], "little")
        dev = (torch.device("cpu") if dist.get_backend(self.group) == "gloo"
               else torch.device("cuda", torch.cuda.current_device()))
        t = self.all_max(torch.tensor([h, -h], dtype=torch.int64, device=dev))
        return int(t[0]) == -int(t[1])


def dp_rows(dp_group: Optional[PoolGroup], batch: int) -> Optional[slice]:
    """The batch rows this replica attends on a 2-D mesh (the JAX
    ``_dp_or_none``): ``[d·B/D, (d+1)·B/D)`` when the dp group has D > 1
    ranks and D divides ``batch``; ``None`` (every row, replicated)
    otherwise."""
    if dp_group is None or dp_group.size == 1 or batch % dp_group.size:
        return None
    n = batch // dp_group.size
    return slice(dp_group.rank * n, (dp_group.rank + 1) * n)


def sharded_paged_decode_attention(pool_group: PoolGroup, q, k_new, v_new,
                                   k_pool, v_pool, page_table, positions,
                                   decode_impl: str = "kernel",
                                   k_scale=None, v_scale=None,
                                   dp_group: Optional[PoolGroup] = None):
    """One layer's sharded paged decode on this rank: scatter the new row
    into the owning rank's shard, take this shard's partials, merge.

    q (B, 1, KV, G, D); k_new/v_new (B, 1, KV, D), this step's projected
    K/V, the same on every rank; pools this rank's (P/n + 1, page, KV, D)
    shards with their sink page, written in place; page_table (B, M) global
    ids; positions (B,).  With int8 pools, ``k_scale``/``v_scale`` are the
    (P/n + 1, page, KV) scale shards: every rank quantizes the new row (the
    same int8 row and scale everywhere) and the owning rank commits both.
    ``decode_impl``: ``"kernel"`` (K1's partials mode) or ``"gather"``.
    With ``dp_group`` (2-D mesh) every replica writes the whole batch, then
    attends only its ``dp_rows`` and gathers the rows over the dp group.
    Returns y (B, 1, KV, G, D) in q's dtype, the same on every rank."""
    pn = k_pool.shape[0] - 1
    off = pool_group.rank * pn
    if k_scale is not None:
        k_new, sk = quantize_kv(k_new)
        v_new, sv = quantize_kv(v_new)
        attn.scatter_paged_kv_local(k_scale, sk, page_table, positions, off)
        attn.scatter_paged_kv_local(v_scale, sv, page_table, positions, off)
    attn.scatter_paged_kv_local(k_pool, k_new, page_table, positions, off)
    attn.scatter_paged_kv_local(v_pool, v_new, page_table, positions, off)
    ks, vs = ((None, None) if k_scale is None
              else (k_scale[:pn], v_scale[:pn]))
    rows = dp_rows(dp_group, q.shape[0])
    if rows is not None:
        q, page_table, positions = q[rows], page_table[rows], positions[rows]
    if decode_impl == "kernel":
        acc, l, m = ops.paged_decode_partials(
            q, k_pool[:pn], v_pool[:pn], page_table, positions, off,
            k_scale=ks, v_scale=vs)
    elif decode_impl == "gather":
        acc, l, m = attn.paged_gather_partials(
            q, k_pool[:pn], v_pool[:pn], page_table, positions, off,
            k_scale=ks, v_scale=vs)
    else:
        raise ValueError(f"decode_impl {decode_impl!r} not in "
                         "('kernel', 'gather')")
    y = attn.merge_paged_partials(acc, l, m, pool_group).to(q.dtype)
    return y if rows is None else dp_group.all_gather_rows(y)


def sharded_write_prefill(pool_group: PoolGroup, layers, kv_block, dest):
    """Whole-prompt prefill writes into this rank's shards, in place (the
    sharded ``PagedCache.staged_write_prefill``).  layers: the (L, P/n + 1,
    page, ...) pool shards (scale shards too for int8); kv_block: a
    matching dict of (L, n, Sblk, ...) blocks in the pools' format; dest
    (n, Sblk) GLOBAL flat pool rows.  Each layer's rows go through
    ``attention.scatter_chunk_paged_local``: in-window rows land, the rest
    go to the sink.  No collective: every rank holds the whole block."""
    sample = next(iter(layers.values()))
    rows = (sample.shape[1] - 1) * sample.shape[2]
    for name, pool in layers.items():
        block = kv_block[name]
        for i in range(pool.shape[0]):
            attn.scatter_chunk_paged_local(pool[i], block[i], dest,
                                           pool_group.rank * rows)


def sharded_prefill_chunk_attention(pool_group: PoolGroup, q, k_new, v_new,
                                    dest, k_pool, v_pool, page_table, qpos,
                                    last_pos, k_scale=None, v_scale=None,
                                    dp_group: Optional[PoolGroup] = None):
    """One layer's chunked-prefill write and attention on this rank (the
    JAX ``sharded_prefill_chunk_attention``): the chunk's rows land in the
    owning rank's shard (the rest in each rank's sink), then this shard's
    C-row partials, then the merge.  q (B, C, KV, G, D); k_new/v_new
    (B, C, KV, D), the same on every rank; dest (B, C) GLOBAL flat pool
    rows; pools this rank's (P/n + 1, page, KV, D) shards with their sink;
    page_table (B, M) the slots' real rows, global ids; qpos (B, C) each
    row's position; last_pos (B,).  Int8 pools: every rank quantizes the
    rows and their scales land through the same rows.  With ``dp_group``
    (2-D mesh) the replica attends its ``dp_rows`` and gathers the rows
    over the dp group.  Returns y (B, C, KV, G, D) in q's dtype, the same
    on every rank."""
    pn, page = k_pool.shape[0] - 1, k_pool.shape[1]
    off = pool_group.rank * pn
    if k_scale is not None:
        k_new, sk = quantize_kv(k_new)
        v_new, sv = quantize_kv(v_new)
        attn.scatter_chunk_paged_local(k_scale, sk, dest, off * page)
        attn.scatter_chunk_paged_local(v_scale, sv, dest, off * page)
    attn.scatter_chunk_paged_local(k_pool, k_new, dest, off * page)
    attn.scatter_chunk_paged_local(v_pool, v_new, dest, off * page)
    ks, vs = ((None, None) if k_scale is None
              else (k_scale[:pn], v_scale[:pn]))
    rows = dp_rows(dp_group, q.shape[0])
    if rows is not None:
        q, page_table = q[rows], page_table[rows]
        qpos, last_pos = qpos[rows], last_pos[rows]
    acc, l, m = attn.paged_gather_chunk_partials(
        q, k_pool[:pn], v_pool[:pn], page_table, qpos, last_pos, off,
        k_scale=ks, v_scale=vs)
    y = attn.merge_paged_chunk_partials(acc, l, m, pool_group).to(q.dtype)
    return y if rows is None else dp_group.all_gather_rows(y)
