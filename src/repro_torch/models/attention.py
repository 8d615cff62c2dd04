"""GQA attention of the port: full-sequence prefill and one-token decode over
a paged KV cache (counterpart of the dense and decode pieces of the JAX
``repro.models.attention``).

Prefill (``attention_block``) runs ``impl="flash"`` (K2) or ``"dense"`` (the
JAX engine's default, kept as the reference); training runs
``impl="blockwise"``, the JAX trainer's online-softmax attention in plain
torch, which autograd differentiates (K2 has no backward).  Weights are
cast to the activations' dtype at each use, as JAX does, so fp32 master
weights train in bf16 compute and bf16 serving weights are used as they
are.  Decode
(``attention_decode_block``) writes the new token's K/V into the
(P, page, KV, D) pools in place, then attends through the (B, M) page table
with ``impl="kernel"`` (K1) or ``"gather"`` (dense gathered view, the JAX
engine's default).  Physical page 0 is the scratch page: freed slots' table
rows point at it, so masked writes of inactive slots land there.  Over int8
pools the new row is quantized before it is written, its scale lands
through the same table index, and the read dequantizes: in registers in K1's
int8 mode, or the gathered view under ``"gather"``.  Chunked prefill
(``attention_prefill_chunk_block``) writes a (B, C) chunk's K/V at flat
pool rows and attends over the slot's pages through the gathered view
with a position-exact causal mask: no kernel, as in JAX, whose chunk
attention is plain XLA too.  Without a page table
the caches are dense (B, S, KV, D) rows (the contiguous layout): each slot
writes its row at its own position and attends over its rows with the
gathered view's arithmetic, so paged ``"gather"`` and contiguous give
bitwise-equal outputs when M·page == S; ``impl`` is ignored there, as in
JAX, so no K1 runs.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.quant import (check_pool_write, dequantize_kv,
                                       quantize_kv)
from repro_torch.models.common import (P, add_bias, apply_rope, dense_spec,
                                       depth_scale, norm_spec, rms_norm)
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.seqattn import seq_sharded_attention
from repro_torch.parallel.tpmm import col_proj_tp, o_proj_tp, tp_group

NEG_INF = -1e30


def attention_spec(cfg, cross: bool = False):
    """The JAX layouts: ``wq`` (d, H, D), ``wk``/``wv`` (d, KV, D), ``wo``
    (H, D, d); with ``cfg.use_bias`` their biases are (H, D), (KV, D) and
    (d,).  A ``cross``-attention block has no q/k norms."""
    d, h, kv, hd = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
    bias = cfg.use_bias
    spec = {"wq": dense_spec((d, h, hd), ("embed", "heads", "head_dim"),
                             bias),
            "wk": dense_spec((d, kv, hd), ("embed", "kv_heads", "head_dim"),
                             bias),
            "wv": dense_spec((d, kv, hd), ("embed", "kv_heads", "head_dim"),
                             bias),
            "wo": {"kernel": P((h, hd, d), scale=depth_scale(cfg),
                               axes=("heads", "head_dim", "embed"))}}
    if bias:
        spec["wo"]["bias"] = P((d,), init="zeros", axes=("embed",))
    if cfg.qk_norm and not cross:
        spec["q_norm"] = norm_spec(cfg, hd, axis="head_dim")
        spec["k_norm"] = norm_spec(cfg, hd, axis="head_dim")
    return spec


def _proj(p, x, psum_dtype=None):
    """x (B, S, d) @ kernel (d, H, D) -> (B, S, H, D), in x's dtype, plus
    the (H, D) bias where ``p`` has one (``tpmm.col_proj_tp``: this rank's
    heads when the kernel's are split over the model axis)."""
    return col_proj_tp(x, p["kernel"], p.get("bias"), psum_dtype=psum_dtype)


def project_qkv(p, cfg, x, positions, norm_impl: str = "kernel",
                flat_heads: bool = False, full_heads: bool = False,
                psum_dtype=None):
    """Returns q (B, S, KV, G, D) grouped for GQA and k, v (B, S, KV, D).
    Biases are added before qwen3's q/k norms, which come before RoPE.

    ``flat_heads`` (train/prefill) repeats K/V to H, so q is (B, S, H, 1, D)
    and k, v (B, S, H, D), as JAX's.  Under a sharding context whose model
    axis splits the heads (``tpmm``), q, k and v hold this rank's heads;
    where the rule for ``kv_heads`` dropped (KV does not divide), K/V are
    whole on every rank and each of this rank's q heads takes its own K/V
    head, flat; ``full_heads`` gathers every head back (sequence-sharded
    attention splits the rows instead)."""
    q = _proj(p["wq"], x, psum_dtype)
    k = _proj(p["wk"], x, psum_dtype)
    v = _proj(p["wv"], x, psum_dtype)
    gq = tp_group(p["wq"]["kernel"], 1)
    gkv = tp_group(p["wk"]["kernel"], 1)
    if cfg.qk_norm:
        # the scales are whole on every rank: a split of heads takes a
        # share of their gradient
        q = rms_norm(q, coll.copy_to(p["q_norm"]["scale"], gq, psum_dtype),
                     cfg.norm_eps, norm_impl)
        k = rms_norm(k, coll.copy_to(p["k_norm"]["scale"], gkv, psum_dtype),
                     cfg.norm_eps, norm_impl)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if full_heads:
        q = coll.gather_from(q, 2, gq)
        k = coll.gather_from(k, 2, gkv)
        v = coll.gather_from(v, 2, gkv)
    else:
        k, v = _kv_of_heads(cfg, q, k, v, gq, gkv, psum_dtype)
    b, s, h, hd = q.shape
    kv = k.shape[2]
    if flat_heads and kv != h:
        k = k.repeat_interleave(h // kv, dim=2)
        v = v.repeat_interleave(h // kv, dim=2)
        kv = h
    return q.reshape(b, s, kv, h // kv, hd), k, v


def _kv_of_heads(cfg, q, k, v, gq, gkv, psum_dtype=None):
    """K/V for this rank's q heads (B, S, H_local, D): as they are, unless
    the q heads are split over ``gq`` while the rule for ``kv_heads``
    dropped (``gkv`` None: KV does not divide), when K/V are whole on every
    rank and each of this rank's q heads takes its own K/V head, flat."""
    if gq is None or gkv is not None:
        return k, v
    k = coll.copy_to(k, gq, psum_dtype)
    v = coll.copy_to(v, gq, psum_dtype)
    hl = q.shape[2]
    heads = coll.group_rank(gq) * hl + torch.arange(hl, device=q.device)
    group = cfg.num_heads // cfg.num_kv_heads
    return k[:, :, heads // group], v[:, :, heads // group]


def output_proj(p, cfg, y, psum_dtype=None):
    """y (B, S, KV, G, D) -> (B, S, d), plus ``wo``'s bias where it has
    one (``tpmm.o_proj_tp``: y holds this rank's heads, and the partial
    sums are reduced over the model group, when ``wo``'s heads are
    split)."""
    b, s = y.shape[:2]
    wo = p["wo"]
    return o_proj_tp(y.reshape(b, s, -1, y.shape[-1]), wo["kernel"],
                     wo.get("bias"), psum_dtype=psum_dtype)


def dense_attention(q, k, v, causal: bool):
    """q (B, Sq, KV, G, D); k, v (B, Skv, KV, D).  Scores in fp32; the
    probabilities are cast to q's dtype before PV, as the JAX reference."""
    hd = q.shape[-1]
    s = torch.einsum("bqkgd,bskd->bkgqs", q, k).float() / math.sqrt(hd)
    if causal:
        sq, skv = q.shape[1], k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(skv, device=q.device)[None, :])
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    probs = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, v)


def blockwise_attention(q, k, v, causal: bool, q_chunk: int = 1024,
                        kv_chunk: int = 1024):
    """Flash attention in plain torch (counterpart of the JAX
    ``blockwise_attention``): a loop over query chunks and, inside, over the
    KV chunks the causal mask needs, with an fp32 online softmax.  The
    softmax scale is folded into q, masking is an additive bias on the
    diagonal chunks only, and probabilities are cast to v's dtype before
    PV.  q (B, Sq, KV, G, D); k, v (B, Skv, KV, D); returns like q."""
    b, sq, kvh, g, hd = q.shape
    skv = k.shape[1]
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    if sq % q_chunk or skv % kv_chunk:
        raise ValueError(f"blockwise_attention: chunks ({q_chunk}, "
                         f"{kv_chunk}) do not divide ({sq}, {skv})")
    q = q * (1.0 / math.sqrt(hd))
    outs = []
    for i in range(sq // q_chunk):
        q_blk = q[:, i * q_chunk:(i + 1) * q_chunk]
        q_end = (i + 1) * q_chunk if causal else skv
        n_kv = -(-min(q_end, skv) // kv_chunk)
        qpos = i * q_chunk + torch.arange(q_chunk, device=q.device)
        m = torch.full((b, kvh, g, q_chunk), NEG_INF, device=q.device)
        l = torch.zeros((b, kvh, g, q_chunk), device=q.device)
        acc = torch.zeros((b, kvh, g, q_chunk, hd), device=q.device)
        for j in range(n_kv):
            k_blk = k[:, j * kv_chunk:(j + 1) * kv_chunk]
            v_blk = v[:, j * kv_chunk:(j + 1) * kv_chunk]
            s = torch.einsum("bqkgd,bskd->bkgqs", q_blk, k_blk).float()
            if causal and (j + 1) * kv_chunk - 1 > i * q_chunk:
                kpos = j * kv_chunk + torch.arange(kv_chunk, device=q.device)
                s = s + torch.where(qpos[:, None] >= kpos[None, :], 0.0,
                                    NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(v_blk.dtype), v_blk)
            acc = acc * corr[..., None] + pv.float()
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4).to(q.dtype))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def attention_block(p, cfg, x, *, impl: str = "flash", causal: bool = True,
                    norm_impl: str = "kernel", q_chunk: int = 1024,
                    kv_chunk: int = 1024, flat_heads: bool = False,
                    tp_shardmap: bool = False):
    """Self-attention over a full sequence (prefill, or training with
    ``impl="blockwise"``; ``"seqsp"``, causal only, splits the query rows
    over the model axis, ``parallel.seqattn``).  Under a sharding context
    the projections are tensor-parallel (``tpmm``), their reductions in
    fp32 or, with ``tp_shardmap``, in the compute dtype.  Returns (y,
    (k, v))."""
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)[None, :]
    psum = None if tp_shardmap else torch.float32
    seqsp = impl == "seqsp"
    q, k, v = project_qkv(p, cfg, x, positions, norm_impl,
                          flat_heads=flat_heads, full_heads=seqsp,
                          psum_dtype=psum)
    if impl == "flash":
        y = ops.flash_attention(q, k, v, causal=causal)
    elif impl == "dense":
        y = dense_attention(q, k, v, causal)
    elif impl == "blockwise":
        y = blockwise_attention(q, k, v, causal, q_chunk, kv_chunk)
    elif seqsp:
        if not causal:
            raise ValueError("attn_impl='seqsp' is causal only")
        y = seq_sharded_attention(q, k, v, q_chunk=q_chunk,
                                  kv_chunk=kv_chunk)
        g = tp_group(p["wo"]["kernel"], 0)
        if g is not None:       # whole heads on every rank: keep this rank's
            b, hl = y.shape[0], p["wo"]["kernel"].shape[0]
            y = coll.copy_to(y.reshape(b, s, -1, y.shape[-1]), g, psum)
            y = y[:, :, coll.group_rank(g) * hl:(coll.group_rank(g) + 1) * hl]
    else:
        raise ValueError(impl)
    return output_proj(p, cfg, y, psum), (k, v)


def cross_attention_block(p, cfg, x, enc_kv):
    """Cross-attention (the JAX ``cross_attention_block``): q from x with
    no RoPE, against the precomputed encoder ``enc_kv`` = (k, v)
    (B, E, KV, D), non-causal, through the plain ``blockwise_attention``
    with its default chunks, as JAX's (no TPU kernel runs here).  x
    (B, S, d) -> (B, S, d).  Under a sharding context whose model axis
    splits the heads, q and ``enc_kv`` (from ``encode_kv``) hold this
    rank's heads, and the reductions run in fp32 (GSPMD's: JAX's enc-dec
    takes no ``tp_shardmap``)."""
    b, s, _ = x.shape
    psum = torch.float32
    q = _proj(p["wq"], x, psum)
    k, v = _kv_of_heads(cfg, q, *enc_kv, tp_group(p["wq"]["kernel"], 1),
                        tp_group(p["wk"]["kernel"], 1), psum)
    kv = k.shape[2]
    q = q.reshape(b, s, kv, q.shape[2] // kv, q.shape[-1])
    return output_proj(p, cfg, blockwise_attention(q, k, v, causal=False),
                       psum)


def encode_kv(p, cfg, enc_out):
    """The cross-attention K/V of the encoder output (B, E, d): the
    projections and their biases, no RoPE.  Returns (k, v) (B, E, KV,
    D), this rank's K/V heads where the model axis splits them (the
    input's gradient reduced in fp32)."""
    del cfg
    return (_proj(p["wk"], enc_out, torch.float32),
            _proj(p["wv"], enc_out, torch.float32))


# ----------------------------------------------------------------- decode ----

def live_table(page_table, positions, page: int):
    """The (B, M) table with entries past each slot's live pages redirected
    to the scratch page 0."""
    m = page_table.shape[1]
    live = (torch.arange(m, device=page_table.device)[None, :]
            <= (positions.long() // page)[:, None])
    pt = page_table.long()
    return torch.where(live, pt, torch.zeros_like(pt))


def gather_pages(pool, page_table, positions=None):
    """(P, page, KV, D) pool -> (B, M*page, KV, D) per-slot logical rows.
    With ``positions``, table entries past each slot's live pages are
    redirected to the scratch page: their rows are masked anyway, and the
    redirect keeps a dead page's content (even NaN) out of the result."""
    b, m = page_table.shape
    page = pool.shape[1]
    pt = (page_table.long() if positions is None
          else live_table(page_table, positions, page))
    return pool[pt].reshape(b, m * page, *pool.shape[2:])


def dequant_gathered(gathered, scale_pool, table, dtype):
    """Dequantize a gathered int8 view: ``gathered`` (B, S, KV, D) int8,
    ``scale_pool`` (P, page, KV) fp32, ``table`` the (B, M) table the view
    was gathered through; the scales resolve through the same table, so a
    row and its scale never come from different pages."""
    sg = scale_pool[table.long()].reshape(gathered.shape[:3])
    return dequantize_kv(gathered, sg, dtype)


def chunk_attention(q, kg, vg, qpos, last_pos):
    """Queries q (B, C, KV, G, D) at positions qpos (B, C) over gathered
    rows kg, vg (B, S, KV, D): row i sees columns ``<= min(qpos[:, i],
    last_pos)``, so a chunk's padding rows past ``last_pos`` (B,) stay
    inside the claimed pages; a decode step is the one-row case.  Scores
    and softmax in fp32, the probabilities cast to q's dtype before PV, as
    in ``dense_attention``."""
    s = torch.einsum("bqkgd,bskd->bkgqs", q, kg).float() / math.sqrt(
        q.shape[-1])
    cols = torch.arange(kg.shape[1], device=q.device)
    valid = (cols[None, None, :] <= torch.minimum(
        qpos.long(), last_pos.long()[:, None])[:, :, None])   # (B, C, S)
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    probs = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, vg)


def decode_attention(q, k_cache, v_cache, positions, page_table=None,
                     impl: str = "kernel", k_scale=None, v_scale=None):
    """q (B, 1, KV, G, D) attends to each slot's rows 0..pos.  With
    ``page_table`` (B, M) the caches are (P, page, KV, D) pools:
    ``"kernel"`` walks the table in K1, ``"gather"`` builds the dense
    gathered view (the JAX engine's default path); ``k_scale``/``v_scale``
    (P, page, KV) fp32 go with int8 pools.  Without it they are dense
    (B, S, KV, D) rows, attended with the gathered view's arithmetic
    (``impl`` ignored)."""
    if page_table is not None:
        if impl == "kernel":
            return ops.paged_decode_attention(q, k_cache, v_cache,
                                              page_table, positions,
                                              k_scale=k_scale,
                                              v_scale=v_scale)
        assert impl == "gather", impl
        page = k_cache.shape[1]
        kg = gather_pages(k_cache, page_table, positions)
        vg = gather_pages(v_cache, page_table, positions)
        if k_scale is not None:
            lt = live_table(page_table, positions, page)
            kg = dequant_gathered(kg, k_scale, lt, q.dtype)
            vg = dequant_gathered(vg, v_scale, lt, q.dtype)
    elif k_scale is not None:
        raise ValueError("KV scales ride on the paged int8 page format")
    else:
        kg, vg = k_cache, v_cache
    return chunk_attention(q, kg, vg, positions[:, None], positions)


def _scatter_decode_kv(cache, new, positions):
    """In-place dense write (the JAX ``_scatter_decode_kv``): slot b's row
    (B, 1, KV, D) lands at ``cache[b, pos[b]]`` of the (B, S, KV, D) rows.
    Inactive slots decode at position 0, so their writes land in row 0 of
    their own rows, which the next prefill into the slot rewrites."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, positions.long()] = new[:, 0].to(cache.dtype)


def _scatter_paged_kv(pool, new, page_table, positions):
    """In-place paged write: slot b's token (B, 1, KV, D) lands at
    ``pool[page_table[b, pos // page], pos % page]`` (a scale row (B, 1, KV)
    into a (P, page, KV) scale pool the same way).  Inactive slots (all
    at position 0 behind all-zero table rows) all write row 0 of scratch
    page 0; on CUDA those duplicate writes race, which is harmless because
    no live slot ever maps page 0.  An int8 pool takes int8 rows only."""
    check_pool_write(pool, new, "_scatter_paged_kv")
    n_pages, page = pool.shape[:2]
    flat = pool.view(n_pages * page, *pool.shape[2:])
    pos = positions.long()
    page_ids = page_table.long().gather(1, (pos // page)[:, None])[:, 0]
    flat[page_ids * page + pos % page] = new[:, 0].to(pool.dtype)


def _scatter_chunk_paged(pool, new, dest):
    """In-place chunk write (the JAX ``_scatter_chunk_paged``): ``new``
    (B, C, KV, D), or its scales (B, C, KV) into a scale pool, lands at
    ``dest`` (B, C) flat pool rows (page * page_size + row, from
    ``PagedCache.chunk_dest``).  Padding and shared-prefix positions arrive
    routed to flat row 0 of the scratch page; those duplicate writes race
    on CUDA, harmlessly."""
    check_pool_write(pool, new, "_scatter_chunk_paged")
    flat = pool.view(-1, *pool.shape[2:])
    flat[dest.reshape(-1).long()] = new.reshape(
        -1, *new.shape[2:]).to(pool.dtype)


def attention_prefill_chunk_block(p, cfg, x, k_pool, v_pool, start_pos, dest,
                                  page_table, last_pos,
                                  norm_impl: str = "kernel", k_scale=None,
                                  v_scale=None, pool_group=None,
                                  dp_group=None):
    """One layer of chunked prefill (the JAX
    ``attention_prefill_chunk_block``): a (B, C) chunk at per-request
    offsets ``start_pos`` (B,) writes its K/V into the pools in place at
    ``dest`` (B, C) flat rows and attends over everything its slot has
    written, earlier chunks and itself, through ``page_table`` (B, M), the
    slots' real rows (``PagedCache.table_row``).  ``last_pos`` (B,) is each
    chunk's last valid position: it limits the gather to claimed pages and
    clamps padding rows.  Int8 pools (``k_scale``/``v_scale``): the chunk's
    K/V are quantized before the write, their scales land at the same rows,
    and the gathered view is dequantized, so a chunk reads its own rows as
    a later decode step will.  With ``pool_group`` the write and the
    attention go through
    ``repro_torch.parallel.pagedkv.sharded_prefill_chunk_attention``
    (``dp_group``: its 2-D mesh's dp group).  Returns y (B, C, d)."""
    qpos = start_pos.long()[:, None] + torch.arange(x.shape[1],
                                                    device=x.device)
    q, k, v = project_qkv(p, cfg, x, qpos, norm_impl)
    if pool_group is not None:
        from repro_torch.parallel.pagedkv import \
            sharded_prefill_chunk_attention
        y = sharded_prefill_chunk_attention(
            pool_group, q, k, v, dest, k_pool, v_pool, page_table, qpos,
            last_pos, k_scale=k_scale, v_scale=v_scale, dp_group=dp_group)
        return output_proj(p, cfg, y)
    if k_scale is not None:
        k, sk = quantize_kv(k)
        v, sv = quantize_kv(v)
        _scatter_chunk_paged(k_scale, sk, dest)
        _scatter_chunk_paged(v_scale, sv, dest)
    _scatter_chunk_paged(k_pool, k, dest)
    _scatter_chunk_paged(v_pool, v, dest)
    kg = gather_pages(k_pool, page_table, last_pos)
    vg = gather_pages(v_pool, page_table, last_pos)
    if k_scale is not None:
        lt = live_table(page_table, last_pos, k_pool.shape[1])
        kg = dequant_gathered(kg, k_scale, lt, x.dtype)
        vg = dequant_gathered(vg, v_scale, lt, x.dtype)
    return output_proj(p, cfg, chunk_attention(q, kg, vg, qpos, last_pos))


# ---------------------------------------------- sharded pools (one rank) ----
# A rank's shard of a pool split over n ranks is (P/n + 1, page, ...): its
# window of P/n pages, global ids [offset, offset + P/n), then one sink page.
# Torch has no drop-mode scatter, so a write that belongs to another rank
# lands in the sink: no host sync (a boolean index would make one per
# layer) and no race with a live page (rank c > 0's local page 0 is live).

def _local_rows(rows, row_offset: int, n_rows: int):
    """Global flat pool rows -> this shard's flat rows; rows outside
    ``[row_offset, row_offset + n_rows)`` go to row ``n_rows``, the sink
    page's first."""
    local = rows.long() - row_offset
    inside = (local >= 0) & (local < n_rows)
    return torch.where(inside, local, torch.full_like(local, n_rows))


def scatter_paged_kv_local(pool, new, page_table, positions, page_offset):
    """In-place sharded decode write (counterpart of the JAX
    ``scatter_paged_kv_local``): slot b's row (B, 1, KV, D), or its scale
    (B, 1, KV) into a scale shard, lands at ``table[b, pos // page]`` (a
    GLOBAL id) if that page is in this shard's window starting at global
    page ``page_offset``, else in the sink.  ``pool`` is the shard with its
    sink, (P/n + 1, page, ...).  Exactly one rank, or none for a freed
    slot on scratch page 0 outside rank 0, commits each row, so the union
    of the windows is the single-rank pool."""
    check_pool_write(pool, new, "scatter_paged_kv_local")
    pn, page = pool.shape[0] - 1, pool.shape[1]
    flat = pool.view(-1, *pool.shape[2:])
    pos = positions.long()
    page_ids = page_table.long().gather(1, (pos // page)[:, None])[:, 0]
    idx = _local_rows(page_ids * page + pos % page, page_offset * page,
                      pn * page)
    flat[idx] = new[:, 0].to(pool.dtype)


def scatter_chunk_paged_local(pool, new, dest, row_offset: int):
    """In-place sharded prefill write (counterpart of the JAX
    ``scatter_chunk_paged_local``): ``new`` (B, C, ...) lands at ``dest``
    (B, C) GLOBAL flat pool rows (page * page_size + row) where they fall in
    this shard's window, whose first row has global index ``row_offset``;
    the rest go to the sink.  ``pool`` is the shard with its sink.
    Scratch-routed positions (flat row 0) land on rank 0's scratch page, as
    on one card."""
    check_pool_write(pool, new, "scatter_chunk_paged_local")
    pn, page = pool.shape[0] - 1, pool.shape[1]
    flat = pool.view(-1, *pool.shape[2:])
    idx = _local_rows(dest.reshape(-1), row_offset, pn * page)
    flat[idx] = new.reshape(-1, *new.shape[dest.dim():]).to(pool.dtype)


def paged_gather_partials(q, k_pool, v_pool, page_table, positions,
                          page_offset: int, k_scale=None, v_scale=None):
    """One shard's partial paged decode through a gathered view (counterpart
    of the JAX ``paged_gather_partials``; K1's partials mode walks the table
    instead): the one-row case of ``paged_gather_chunk_partials``.  q (B, 1,
    KV, G, D) at (B,) ``positions``.  Returns the raw fp32 triple (acc (B,
    1, KV, G, D), l (B, KV, G), m (B, KV, G))."""
    acc, l, m = paged_gather_chunk_partials(
        q, k_pool, v_pool, page_table, positions[:, None], positions,
        page_offset, k_scale=k_scale, v_scale=v_scale)
    return acc, l[..., 0], m[..., 0]


def merge_partials_local(triples):
    """The cross-shard online-softmax merge over a list of (acc (B, 1, KV,
    G, D), l, m (B, KV, G)) triples held in one process:
    ``sum(acc * w) / max(sum(l * w), 1e-30)`` with ``w = exp(m - max m)``.
    A shard with m = NEG_INF weighs exactly 0."""
    gm = torch.stack([m for _, _, m in triples]).amax(dim=0)
    num = den = 0
    for acc, l, m in triples:
        w = torch.exp(m - gm)
        num = num + acc * w[:, None, :, :, None]
        den = den + l * w
    return num / torch.clamp(den, min=1e-30)[:, None, :, :, None]


def paged_gather_chunk_partials(q, k_pool, v_pool, page_table, qpos,
                                last_pos, page_offset: int, k_scale=None,
                                v_scale=None):
    """One shard's partial chunk attention through a gathered view (the JAX
    ``paged_gather_chunk_partials``).  q (B, C, KV, G, D); pools the
    shard's window (P/n, page, KV, D), global ids from ``page_offset``;
    page_table (B, M) GLOBAL ids; qpos (B, C) each row's position; last_pos
    (B,).  Entries outside the window or past ``last_pos`` are masked like
    dead pages (gathered through local page 0, scores NEG_INF) and each row
    sees columns ``<= min(qpos, last_pos)``.  Int8 shards dequantize the
    gathered rows to fp32 through their scale shards.  Returns the raw fp32
    triple (acc (B, C, KV, G, D), l (B, KV, G, C), m (B, KV, G, C)); the
    explicit ``where`` on p makes a shard with no live row of a slot give
    (0, 0, NEG_INF), where ``exp(s - max)`` alone would give exp(0) = 1."""
    hd = q.shape[-1]
    b, m = page_table.shape
    pn, page = k_pool.shape[:2]
    last = last_pos.long()
    live = (torch.arange(m, device=q.device)[None, :]
            <= (last // page)[:, None])
    local = page_table.long() - page_offset
    ok = live & (local >= 0) & (local < pn)
    lt = torch.where(ok, local, torch.zeros_like(local))
    kg = k_pool[lt].reshape(b, m * page, *k_pool.shape[2:])
    vg = v_pool[lt].reshape(b, m * page, *v_pool.shape[2:])
    if k_scale is not None:
        kg = dequant_gathered(kg, k_scale, lt, torch.float32)
        vg = dequant_gathered(vg, v_scale, lt, torch.float32)
    ct = torch.promote_types(q.dtype, kg.dtype)
    s = torch.einsum("bqkgd,bskd->bkgqs", q.to(ct), kg.to(ct)).float()
    s = s / math.sqrt(hd)
    cols = torch.arange(m * page, device=q.device)
    valid = ((cols[None, None, :]
              <= torch.minimum(qpos.long(), last[:, None])[:, :, None])
             & ok.repeat_interleave(page, dim=1)[:, None, :]
             )[:, None, None]                                # (B,1,1,C,S)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    mx = s.amax(dim=-1)
    p = torch.where(valid, torch.exp(s - mx[..., None]), torch.zeros_like(s))
    acc = torch.einsum("bkgqs,bskd->bqkgd", p, vg.float())
    return acc, p.sum(dim=-1), mx


def merge_paged_chunk_partials(acc, l, m, pool_group):
    """The cross-rank merge of C-row partials (the JAX
    ``merge_paged_chunk_partials``): acc (B, C, KV, G, D), l and m
    (B, KV, G, C).  One all_reduce MAX of m, then one all_reduce SUM of
    acc·w and l·w packed into one (B, C, KV, G, D + 1) tensor, ``w = exp(m
    - max m)``; the result is the same on every rank.  Only padding rows,
    whose outputs are discarded, can see no live row on any rank."""
    gm = pool_group.all_max(m.clone())
    w = torch.exp(m - gm).permute(0, 3, 1, 2)[..., None]
    d = acc.shape[-1]
    packed = torch.cat([acc * w, l.permute(0, 3, 1, 2)[..., None] * w],
                       dim=-1)
    pool_group.all_sum(packed)
    return packed[..., :d] / torch.clamp(packed[..., d:], min=1e-30)


def merge_paged_partials(acc, l, m, pool_group):
    """The decode merge (counterpart of the JAX ``merge_paged_partials``):
    the one-row case of ``merge_paged_chunk_partials``, acc (B, 1, KV, G,
    D), l and m (B, KV, G).  The denominator vanishes only if no rank saw
    a live row, which the scratch-page convention rules out (logical page
    0 is live at every position)."""
    return merge_paged_chunk_partials(acc, l[..., None], m[..., None],
                                      pool_group)


def attention_decode_block(p, cfg, x, k_pool, v_pool, positions,
                           page_table=None, decode_impl: str = "kernel",
                           norm_impl: str = "kernel", k_scale=None,
                           v_scale=None, pool_group=None, dp_group=None):
    """One-token decode at per-slot (B,) positions.  x (B, 1, d).  The new
    K/V row is written into the pools (in place) before attending, and the
    slot attends to its own position too.  With int8 pools (``k_scale``/
    ``v_scale`` given) the row is quantized first and its scale written
    through the same table index, so the slot reads its own new row back
    from int8, as the JAX model does.  With ``pool_group`` the pools are
    this rank's shards (with their sink pages) of pools split over the
    group, and the write and attention go through
    ``repro_torch.parallel.pagedkv.sharded_paged_decode_attention``
    (``dp_group``: its 2-D mesh's dp group).
    Without ``page_table`` the caches are the dense (B, S, KV, D) rows of
    the contiguous layout, written in place (``decode_impl`` ignored)."""
    q, k, v = project_qkv(p, cfg, x, positions[:, None], norm_impl)
    if page_table is None:
        if k_scale is not None or pool_group is not None:
            raise ValueError("int8 pages and pool groups are paged-backend "
                             "formats; the contiguous layout has no pages")
        _scatter_decode_kv(k_pool, k, positions)
        _scatter_decode_kv(v_pool, v, positions)
        return output_proj(p, cfg, decode_attention(q, k_pool, v_pool,
                                                    positions))
    if pool_group is not None:
        from repro_torch.parallel.pagedkv import \
            sharded_paged_decode_attention
        y = sharded_paged_decode_attention(
            pool_group, q, k, v, k_pool, v_pool, page_table, positions,
            decode_impl, k_scale=k_scale, v_scale=v_scale, dp_group=dp_group)
        return output_proj(p, cfg, y)
    if k_scale is not None:
        k, sk = quantize_kv(k)
        v, sv = quantize_kv(v)
        _scatter_paged_kv(k_scale, sk, page_table, positions)
        _scatter_paged_kv(v_scale, sv, page_table, positions)
    _scatter_paged_kv(k_pool, k, page_table, positions)
    _scatter_paged_kv(v_pool, v, page_table, positions)
    y = decode_attention(q, k_pool, v_pool, positions, page_table,
                         decode_impl, k_scale=k_scale, v_scale=v_scale)
    return output_proj(p, cfg, y)


# ------------------------------------------------- sharded dense decode ----

def dense_decode_partials(q, k_rows, v_rows, positions, offset: int):
    """One rank's partial decode attention over its rows of a dense cache
    split along the sequence: q (B, 1, KV, G, D) at (B,) global
    ``positions``; k_rows, v_rows (B, S_local, KV, D), the positions from
    ``offset``.  Row j is live where ``offset + j <= positions``; with
    ``positions`` None every row is (the cross-attention's encoder rows).
    Scores and softmax in fp32, the weights cast to the rows' dtype before
    PV, as in ``chunk_attention``.  Returns the raw fp32 triple (acc (B,
    1, KV, G, D), l (B, KV, G), m (B, KV, G)); a rank with no live row of
    a slot gives (0, 0, NEG_INF)."""
    s = torch.einsum("bqkgd,bskd->bkgqs", q, k_rows).float()[..., 0, :]
    s = s / math.sqrt(q.shape[-1])
    if positions is None:
        mx = s.amax(dim=-1)
        p = torch.exp(s - mx[..., None])
    else:
        cols = offset + torch.arange(k_rows.shape[1], device=q.device)
        valid = (cols[None, :] <= positions.long()[:, None])[:, None, None]
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        mx = s.amax(dim=-1)
        p = torch.where(valid, torch.exp(s - mx[..., None]),
                        torch.zeros_like(s))
    acc = torch.einsum("bkgs,bskd->bkgd", p.to(v_rows.dtype), v_rows)
    return acc.float()[:, None], p.sum(dim=-1), mx


def merge_decode_partials(acc, l, m, group):
    """The online-softmax merge of ``dense_decode_partials`` over the ranks
    of ``group`` (``None``: this rank's alone), in functional collectives:
    one all-reduce MAX of m, then one all-reduce SUM of acc·w and l·w
    packed into one (B, 1, KV, G, D + 1) tensor, ``w = exp(m - max m)``.
    Returns (B, 1, KV, G, D) fp32, the same on every rank."""
    gm = coll.all_reduce(m, group, op="max")
    w = torch.exp(m - gm)[:, None, ..., None]
    d = acc.shape[-1]
    packed = coll.all_reduce(torch.cat([acc * w, l[:, None, ..., None] * w],
                                       dim=-1), group)
    return packed[..., :d] / torch.clamp(packed[..., d:], min=1e-30)


def sharded_attention_decode_block(p, cfg, x, k_rows, v_rows, positions,
                                   seq_group, offset: int,
                                   norm_impl: str = "kernel"):
    """One-token decode of this rank's batch rows over its rows of a dense
    cache split along the sequence over ``seq_group`` (its positions from
    ``offset``; ``None``: the whole sequence), under a sharding context.
    The projections are tensor-parallel (``tpmm``); q, k and v come out
    with every head (gathered over the model group where the rules split
    the heads, whole where they drop the split) and enter the
    sequence-split attention through ``copy_to``.  The rank holding a
    slot's position writes its new K/V row in place; every rank attends
    over its live rows, the partials merge over ``seq_group``, and the
    output projection takes this rank's heads of the merged rows and
    reduces over the model group.  x (B, 1, d) -> (B, 1, d)."""
    psum = torch.float32
    q, k, v = project_qkv(p, cfg, x, positions[:, None], norm_impl,
                          full_heads=True, psum_dtype=psum)
    q, k, v = (coll.copy_to(t, seq_group, psum) for t in (q, k, v))
    b, s_loc = k_rows.shape[:2]
    local = positions.long() - offset
    mine = ((local >= 0) & (local < s_loc))[:, None, None]
    idx = local.clamp(0, s_loc - 1)
    rows = torch.arange(b, device=x.device)
    for cache, new in ((k_rows, k), (v_rows, v)):
        cache[rows, idx] = torch.where(mine, new[:, 0].to(cache.dtype),
                                       cache[rows, idx])
    return _merged_out(p, cfg, q, k_rows, v_rows, positions, seq_group,
                       offset)


def _merged_out(p, cfg, q, k_rows, v_rows, positions, seq_group, offset):
    """The sequence-split decode attention of q (every head) over this
    rank's rows, merged over ``seq_group``, then the output projection of
    this rank's heads, reduced over the model group in fp32."""
    psum = torch.float32
    y = merge_decode_partials(
        *dense_decode_partials(q, k_rows, v_rows, positions, offset),
        seq_group).to(q.dtype)
    y = y.reshape(*y.shape[:2], -1, y.shape[-1])
    g = tp_group(p["wo"]["kernel"], 0)
    if g is not None:          # every head on every rank: keep this rank's
        hl = p["wo"]["kernel"].shape[0]
        r = coll.group_rank(g)
        y = coll.copy_to(y, g, psum)[:, :, r * hl:(r + 1) * hl]
    return output_proj(p, cfg, y, psum)


def sharded_cross_attention_decode_block(p, cfg, x, k_rows, v_rows,
                                         seq_group):
    """One decoder token's cross-attention under a sharding context, over
    this rank's rows of the encoder K/V (B, E_local, KV, D), split along
    the encoder sequence over ``seq_group`` (``None``: all E rows):
    non-causal over every row, the partials merged over the group as
    ``sharded_attention_decode_block`` merges the self-attention's.  q
    comes out of the tensor-parallel projection with every head (gathered
    over the model group where the rules split the heads).  x (B, 1, d)
    -> (B, 1, d)."""
    psum = torch.float32
    q = coll.gather_from(_proj(p["wq"], x, psum), 2,
                         tp_group(p["wq"]["kernel"], 1))
    q = coll.copy_to(q, seq_group, psum)
    kv = k_rows.shape[2]
    q = q.reshape(*q.shape[:2], kv, q.shape[2] // kv, q.shape[-1])
    return _merged_out(p, cfg, q, k_rows, v_rows, None, seq_group, 0)
