"""Sequence-sharded self-attention (counterpart of the JAX
``repro.parallel.seqattn``).

For architectures whose head count does not divide the ``model`` mesh
axis, splitting heads would replicate the whole attention block over the
model group.  This path splits the *query rows* instead: each model rank
takes S/n rows of q and its S/n rows of K/V, all-gathers K/V over the model
group, and attends its rows to the full K/V with a causal mask from its
global offset ``rank · S/n``; the rows are then gathered back, so the
output is whole on every rank.  It loses the static causal skip of
``blockwise_attention`` (every KV block is visited and masked), as JAX's
does.
"""
from __future__ import annotations

import math

import torch

from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import active_mesh

NEG_INF = -1e30


def _blockwise_dyn_offset(q, k, v, q_offset: int, q_chunk: int,
                          kv_chunk: int):
    """Blockwise online-softmax attention with query rows starting at
    position ``q_offset``; every KV block is visited and masked (the JAX
    ``_blockwise_dyn_offset``).  q (B, Sq, KV, G, D); k, v (B, Skv, KV, D)."""
    b, sq, kvh, g, hd = q.shape
    skv = k.shape[1]
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    if sq % q_chunk or skv % kv_chunk:
        raise ValueError(f"chunks ({q_chunk}, {kv_chunk}) do not divide "
                         f"({sq}, {skv})")
    q = q * (1.0 / math.sqrt(hd))
    dev = q.device
    outs = []
    for i in range(sq // q_chunk):
        q_blk = q[:, i * q_chunk:(i + 1) * q_chunk]
        qpos = q_offset + i * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((b, kvh, g, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((b, kvh, g, q_chunk), device=dev)
        acc = torch.zeros((b, kvh, g, q_chunk, hd), device=dev)
        for j in range(skv // kv_chunk):
            kj = k[:, j * kv_chunk:(j + 1) * kv_chunk]
            vj = v[:, j * kv_chunk:(j + 1) * kv_chunk]
            kpos = j * kv_chunk + torch.arange(kv_chunk, device=dev)
            s = torch.einsum("bqkgd,bskd->bkgqs", q_blk, kj).float()
            s = torch.where(qpos[:, None] >= kpos[None, :], s,
                            torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(vj.dtype), vj)
            acc = acc * corr[..., None] + pv.float()
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        outs.append(o.permute(0, 3, 1, 2, 4).to(q.dtype))
    return torch.cat(outs, dim=1) if len(outs) > 1 else outs[0]


def seq_sharded_attention(q, k, v, *, axis: str = "model",
                          q_chunk: int = 512, kv_chunk: int = 512):
    """q (B, S, KV, G, D); k, v (B, S, KV, D), whole and the same on every
    rank of the model group; returns (B, S, KV, G, D), causal, the same on
    every rank.  Outside a sharding context, or when S does not divide the
    axis, it runs on one rank at offset 0, as JAX's falls back."""
    ctx = active_mesh()
    s = q.shape[1]
    if ctx is None or axis not in ctx[0].shape or s % ctx[0].shape[axis]:
        return _blockwise_dyn_offset(q, k, v, 0, q_chunk, kv_chunk)
    mesh = ctx[0]
    g = mesh.group(axis)
    s_loc = s // mesh.shape[axis]
    rows = slice(coll.group_rank(g) * s_loc, (coll.group_rank(g) + 1) * s_loc)
    # whole inputs feeding this rank's rows: their gradient is summed over
    # the group; K/V rows go out and come back gathered, as in JAX
    q, k, v = (coll.copy_to(t, g) for t in (q, k, v))
    kf = coll.gather_from(k[:, rows], 1, g, "sum")
    vf = coll.gather_from(v[:, rows], 1, g, "sum")
    y = _blockwise_dyn_offset(q[:, rows], kf, vf, rows.start,
                              min(q_chunk, s_loc), kv_chunk)
    return coll.gather_from(y, 1, g, "slice")
