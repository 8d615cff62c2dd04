"""Mixture-of-Experts of the port (counterpart of the JAX
``repro.models.moe``): capacity-based dispatch into dense per-expert
buffers, so the expert FFN is three products batched over the expert dim.

Each group of tokens (one sequence in a forward, the whole batch of one
token per slot in a decode step) routes its tokens to their top-k experts
by an fp32 router.  Capacity positions come from one cumulative count over
the slot-major (k·S, E) one-hot, so every token's first choice outranks any
second choice (GShard priority); tokens past an expert's capacity are
dropped.  The k routing slots are scatter-added into (G, E·cap, d) buffers
and gathered back, weighted by their renormalised gates.

The order of every step is JAX's, because it decides which tokens an
expert keeps:
- the top-k is a stable descending sort, which is ``lax.top_k``'s order
  (the lowest index first among equal values, NaN above every number);
  ``torch.topk`` breaks ties otherwise;
- a NaN row still takes capacity, and its update (NaN × a keep of 0) still
  lands: in its own slot, or in slot ``cap − 1`` of the expert when the row
  was dropped, as JAX's scatter puts it;
- the gates are cast to the compute dtype before the combine's product.

Nothing here reads a value back to the host (no ``.item()``, no
data-dependent shapes; the one-hots compare with an ``arange``), so a
decode step with MoE layers replays as one CUDA graph.  No TPU kernel
computes any of this: JAX's expert GEMMs are plain einsums too.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models.common import P, activation
from repro_torch.models.mlp import mlp, mlp_spec
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.tpmm import col_proj_tp, tp_group


def moe_spec(cfg):
    """The JAX layouts: ``router`` (d, E), fp32 in every dtype (JAX
    multiplies it in fp32, and a bf16 router would pick other experts);
    ``wi``/``wg`` (E, d, f) and ``wo`` (E, f, d); with
    ``cfg.dense_residual`` (arctic) the dense FFN ``dense`` beside them."""
    d, e, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    spec = {"router": {"kernel": P((d, e), fp32=True,
                                   axes=("embed", "expert"))},
            "wi": {"kernel": P((e, d, f), axes=("expert", "embed", "mlp"))},
            "wg": {"kernel": P((e, d, f), axes=("expert", "embed", "mlp"))},
            "wo": {"kernel": P((e, f, d), axes=("expert", "mlp", "embed"))}}
    if cfg.dense_residual:
        spec["dense"] = mlp_spec(cfg)
    return spec


def _capacity(tokens_per_group: int, cfg) -> int:
    c = tokens_per_group * cfg.experts_per_token / cfg.num_experts
    return max(math.ceil(c * cfg.capacity_factor), cfg.experts_per_token)


def _one_hot(ids, n: int):
    """(..., n) int32 one-hot by comparison with an ``arange``
    (``F.one_hot`` checks its range, which reads back to the host)."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).to(
        torch.int32)


def top_k(probs, k: int):
    """``jax.lax.top_k``: the k largest along the last dim, descending, the
    lowest index first among equal values and NaN above every number; a
    stable descending sort gives that order."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def route(router_p, cfg, xg):
    """xg (G, S, d) -> gates (G, S, k) fp32, expert ids (G, S, k) and the
    Switch/GShard load-balance loss (× E²).  Under a sharding context that
    splits the experts, the router's columns are this rank's, and the
    logits are gathered whole."""
    w = router_p["kernel"]
    logits = coll.gather_from(col_proj_tp(xg.float(), w), -1,
                              tp_group(w, 1))
    probs = torch.softmax(logits, dim=-1)
    gates, ids = top_k(probs, cfg.experts_per_token)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    e = cfg.num_experts
    density = _one_hot(ids[..., 0], e).float().mean(dim=1)
    density_proxy = probs.mean(dim=1)
    aux = (density * density_proxy).mean() * (e * e)
    return gates, ids, aux


def capacity_slots(ids, gates, cap: int, num_experts: int):
    """Each routing slot's place in its expert's buffer: (flat_idx, keep),
    both (G, S, k).  Positions are an exclusive count over the slot-major
    (k·S, E) one-hot, so every first choice outranks any second choice;
    ``keep`` is 1 where the position is under ``cap`` and the gate is
    positive (a NaN gate is not).  ``flat_idx`` = expert · cap + the
    position clamped to cap − 1, where a dropped slot's update (times a
    keep of 0) still lands."""
    g, sg, k = ids.shape
    ids_sm = ids.transpose(1, 2).reshape(g, k * sg)
    onehot = _one_hot(ids_sm, num_experts)
    pos_in_expert = onehot.cumsum(dim=1) - onehot
    pos = pos_in_expert.gather(-1, ids_sm[..., None])[..., 0]
    pos = pos.reshape(g, k, sg).transpose(1, 2)
    keep = (pos < cap).float() * (gates > 0).float()
    return ids * cap + pos.clamp_max(cap - 1), keep


def dispatch(xg, flat_idx, keep, rows: int):
    """k scatter-adds of xg (G, S, d) times ``keep`` into a (G, rows, d)
    buffer, slot j = 0..k−1 in turn."""
    g, sg, d = xg.shape
    buf = torch.zeros((g, rows, d), dtype=xg.dtype, device=xg.device)
    for j in range(flat_idx.shape[-1]):
        buf = buf.scatter_add(1, flat_idx[..., j, None].expand(g, sg, d),
                              xg * keep[..., j, None])
    return buf


def moe_ffn(p, cfg, x, groups: int = 0, tp_shardmap: bool = False):
    """x (B, S, d) -> (y (B, S, d), aux).  ``groups`` defaults to B: each
    sequence routes on its own, capacity computed per sequence.  Under a
    sharding context that splits the experts over the model axis, routing
    and dispatch are the same on every rank, each rank runs its experts'
    products and combines their slots, and the partial sums are reduced
    over the model group (in fp32, or with ``tp_shardmap`` in the compute
    dtype)."""
    b, s, d = x.shape
    g = groups or b
    xg = x.reshape(g, (b * s) // g, d)
    sg = xg.shape[1]
    e = cfg.num_experts
    cap = _capacity(sg, cfg)
    dtype = x.dtype

    gates, ids, aux = route(p["router"], cfg, xg)
    flat_idx, keep = capacity_slots(ids, gates, cap, e)
    keep = keep.to(dtype)
    buf = dispatch(xg, flat_idx, keep, e * cap).reshape(g, e, cap, d)
    psum = None if tp_shardmap else torch.float32
    tp = tp_group(p["wi"]["kernel"], 0)
    e_loc = p["wi"]["kernel"].shape[0]
    first = coll.group_rank(tp) * e_loc * cap   # this rank's first slot
    if tp is not None:
        buf = coll.copy_to(buf, tp, psum)[:, coll.group_rank(tp) * e_loc:
                                          (coll.group_rank(tp) + 1) * e_loc]

    # the expert FFN: products batched over the expert dim
    act = activation(cfg.act)
    hi = torch.einsum("gecd,edf->gecf", buf, p["wi"]["kernel"].to(dtype))
    hg = torch.einsum("gecd,edf->gecf", buf, p["wg"]["kernel"].to(dtype))
    out = torch.einsum("gecf,efd->gecd", act(hg) * hi,
                       p["wo"]["kernel"].to(dtype))
    out_flat = out.reshape(g, e_loc * cap, d)

    # combine: k weighted gathers (of this rank's slots, under a split,
    # where the gates, whole on every rank, take a share of their gradient)
    gates = coll.copy_to(gates, tp, psum)
    y = torch.zeros_like(xg)
    for j in range(flat_idx.shape[-1]):
        idx = flat_idx[..., j]
        w = gates[..., j, None].to(dtype) * keep[..., j, None]
        if tp is not None:
            mine = (idx >= first) & (idx < first + e_loc * cap)
            idx = (idx - first).clamp(0, e_loc * cap - 1)
            w = w * mine[..., None].to(dtype)
        gathered = out_flat.gather(1, idx[..., None].expand(g, sg, d))
        y = y + gathered * w
    y = coll.reduce_from(y, tp, psum).reshape(b, s, d)
    if "dense" in p:             # arctic: the dense FFN beside the experts
        y = y + mlp(p["dense"], cfg, x, tp_shardmap)
    return y, aux


def moe_ffn_decode(p, cfg, x):
    """Decode-time MoE: one group over the batch of single tokens, every
    slot of the step included (a parked slot's token takes capacity too,
    as in JAX's engine)."""
    return moe_ffn(p, cfg, x, groups=1)
