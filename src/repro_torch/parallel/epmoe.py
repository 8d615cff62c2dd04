"""Expert-parallel MoE over ``all_to_all`` (counterpart of the JAX
``repro.parallel.epmoe``).

Without it, an expert split over the model axis (``models.moe.moe_ffn``
under a sharding context) has every rank dispatch the whole batch and
reduce (B, S, d) partial sums.  The expert-parallel pattern exchanges only
the dispatched token slots:

  each model rank routes its own t/n token slice (the full router) ->
  scatters slot-major into an (E·cap, d) send buffer -> all_to_all over
  the model group (each rank keeps its E/n experts' slots from every rank)
  -> its experts' products -> all_to_all back -> local combine -> the
  rows are all-gathered over the model group.

Capacity is counted per rank (per device, the GShard choice at scale), so
the result differs from the single-device ``moe_ffn``, whose groups are
sequences: the port's EP is held to JAX's EP.  The load-balance loss of
each rank's tokens is averaged over the dp and model groups.  arctic's
dense residual runs tensor-parallel with a compute-dtype reduction
(``tpmm.down_proj_tp``), as JAX's.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import activation
from repro_torch.models.moe import (_capacity, _one_hot, capacity_slots,
                                    dispatch, moe_ffn, top_k)
from repro_torch.models.mlp import mlp
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import active_mesh, batch_axes
from repro_torch.parallel.tpmm import tp_group


class _MeanOver(torch.autograd.Function):
    """The mean over ``group`` of a value each rank holds its own of, whose
    result every rank of ``group`` then uses alike: the backward gives
    each rank's value the summed gradient of the distinct uses (over
    ``dp``, the model group's ranks using it identically) over n."""

    @staticmethod
    def forward(ctx, x, group, dp):
        ctx.n, ctx.dp = coll.group_size(group), dp
        return coll.all_reduce(x, group) / ctx.n

    @staticmethod
    def backward(ctx, g):
        return coll.all_reduce(g, ctx.dp) / ctx.n, None, None


def moe_ffn_ep(p, cfg, x, axis: str = "model"):
    """Drop-in for ``moe.moe_ffn`` under a sharding context.  x (B, S, d),
    this rank's batch rows, the same on every rank of the model group.
    Returns (y (B, S, d), aux).  Outside a context, or when the experts do
    not split over ``axis``, it is ``moe_ffn``."""
    ctx = active_mesh()
    n_exp = cfg.num_experts
    if ctx is None or axis not in ctx[0].shape \
            or tp_group(p["wi"]["kernel"], 0, axis) is None:
        return moe_ffn(p, cfg, x)
    mesh, rules = ctx
    g = mesh.group(axis)
    n_sh, me = coll.group_size(g), coll.group_rank(g)
    dp_axes = batch_axes(mesh, rules)
    dp = mesh.group(dp_axes) if dp_axes else None
    k = cfg.experts_per_token
    e_loc = n_exp // n_sh
    b_loc, s, d = x.shape
    t_all = b_loc * s
    if t_all % n_sh:
        raise ValueError(f"{t_all} tokens do not split over {n_sh} ranks")
    t = t_all // n_sh
    dtype = x.dtype
    cap = _capacity(t, cfg)

    # ------- routing: this rank's token slice, the full router ------------
    xf = coll.copy_to(x, g).reshape(t_all, d)[me * t:(me + 1) * t]
    router = p["router"]["kernel"]
    rg = tp_group(router, 1, axis)
    if rg is not None:          # the router's columns gathered, summed back
        router = coll.gather_from(router, 1, rg, "sum")
    probs = torch.softmax(xf.float() @ router.float(), dim=-1)
    gates, ids = top_k(probs, k)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    density = _one_hot(ids[:, 0], n_exp).float().mean(dim=0)
    aux = (density * probs.mean(dim=0)).mean() * (n_exp * n_exp)
    aux = _MeanOver.apply(aux, mesh.group(dp_axes + (axis,)), dp)

    # ------- capacity positions, dispatch, all_to_all to the owners -------
    flat_idx, keep = capacity_slots(ids[None], gates[None], cap, n_exp)
    flat_idx, keep = flat_idx[0], keep[0].to(dtype)
    buf = dispatch(xf[None], flat_idx[None], keep[None], n_exp * cap)[0]
    # chunk r of dim 0 holds rank r's experts' slots; received: [src][e][c]
    recv = coll.exchange(buf, g)
    recv = recv.reshape(n_sh, e_loc, cap, d).transpose(0, 1) \
        .reshape(e_loc, n_sh * cap, d)

    # ------- this rank's experts ------------------------------------------
    act = activation(cfg.act)
    hi = torch.einsum("ecd,edf->ecf", recv, p["wi"]["kernel"].to(dtype))
    hg = torch.einsum("ecd,edf->ecf", recv, p["wg"]["kernel"].to(dtype))
    out = torch.einsum("ecf,efd->ecd", act(hg) * hi,
                       p["wo"]["kernel"].to(dtype))

    # ------- slots back to their sources, local combine -------------------
    back = out.reshape(e_loc, n_sh, cap, d).transpose(0, 1) \
        .reshape(n_sh * e_loc * cap, d)
    ret = coll.exchange(back, g)        # [owner][e][c] == flat_idx's layout
    y = torch.zeros_like(xf)
    for j in range(k):
        y = y + ret[flat_idx[:, j]] * (gates[:, j, None].to(dtype)
                                       * keep[:, j, None])
    y = coll.gather_from(y, 0, g).reshape(b_loc, s, d)

    # ------- arctic's dense residual: reductions in the compute dtype -----
    if "dense" in p:
        y = y + mlp(p["dense"], cfg, x, tp_shardmap=True)
    return y, aux


def wire_bytes(cfg, tokens_per_rank: int, itemsize: int) -> int:
    """The formula of JAX's ``epmoe`` for the bytes of one layer's two
    all_to_alls on one rank: 2 · T_loc · k · cf · d · itemsize (both hops;
    the (E·cap, d) slot buffer is about T_loc · k · cf rows)."""
    return int(2 * tokens_per_rank * cfg.experts_per_token
               * cfg.capacity_factor * cfg.d_model * itemsize)


def slot_bytes(cfg, tokens_per_rank: int, itemsize: int) -> int:
    """The bytes one layer's two all_to_alls take on one rank: twice the
    (E·cap, d) slot buffer, cap = ``_capacity(T_loc)``."""
    cap = _capacity(tokens_per_rank, cfg)
    return 2 * cfg.num_experts * cap * cfg.d_model * itemsize
