"""Tensor-parallel contractions of the port (counterpart of the JAX
``repro.parallel.tpmm``).

Each takes this rank's model shard of a weight, as
``ShardedForward.use`` returns it (its batch-axis dims already gathered:
FSDP), and runs the contraction on the local shard:

* ``col_proj_tp``  — column parallel: the output dims are this rank's; no
  forward collective, and the backward all-reduces the input's gradient;
* ``o_proj_tp`` / ``down_proj_tp`` — row parallel: the contracted dim is
  this rank's, so the products are partial sums, all-reduced over the
  model group.

Two helpers serve the blocks whose split reaches past a contraction (the
recurrent mixers):

* ``local_part``     — this rank's block of a tensor that is whole on every
  model rank, entered through ``copy_to``, so the blocks' gradients sum
  over the group into the whole tensor's;
* ``split_rms_norm`` — RMSNorm over a dim split over the group: each row's
  sum of squares all-reduced in fp32, then each rank scales its columns.

``psum_dtype`` is the dtype of those reductions: the compute dtype by
default, which is ``tpmm``'s bf16 psum; ``torch.float32`` reduces the
partial sums in fp32 and casts after, JAX's GSPMD form, which the models
take unless ``ForwardOpts.tp_shardmap``.  Outside a sharding context, or
when the weight's dim is not split over the model axis (a dropped rule),
each is the plain contraction, as JAX's ``_ctx_ok`` falls back.

``TP_SAVE_NAME`` names, in JAX, the outputs that the selective remat
saves so that the backward replays no collective.  The port's selective
policy saves the collectives' own outputs
(``collectives.SAVED_OPS``): the same effect, seen by op rather than by
name.
"""
from __future__ import annotations

import torch

from repro_torch.models.common import add_bias
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.sharding import active_mesh

TP_SAVE_NAME = "tp_psum_out"


def tp_group(weight, dim: int, axis: str = "model"):
    """The process group of ``axis`` when ``weight``'s dim ``dim`` is this
    rank's shard of a split over it in the current context, else
    ``None``."""
    ctx = active_mesh()
    if ctx is None or axis not in ctx[0].shape:
        return None
    axes = getattr(weight, "mesh_axes", None)
    if axes is None or axes[dim] != axis:
        return None
    return ctx[0].group(axis)


def _with_bias(out, bias):
    return out if bias is None else add_bias({"bias": bias}, out)


def col_proj_tp(x, kernel, bias=None, axis: str = "model", psum_dtype=None):
    """x (B, S, d) @ kernel (d, F) or (d, H, D) -> (B, S, F) or
    (B, S, H, D) in x's dtype, plus the bias of the output dims; with the
    output's first dim split over ``axis``, this rank's columns."""
    g = tp_group(kernel, 1, axis)
    x = coll.copy_to(x, g, psum_dtype)
    w2 = kernel.reshape(kernel.shape[0], -1).to(x.dtype)
    out = (x @ w2).reshape(*x.shape[:-1], *kernel.shape[1:])
    return _with_bias(out, bias)


def o_proj_tp(y, kernel, bias=None, axis: str = "model", psum_dtype=None):
    """y (B, S, H, D) @ kernel (H, D, dm) -> (B, S, dm), plus the bias;
    with H split over ``axis``, y holds this rank's heads and the partial
    sums are all-reduced in ``psum_dtype``."""
    g = tp_group(kernel, 0, axis)
    out = y.reshape(*y.shape[:2], -1) @ kernel.reshape(
        -1, kernel.shape[-1]).to(y.dtype)
    return _with_bias(coll.reduce_from(out, g, psum_dtype), bias)


def down_proj_tp(h, kernel, bias=None, axis: str = "model", psum_dtype=None):
    """h (B, S, F) @ kernel (F, dm) -> (B, S, dm), plus the bias; with F
    split over ``axis``, h holds this rank's columns and the partial sums
    are all-reduced in ``psum_dtype``."""
    g = tp_group(kernel, 0, axis)
    out = h @ kernel.to(h.dtype)
    return _with_bias(coll.reduce_from(out, g, psum_dtype), bias)


def local_part(t, dim: int, group, psum_dtype=None):
    """This rank's 1/n block along ``dim`` of ``t``, a tensor whole and the
    same on every rank of ``group``: ``copy_to`` then the block, so the
    backward sums each rank's block gradient over the group into the whole
    tensor's gradient.  ``group`` None: ``t`` as it is."""
    if group is None:
        return t
    w = t.shape[dim] // coll.group_size(group)
    return coll.copy_to(t, group, psum_dtype).narrow(
        dim, coll.group_rank(group) * w, w)


def split_rms_norm(x, scale, eps: float, group):
    """RMSNorm over the last dim of a tensor split along it over ``group``:
    ``x`` and ``scale`` are this rank's columns.  Each row's sum of squares
    is all-reduced over the group in fp32, one (..., 1) collective whose
    backward is an all-reduce too (every rank's columns read the whole
    sum); the rest is ``rmsnorm_ref``'s fp32 arithmetic, cast back to x's
    dtype.  ``group`` None: the whole row's norm."""
    xf = x.float()
    ss = (xf * xf).sum(dim=-1, keepdim=True)
    ss = coll.copy_to(coll.reduce_from(ss, group, torch.float32), group,
                      torch.float32)
    var = ss / (x.shape[-1] * coll.group_size(group))
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)
