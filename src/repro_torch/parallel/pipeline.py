"""Pipeline parallelism (GPipe) over a mesh axis (counterpart of the JAX
``repro.parallel.pipeline``).

Each rank of the stage axis holds a contiguous slice of the layers; M
microbatches stream through with point-to-point hops, in JAX's schedule:
at step t = 0 .. M + n − 2, stage s runs microbatch t − s (stage 0 from
the input, the others from what stage s − 1 sent at t − 1) and sends its
output on.  The last stage's outputs are then summed over the stage group,
so every stage returns them (JAX's psum broadcast).  The backward is
autograd's: each hop is an autograd function whose backward sends (or
receives) the gradient the other way, and each layer body stays under the
checkpoint (GPipe: every forward lives, then the backwards; remat trades
the activations back for compute).  Hops are tagged with their
microbatch, and every stage walks its backward from the last microbatch
down, so the hops of the two passes pair up.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.parallel import collectives as coll


class _Send(torch.autograd.Function):
    """Sends y on; returns a 0-d zero to add to the output, whose backward
    receives y's gradient from the stage y went to."""

    @staticmethod
    def forward(ctx, y, dst, group, tag):
        coll.send(y, dst, group, tag)
        ctx.like, ctx.dst, ctx.group, ctx.tag = (
            torch.empty_like(y, device="meta"), dst, group, tag)
        ctx.device = y.device
        return y.new_zeros(())

    @staticmethod
    def backward(ctx, g):
        like = torch.empty(ctx.like.shape, dtype=ctx.like.dtype,
                           device=ctx.device)
        return coll.recv(like, ctx.dst, ctx.group, ctx.tag), None, None, None


class _Recv(torch.autograd.Function):
    """Receives a microbatch from the stage before; the backward sends its
    gradient back.  ``anchor`` (a 0-d zero that depends on the stage's
    parameters) only puts the receive into the graph."""

    @staticmethod
    def forward(ctx, anchor, like, src, group, tag):
        ctx.src, ctx.group, ctx.tag = src, group, tag
        return coll.recv(like, src, group, tag)

    @staticmethod
    def backward(ctx, g):
        coll.send(g, ctx.src, ctx.group, ctx.tag)
        return torch.zeros((), device=g.device), None, None, None, None


def pipeline_forward(stage_fn: Callable, n_stages: int, axis: str, mesh):
    """Returns ``run(stage_params, x_mb)`` for this rank's stage of
    ``mesh``'s ``axis``.  ``stage_fn(stage_params, x) -> y`` applies this
    stage's layers; ``x_mb`` (M, mb, ...) holds every microbatch on every
    stage (stage 0 consumes them).  Returns the last stage's (M, mb, ...)
    outputs on every stage."""
    s = mesh.coords[axis]
    group = mesh.group(axis)

    def run(stage_params, x_mb):
        m_total = x_mb.shape[0]
        last = s == n_stages - 1
        like = x_mb[0]
        # a 0-d zero on the path to this stage's parameters: autograd runs
        # only the nodes between the loss and the tensors asked for, and
        # the receives' backwards (which send gradients on) must run
        anchor = sum((t.reshape(-1)[:1] * 0).sum()
                     for t in _leaves(stage_params) if t.requires_grad)
        if not isinstance(anchor, torch.Tensor):
            anchor = torch.zeros((), device=x_mb.device)
        outs, tokens, buf = [], [], None
        for t in range(m_total + n_stages - 1):
            m = t - s
            if 0 <= m < m_total:
                y = stage_fn(stage_params, x_mb[m] if s == 0 else buf)
                if last:
                    outs.append(y)
                else:
                    tokens.append(_Send.apply(y, s + 1, group, m))
            if s > 0 and 0 <= t + 1 - s < m_total:
                buf = _Recv.apply(anchor, like, s - 1, group, t + 1 - s)
        out = torch.stack(outs) if last else torch.zeros_like(x_mb)
        if tokens:
            out = out + sum(tokens)
        return coll.reduce_from(out, group)

    return run


def make_pipelined_apply(layer_fn: Callable, mesh, axis: str,
                         n_microbatches: int, remat: bool = True):
    """Builds ``apply(stage_params, x)``: ``stage_params`` leaves are this
    stage's contiguous slice (layers_per_stage, ...) of the stacked layers
    (stage s holds layers [s·L/n, (s+1)·L/n)), ``x`` (batch, ...) the whole
    input on every stage, split into ``n_microbatches``.  Each layer runs
    ``layer_fn(layer_params, h)``, under the checkpoint with ``remat``.
    Every stage returns the whole (batch, ...) result."""
    n_stages = mesh.shape[axis]

    def stage_fn(stage_params, x):
        n = next(iter(_leaves(stage_params))).shape[0]
        h = x
        for i in range(n):
            lp = _layer(stage_params, i)
            if remat:
                h = checkpoint(layer_fn, lp, h, use_reentrant=False)
            else:
                h = layer_fn(lp, h)
        return h

    pipe = pipeline_forward(stage_fn, n_stages, axis, mesh)

    def apply(params, x):
        b = x.shape[0]
        if b % n_microbatches:
            raise ValueError(f"batch {b} does not split into "
                             f"{n_microbatches} microbatches")
        x_mb = x.reshape(n_microbatches, b // n_microbatches, *x.shape[1:])
        return pipe(params, x_mb).reshape(b, *x.shape[1:])

    return apply


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]
