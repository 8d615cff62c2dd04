"""Gradient compression for data-parallel synchronization (counterpart of
the JAX ``repro.parallel.compression``): int8 quantization with error
feedback (the residual is carried to the next step), exchanged by
all-gather so the wire format stays int8 end to end.

Wire accounting per rank per step (N-way DP, G gradient floats):
  f32 ring all-reduce:            2 · 4B · G      = 8G bytes
  int8 AG-based compressed sync:  1B · G + 4B·G/N ≈ 1G bytes   (~8x less)

Where JAX's functions run inside a ``shard_map`` over a mesh axis, the
port's run on each rank of the axis's process group, each with its own
gradients.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.quant import dequantize, quantize_int8  # noqa: F401
from repro_torch.parallel import collectives as coll
from repro_torch.train.optimizer import tree_leaves


def compressed_allreduce_mean(x, err, *, group):
    """This rank's ``x`` and error state -> (the fp32 mean over ``group``
    of every rank's dequantized int8 ``x + err``, the new error state).
    The int8 values and the fp32 scales are all-gathered; the mean is taken
    locally, in group-rank order."""
    q, scale, new_err = quantize_int8(x, err)
    qs = coll.all_gather(q[None], 0, group)                 # (N, ...) int8
    scales = coll.all_gather(scale.reshape(1), 0, group)    # (N,) fp32
    mean = (qs.float() * scales.reshape((-1,) + (1,) * x.dim())).mean(dim=0)
    return mean, new_err


def _unflatten(tree, leaves):
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)
    return build(tree)


def make_compressed_grad_sync(mesh, axis: str):
    """Returns ``sync(grads, err_state) -> (mean_grads, new_err_state)``:
    each rank of ``mesh``'s ``axis`` passes its own gradient tree (pure
    DP), and every rank gets the compressed mean."""
    group = mesh.group(axis)

    def sync(grads, err_state):
        outs = [compressed_allreduce_mean(g, e, group=group)
                for g, e in zip(tree_leaves(grads), tree_leaves(err_state))]
        return (_unflatten(grads, [o[0] for o in outs]),
                _unflatten(grads, [o[1] for o in outs]))

    return sync


def init_error_state(grads):
    return _unflatten(grads, [torch.zeros(g.shape, device=g.device)
                              for g in tree_leaves(grads)])


def wire_bytes_f32_allreduce(n_floats: int) -> int:
    return 8 * n_floats


def wire_bytes_int8_sync(n_floats: int, n_dp: int) -> int:
    return n_floats + (4 * n_floats) // max(n_dp, 1)
