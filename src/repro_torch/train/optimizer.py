"""AdamW with mixed-precision master weights and the learning-rate schedule
of the port (counterpart of the JAX ``repro.train.optimizer``).

The optimizer state is a tree congruent with the parameters.  Unlike the
JAX version, which returns new trees, ``adamw_update`` updates the
parameters, moments and masters in place, with one K5 launch per parameter
tensor: a full-width state is 16 bytes per parameter, and new trees would
double it for the length of the update.  The clip scale stays on the
device and K5 reads it through a pointer, so the update makes no host
synchronisation; the step count is a host integer, so the learning rate and
bias corrections are host floats.  They are computed in float32, as JAX
computes them on the device.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.kernels.adamw_update import adamw_fused, adamw_ref
from repro_torch.parallel import collectives as coll


def tree_leaves(tree):
    """The tensors of a nested dict, in sorted-key order (JAX's order); a
    list or tuple of tensors is already its own leaves."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [leaf for x in tree for leaf in tree_leaves(x)]
    return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]


def tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return {k: tree_map(fn, v) for k, v in tree.items()}


def lr_schedule(tcfg: TrainConfig, step: int) -> float:
    """Linear warmup + cosine decay to min_lr_ratio, in float32."""
    f32 = np.float32
    step = f32(step)
    warm = np.minimum(step / f32(max(tcfg.warmup_steps, 1)), f32(1.0))
    total = max(tcfg.total_steps - tcfg.warmup_steps, 1)
    frac = np.clip((step - f32(tcfg.warmup_steps)) / f32(total), f32(0.0),
                   f32(1.0))
    cos = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * frac))
    mult = f32(tcfg.min_lr_ratio) + f32(1 - tcfg.min_lr_ratio) * cos
    return float(f32(tcfg.learning_rate) * warm * mult)


def init_opt_state(params) -> Dict[str, Any]:
    """fp32 moments, and fp32 masters only if some parameter is not fp32."""
    state = {"m": tree_map(lambda p: torch.zeros(p.shape, device=p.device),
                           params),
             "v": tree_map(lambda p: torch.zeros(p.shape, device=p.device),
                           params)}
    if any(p.dtype != torch.float32 for p in tree_leaves(params)):
        state["master"] = tree_map(lambda p: p.detach().float().clone(),
                                   params)
    return state


def global_norm(tree, groups=None):
    """The fp32 L2 norm over every leaf, a 0-d tensor on their device.
    ``groups`` (one per leaf of a sharded tree, ``None`` for a leaf whole
    on every rank): each leaf is this rank's shard, its squares are summed
    over the ranks of its group, and an element that a dropped rule
    replicates counts once."""
    leaves = tree_leaves(tree)
    if groups is None:
        return torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g, dtype=torch.float32)
             for g in leaves]))
    sums = {}
    for g, leaf in zip(groups, leaves):
        sq = torch.linalg.vector_norm(leaf, dtype=torch.float32).square()
        key = id(g)
        sums[key] = (g, sums[key][1] + sq) if key in sums else (g, sq)
    return torch.sqrt(sum(coll.all_reduce(sq, g) for g, sq in
                          sums.values()))


@torch.no_grad()
def adamw_update(grads, opt_state, params, step: int, tcfg: TrainConfig,
                 impl: str = "kernel", norm_groups=None):
    """One AdamW step of every parameter, in place.  ``grads`` is a tree
    congruent with ``params`` or its ``tree_leaves``; it may be bf16;
    moments and masters are fp32.  Weight decay applies to leaves of two or
    more dims, as in JAX (that includes the stacked (L, d) layer-norm
    scales).  ``impl="kernel"`` runs K5 (its plain version on CPU tensors),
    ``"plain"`` always the plain version.  On a sharded state every leaf is
    this rank's shard: the update is elementwise, so K5 on a shard is K5 on
    the whole leaf sliced, and the clip scale comes from the global norm
    over ``norm_groups`` (``global_norm``).  Returns {"grad_norm",
    "lr"}."""
    update = {"kernel": adamw_fused, "plain": adamw_ref}[impl]
    gnorm = global_norm(grads, norm_groups)
    scale = (torch.clamp(tcfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if tcfg.grad_clip > 0 else torch.ones((), device=gnorm.device))
    lr = lr_schedule(tcfg, step)
    t = np.float32(step + 1)
    bc1 = float(np.float32(1.0) - np.float32(tcfg.beta1) ** t)
    bc2 = float(np.float32(1.0) - np.float32(tcfg.beta2) ** t)
    masters = opt_state.get("master", params)
    for g, m, v, master in zip(tree_leaves(grads), tree_leaves(opt_state["m"]),
                               tree_leaves(opt_state["v"]),
                               tree_leaves(masters)):
        wd = (tcfg.weight_decay
              if master.ndim >= 2 and tcfg.weight_decay > 0 else 0.0)
        update(g, m, v, master, scale, lr=lr, beta1=tcfg.beta1,
               beta2=tcfg.beta2, eps=tcfg.eps, weight_decay=wd,
               bias_corr1=bc1, bias_corr2=bc2)
    if "master" in opt_state:
        for p, master in zip(tree_leaves(params), tree_leaves(masters)):
            p.copy_(master)
    return {"grad_norm": gnorm, "lr": lr}
