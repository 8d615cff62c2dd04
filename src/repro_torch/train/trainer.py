"""Train-step factory of the port: loss -> gradients (with microbatch
accumulation) -> AdamW (counterpart of the JAX ``repro.train.trainer``).

The train state is ``{"params", "opt": {"m", "v"[, "master"]}, "step"}``:
tensors on one device, the step a host int.  The step returned by
``make_train_step`` updates the state in place and returns it, so a
full-width state is never held twice; gradients come from
``torch.autograd`` on the fp32 parameter leaves.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models import LM, ForwardOpts
from repro_torch.models.common import DTYPES
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.optimizer import tree_leaves

# the JAX trainer's forward: blockwise jnp attention and jnp rms_norm
TRAIN_OPTS = ForwardOpts(attn_impl="blockwise", norm_impl="plain")


def init_train_state(lm: LM, seed: int, tcfg: TrainConfig,
                     device="cuda") -> Dict[str, Any]:
    """Random parameters in ``cfg.param_dtype`` (fp32 masters, as JAX keeps
    them) from an explicit generator seeded with ``seed``, fresh moments,
    step 0.  ``tcfg`` is taken for the JAX signature; it sets nothing."""
    params = lm.init(seed, device=device, dtype=DTYPES[lm.cfg.param_dtype])
    return {"params": params, "opt": opt_mod.init_opt_state(params),
            "step": 0}


def _on_device(batch, device):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_train_step(lm: LM, tcfg: TrainConfig,
                    opts: ForwardOpts = TRAIN_OPTS, microbatches: int = 1,
                    adamw_impl: str = "kernel"):
    """Returns ``train_step(state, batch) -> (state, metrics)``.  ``batch``
    holds (B, S) "tokens" and "labels" (numpy arrays or tensors).  With
    ``microbatches`` > 1 the batch is split along B and fp32 gradients are
    accumulated, each divided by ``microbatches``, as JAX's scan does.
    ``metrics`` are the last microbatch's loss metrics (as in JAX, its
    "loss" is that microbatch's) plus "grad_norm" and "lr"; values are 0-d
    tensors or floats.  ``adamw_impl`` picks K5 or its plain version."""

    def loss_grads(params, leaves, batch):
        loss, metrics = lm.loss(params, batch, opts,
                                moe_aux_weight=tcfg.moe_aux_loss,
                                z_loss=tcfg.z_loss)
        grads = torch.autograd.grad(loss, leaves)
        return {k: v.detach() for k, v in metrics.items()}, grads

    def train_step(state, batch):
        params = state["params"]
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        batch = _on_device(batch, leaves[0].device)
        if microbatches == 1:
            metrics, grads = loss_grads(params, leaves, batch)
        else:
            b = batch["tokens"].shape[0]
            if b % microbatches:
                raise ValueError(f"batch {b} is not a multiple of "
                                 f"{microbatches} microbatches")
            mb = b // microbatches
            grads = [torch.zeros(p.shape, device=p.device) for p in leaves]
            for i in range(microbatches):
                part = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                metrics, gs = loss_grads(params, leaves, part)
                for acc, g in zip(grads, gs):
                    acc.add_(g.float() / microbatches)
                del gs
        stats = opt_mod.adamw_update(grads, state["opt"],
                                     params, state["step"], tcfg,
                                     impl=adamw_impl)
        state["step"] += 1
        return state, {**metrics, **stats}

    return train_step


def make_eval_step(lm: LM, opts: ForwardOpts = TRAIN_OPTS):
    """Returns ``eval_step(params, batch) -> metrics`` (no gradients)."""
    @torch.no_grad()
    def eval_step(params, batch):
        dev = tree_leaves(params)[0].device
        _, metrics = lm.loss(params, _on_device(batch, dev), opts)
        return metrics
    return eval_step
