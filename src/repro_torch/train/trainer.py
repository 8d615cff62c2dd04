"""Train-step factory of the port: loss -> gradients (with microbatch
accumulation) -> AdamW (counterpart of the JAX ``repro.train.trainer``).

The train state is ``{"params", "opt": {"m", "v"[, "master"]}, "step"}``:
tensors on one device, the step a host int.  The step returned by
``make_train_step`` updates the state in place and returns it, so a
full-width state is never held twice; gradients come from
``torch.autograd`` on the fp32 parameter leaves.

Called inside ``parallel.sharding.sharding_context(mesh, rules)`` on a
mesh of processes, the step trains a sharded state: every leaf is this
rank's shard by ``spec_for`` of its logical axes (``shard_train_state``),
the batch rows split over the rules' batch axes, the forward and its
gradients run sharded (``models.transformer``), and AdamW updates each
shard, clipped by the global norm.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.models import LM, ForwardOpts
from repro_torch.models.common import DTYPES, spec_leaves
from repro_torch.parallel import sharding
from repro_torch.train import optimizer as opt_mod
from repro_torch.train.optimizer import tree_leaves

# the JAX trainer's forward: blockwise jnp attention, jnp rms_norm, the
# models' chunked (xla) mixers and JAX's default remat ("selective")
TRAIN_OPTS = ForwardOpts(attn_impl="blockwise", norm_impl="plain",
                         mixer_impl="plain")


def kernels_without_backward(cfg, opts: ForwardOpts) -> list:
    """The kernels ``opts`` routes a forward of ``cfg`` through that have
    no backward: K2 (``attn_impl="flash"``, every family with attention),
    K3 (``norm_impl="kernel"``, every RMSNorm and mamba2's gated norm) and
    K6/K7 (``mixer_impl="kernel"``, hybrid and ssm).  On the card each
    refuses autograd; on the CPU their plain versions would differentiate,
    so a train step refuses them on every device."""
    found = []
    if opts.attn_impl == "flash" and cfg.family != "ssm":
        found.append('K2 flash attention (attn_impl="flash")')
    if opts.norm_impl == "kernel" and (cfg.norm == "rmsnorm"
                                       or cfg.family == "hybrid"):
        found.append('K3 RMSNorm (norm_impl="kernel")')
    if opts.mixer_impl == "kernel" and cfg.family in ("hybrid", "ssm"):
        found.append({"hybrid": 'K6 SSD scan (mixer_impl="kernel")',
                      "ssm": 'K7 WKV scan (mixer_impl="kernel")'}[
                          cfg.family])
    return found


def init_train_state(lm: LM, seed: int, tcfg: TrainConfig,
                     device="cuda") -> Dict[str, Any]:
    """Random parameters in ``cfg.param_dtype`` (fp32 masters, as JAX keeps
    them) from an explicit generator seeded with ``seed``, fresh moments,
    step 0.  ``tcfg`` is taken for the JAX signature; it sets nothing."""
    params = lm.init(seed, device=device, dtype=DTYPES[lm.cfg.param_dtype])
    return {"params": params, "opt": opt_mod.init_opt_state(params),
            "step": 0}


def abstract_train_state(lm: LM) -> Dict[str, Any]:
    """Meta tensors with the shapes and dtypes of ``init_train_state``'s
    state (the JAX ``abstract_train_state``): the step is a 0-d int32."""
    params = lm.abstract_params()

    def f32(tree):
        return opt_mod.tree_map(
            lambda p: torch.empty(p.shape, device="meta"), tree)
    opt = {"m": f32(params), "v": f32(params)}
    if any(p.dtype != torch.float32 for p in tree_leaves(params)):
        opt["master"] = f32(params)
    return {"params": params, "opt": opt,
            "step": torch.empty((), device="meta", dtype=torch.int32)}


def train_state_logical_axes(lm: LM) -> Dict[str, Any]:
    """The logical axes of every leaf of the train state (the JAX
    ``train_state_logical_axes``): the moments' and masters' are their
    parameter's; ``"master"`` is there iff a parameter is not fp32."""
    axes = lm.param_logical_axes()
    opt = {"m": axes, "v": axes}
    if any(p.dtype != torch.float32
           for p in tree_leaves(lm.abstract_params())):
        opt["master"] = axes
    return {"params": axes, "opt": opt, "step": ()}


def train_state_specs(lm: LM, mesh, rules) -> Dict[str, Any]:
    """The spec of every leaf of the train state on ``mesh``."""
    return sharding.logical_to_sharding(train_state_logical_axes(lm),
                                        abstract_train_state(lm), mesh, rules)


def shard_train_state(state, lm: LM, mesh, rules) -> Dict[str, Any]:
    """This rank's shards of a whole train state."""
    return sharding.shard_tree(state, train_state_specs(lm, mesh, rules),
                               mesh)


def unshard_train_state(state, lm: LM, mesh, rules) -> Dict[str, Any]:
    """The whole train state from every rank's shards (a collective)."""
    return sharding.unshard_tree(state, train_state_specs(lm, mesh, rules),
                                 mesh)


def _norm_groups(lm: LM, mesh, rules):
    """Per parameter leaf, the process group of the axes its spec splits it
    over (``None``: whole on every rank)."""
    key = ("norm_groups", lm.cfg,
           tuple(sorted((k, str(v)) for k, v in rules.items())))
    if key not in mesh.cache:
        groups = []
        for _, p in spec_leaves(lm.spec()):
            axes = sharding.spec_axes(
                sharding.spec_for(p.axes, p.shape, rules, mesh))
            groups.append(mesh.group(axes) if axes else None)
        mesh.cache[key] = groups
    return mesh.cache[key]


def _on_device(batch, device):
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def make_train_step(lm: LM, tcfg: TrainConfig,
                    opts: ForwardOpts = TRAIN_OPTS, microbatches: int = 1,
                    shard_grads: bool = False, adamw_impl: str = "kernel"):
    """Returns ``train_step(state, batch) -> (state, metrics)``.  ``batch``
    holds (B, S) "tokens" and "labels" (numpy arrays or tensors), for a
    vlm config "img_embeds" (B, num_image_tokens, d), and for an encdec
    config "enc_embeds" (B, S // enc_ratio, d).  The loss adds
    ``tcfg.moe_aux_loss`` times a moe config's load-balance loss.  With
    ``microbatches`` > 1 the batch is split along B and fp32 gradients are
    accumulated, each divided by ``microbatches``, as JAX's scan does.
    ``metrics`` are the last microbatch's loss metrics (as in JAX, its
    "loss" is that microbatch's) plus "grad_norm" and "lr"; values are 0-d
    tensors or floats.  ``adamw_impl`` picks K5 or its plain version.
    Every family the port runs trains; the recurrent ones through the plain
    chunked mixers, as JAX trains through ``mixer_impl="xla"``.  Opts that
    route the forward through a kernel with no backward raise
    ``ValueError`` (``kernels_without_backward``).

    Inside a sharding context on a mesh of processes the step takes the
    global batch and trains this rank's shards (see the module); every
    rank must call it with the same batch.  ``shard_grads`` is taken for
    the JAX signature: there it pins the gradients to the parameters'
    sharding, and here every gradient is already its leaf's shard."""
    del shard_grads
    refused = kernels_without_backward(lm.cfg, opts)
    if refused:
        raise ValueError(
            f"make_train_step({lm.cfg.name}): the forward would run "
            f"{', '.join(refused)}, which has no backward; train with the "
            "plain forms (TRAIN_OPTS: attn_impl='blockwise', "
            "norm_impl='plain', mixer_impl='plain')")

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
        ctx = sharding.active_mesh()
        groups = None
        if ctx is not None:
            mesh, rules = ctx
            rows = sharding.batch_rows(mesh, rules,
                                       batch["tokens"].shape[0])
            batch = {k: v[rows] for k, v in batch.items()}
            groups = _norm_groups(lm, mesh, rules)
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
                                     impl=adamw_impl, norm_groups=groups)
        state["step"] += 1
        return state, {**metrics, **stats}

    return train_step


def make_eval_step(lm: LM, opts: ForwardOpts = TRAIN_OPTS):
    """Returns ``eval_step(params, batch) -> metrics``, the loss metrics of
    ``LM.loss`` under ``torch.no_grad()`` for every family the port runs;
    with ``opts.mixer_impl="kernel"`` the recurrent mixers go through K6/K7,
    which have no backward."""
    @torch.no_grad()
    def eval_step(params, batch):
        dev = tree_leaves(params)[0].device
        _, metrics = lm.loss(params, _on_device(batch, dev), opts)
        return metrics
    return eval_step
