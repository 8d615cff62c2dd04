"""The port's remat (``ForwardOpts.remat``, ``transformer._remat``): each
layer body checkpointed as JAX's ``_remat`` does, zamba2's shared block
inside the body of the layer it fires after.

- ``"selective"`` and ``"full"`` give losses and gradients bitwise equal to
  ``"none"``'s on the CPU, for every family (recomputation replays the same
  ops on the same inputs);
- the port's ``"selective"`` train step matches JAX's ``"selective"`` step;
- saved-activation bytes order full < selective < none: the graph's saves
  counted with ``torch.autograd.graph.saved_tensors_hooks`` (parameters
  excluded), plus, under ``"selective"``, the matmul outputs its policy
  keeps (those live in the checkpoint's own cache, not in the graph);
- under ``torch.no_grad`` the layer bodies run unwrapped: no checkpoint is
  entered and the logits are bitwise the unwrapped forward's;
- opts that route a train step through a kernel with no backward raise.

Reduced configs in fp32, B=2, S=32."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS
from repro.configs import TrainConfig as JTrainConfig
from repro.models import ForwardOpts as JOpts
from repro.models import LM as JLM
from repro.train import init_train_state as jinit_train_state
from repro.train import make_train_step as jmake_train_step
from repro_torch.configs import CONFIGS as TCONFIGS
from repro_torch.configs import TrainConfig
from repro_torch.models import LM, ForwardOpts
from repro_torch.models import transformer
from repro_torch.models.lm import text_len
from repro_torch.models.params import train_state_from_jax
from repro_torch.train import TRAIN_OPTS, make_train_step
from repro_torch.train.optimizer import tree_leaves
from test_torch_tenancy import one_torch_thread  # noqa: F401

ARCHS = ["qwen3-4b", "zamba2-1.2b", "rwkv6-1.6b", "internvl2-2b"]
MODES = ["selective", "full"]
B, S = 2, 32
TCFG = dict(learning_rate=5e-3, warmup_steps=0, total_steps=40)
GRAD = dict(rtol=1e-4, atol=1e-6)


def _opts(remat):
    return dataclasses.replace(TRAIN_OPTS, q_chunk=16, kv_chunk=8,
                               remat=remat)


@functools.lru_cache(maxsize=None)
def setup(name):
    cfg = dataclasses.replace(TCONFIGS[name].reduced(), dtype="float32")
    lm = LM(cfg)
    params = lm.init(3, device="cpu", dtype=torch.float32)
    return cfg, lm, params


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    s = text_len(cfg, S)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, s)).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, s)).astype(
                 np.int32)}
    if cfg.family == "vlm":
        batch["img_embeds"] = rng.normal(
            0, 1, (B, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _loss_and_grads(name, remat, hooks=None):
    """Loss and every gradient leaf under ``remat``; with ``hooks`` (pack,
    unpack) the forward runs under them."""
    cfg, lm, params = setup(name)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    ctx = (torch.autograd.graph.saved_tensors_hooks(*hooks) if hooks
           else torch.enable_grad())
    with ctx:
        loss, _ = lm.loss(params, _tbatch(_batch(cfg, 1)), _opts(remat))
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return loss, grads


@functools.lru_cache(maxsize=None)
def _none_run(name):
    return _loss_and_grads(name, "none")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ARCHS)
def test_remat_loss_and_gradients_bitwise_equal_none(name, mode):
    loss, grads = _loss_and_grads(name, mode)
    ref_loss, ref_grads = _none_run(name)
    assert torch.equal(loss, ref_loss)
    assert len(grads) == len(ref_grads)
    for g, r in zip(grads, ref_grads):
        assert torch.equal(g, r)


def _saved_bytes(name, remat, monkeypatch):
    """Activation bytes the forward leaves for the backward: tensors packed
    by the graph (not parameters) plus, under ``"selective"``, the outputs
    its policy keeps."""
    _, _, params = setup(name)
    param_storages = {t.untyped_storage().data_ptr()
                      for t in tree_leaves(params)}
    total = [0]

    def pack(t):
        if t.untyped_storage().data_ptr() not in param_storages:
            total[0] += t.numel() * t.element_size()
        return t

    policy = transformer._selective_policy

    def counting_policy(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if (decision == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
                and not ctx.is_recompute):
            a, b = args[-2], args[-1]            # mm(a, b) / addmm(c, a, b)
            total[0] += a.shape[0] * b.shape[1] * a.element_size()
        return decision

    monkeypatch.setattr(transformer, "_selective_policy", counting_policy)
    _loss_and_grads(name, remat, hooks=(pack, lambda t: t))
    return total[0]


@pytest.mark.parametrize("name", ARCHS)
def test_saved_activation_bytes_order_full_selective_none(name, monkeypatch):
    got = {m: _saved_bytes(name, m, monkeypatch)
           for m in ("full", "selective", "none")}
    assert got["full"] < got["selective"] < got["none"], got


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["zamba2-1.2b", "internvl2-2b"])
def test_no_grad_forward_runs_unwrapped(name, mode, monkeypatch):
    """Eval, prefill and decode record nothing: no checkpoint is entered,
    and the logits (and a prefill's cache) are the unwrapped forward's,
    bitwise."""
    cfg, lm, params = setup(name)
    batch = _tbatch(_batch(cfg, 2))
    img = batch.get("img_embeds")
    with torch.no_grad():
        ref, ref_cache = lm.forward(params, batch["tokens"], _opts("none"),
                                    collect_cache=True, img_embeds=img)

    def refuse(*args, **kwargs):
        raise AssertionError("a checkpoint was entered without autograd")

    monkeypatch.setattr(transformer, "checkpoint", refuse)
    with torch.no_grad():
        got, cache = lm.forward(params, batch["tokens"], _opts(mode),
                                collect_cache=True, img_embeds=img)
    assert torch.equal(got, ref)
    for a, b in zip(tree_leaves(cache), tree_leaves(ref_cache)):
        assert torch.equal(a, b)
    # parameters that do not require grad record nothing either (serving)
    got, _ = lm.forward(params, batch["tokens"], _opts(mode),
                        img_embeds=img)
    assert torch.equal(got, ref)


@pytest.mark.parametrize("name", ["zamba2-1.2b", "internvl2-2b"])
def test_selective_train_step_matches_jax_selective(name):
    """One AdamW step (no warmup) from JAX's initial state under both
    packages' ``"selective"`` remat: loss, grad_norm, moments and
    parameters."""
    jcfg = dataclasses.replace(JCONFIGS[name].reduced(), dtype="float32")
    jlm = JLM(jcfg)
    jt = JTrainConfig(**TCFG)
    state = jinit_train_state(jlm, jax.random.key(0), jt)
    cfg, lm, _ = setup(name)
    ours = train_state_from_jax(jax.tree.map(np.asarray, state), cfg, "cpu")
    batch = _batch(cfg, 5)
    jopts = JOpts(attn_impl="blockwise", q_chunk=16, kv_chunk=8,
                  remat="selective")
    new, jm = jax.jit(jmake_train_step(jlm, jt, jopts))(state, batch)
    ours, m = make_train_step(lm, TrainConfig(**TCFG),
                              _opts("selective"))(ours, batch)
    for key in ("loss", "nll", "z_loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5,
                                   err_msg=key)
    new = jax.tree.map(np.asarray, new)
    for tree, jtree in ((ours["params"], new["params"]),
                        (ours["opt"]["m"], new["opt"]["m"]),
                        (ours["opt"]["v"], new["opt"]["v"])):
        flat = jax.tree_util.tree_flatten_with_path(jtree)[0]
        for (path, j), t in zip(flat, tree_leaves(tree)):
            np.testing.assert_allclose(t.detach().numpy(), j,
                                       err_msg=str(path),
                                       **GRAD)


REFUSED = [("qwen3-4b", dict(attn_impl="flash"), "K2"),
           ("qwen3-4b", dict(norm_impl="kernel"), "K3"),
           ("internvl2-2b", dict(attn_impl="flash"), "K2"),
           ("internvl2-2b", dict(norm_impl="kernel"), "K3"),
           ("zamba2-1.2b", dict(attn_impl="flash"), "K2"),
           ("zamba2-1.2b", dict(norm_impl="kernel"), "K3"),
           ("zamba2-1.2b", dict(mixer_impl="kernel"), "K6"),
           ("rwkv6-1.6b", dict(mixer_impl="kernel"), "K7")]


@pytest.mark.parametrize("name,change,kernel", REFUSED)
def test_kernel_routed_train_opts_raise(name, change, kernel):
    _, lm, _ = setup(name)
    opts = dataclasses.replace(TRAIN_OPTS, **change)
    with pytest.raises(ValueError, match=kernel):
        make_train_step(lm, TrainConfig(), opts)


def test_opts_that_reach_no_kernel_still_train():
    """A dense stack has no mixer and rwkv6 no attention: those opts route
    nothing through a kernel; nor does ``norm_impl="kernel"`` where every
    norm is a LayerNorm (rwkv6-1.6b, starcoder2-3b)."""
    make_train_step(setup("qwen3-4b")[1], TrainConfig(),
                    dataclasses.replace(TRAIN_OPTS, mixer_impl="kernel"))
    make_train_step(setup("rwkv6-1.6b")[1], TrainConfig(),
                    dataclasses.replace(TRAIN_OPTS, attn_impl="flash",
                                        norm_impl="kernel"))
    make_train_step(LM(TCONFIGS["starcoder2-3b"].reduced()), TrainConfig(),
                    dataclasses.replace(TRAIN_OPTS, norm_impl="kernel"))


def test_remat_policies_and_default_are_jax_s():
    assert ForwardOpts().remat == JOpts().remat == "selective"
    assert TRAIN_OPTS.remat == "selective"
    with pytest.raises(ValueError, match="remat"):
        ForwardOpts(remat="offload")
