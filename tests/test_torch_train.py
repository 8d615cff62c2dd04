"""The port's training path against the JAX trainer on the same weights and
the same numpy inputs: blockwise attention, the cross-entropy loss, LM.loss
and every gradient leaf, the AdamW update, three train steps (microbatches
1 and 2), a JAX state carried across mid-run, the data loader, checkpoints
in both directions, the fault-tolerant loop and the launcher.

Reduced qwen3-4b, llama3.2-3b, zamba2-1.2b (hybrid), rwkv6-1.6b (ssm) and
internvl2-2b (vlm, with seeded image embeddings) in fp32; the recurrent
families train through the plain chunked mixers, as JAX trains through
its "xla" ones.  Tolerances: 2e-5 for a forward (the repo's fp32 kernel
tolerance); 1e-4 relative / 1e-6 absolute for gradients and for
parameters after AdamW steps, whose fp32 sums run in another order in
each framework and whose update divides by sqrt(v)."""
import dataclasses
import functools
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS
from repro.configs import TrainConfig as JTrainConfig
from repro.core import checkpoint as jckpt
from repro.core import job_mtbf_seconds as jjob_mtbf
from repro.core import youngs as jyoungs
from repro.data import pipeline as jdata
from repro.models import ForwardOpts as JOpts
from repro.models import LM as JLM
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.train import adamw_update as jadamw_update
from repro.train import init_train_state as jinit_train_state
from repro.train import make_train_step as jmake_train_step
from repro_torch.configs import CONFIGS as TCONFIGS
from repro_torch.configs import TrainConfig
from repro_torch.core import checkpoint as tckpt
from repro_torch.core import youngs as tyoungs
from repro_torch.core import FTTrainLoop, job_mtbf_seconds
from repro_torch.data import pipeline as tdata
from repro_torch.models import LM, ForwardOpts
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models.lm import text_len
from repro_torch.models.params import from_jax, train_state_from_jax
from repro_torch.train import (adamw_update, init_opt_state, lr_schedule,
                               make_eval_step, make_train_step)
from repro_torch.train.optimizer import tree_leaves
from test_torch_tenancy import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen3-4b", "llama3.2-3b", "zamba2-1.2b", "rwkv6-1.6b",
         "internvl2-2b"]
FWD = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)
RNG = np.random.default_rng(23)
TCFG = dict(learning_rate=5e-3, warmup_steps=2, total_steps=40)
# several chunks, so the causal chunk skip and the diagonal bias both run
JOPTS = JOpts(attn_impl="blockwise", q_chunk=16, kv_chunk=8, remat="none")
TOPTS = ForwardOpts(attn_impl="blockwise", norm_impl="plain",
                    mixer_impl="plain", q_chunk=16, kv_chunk=8)
B, S = 4, 32


@functools.lru_cache(maxsize=None)
def setup(name):
    jcfg = dataclasses.replace(JCONFIGS[name].reduced(), dtype="float32")
    tcfg = dataclasses.replace(TCONFIGS[name].reduced(), dtype="float32")
    jlm = JLM(jcfg)
    jparams = jlm.init(jax.random.key(0))
    return jcfg, jlm, jparams, tcfg, LM(tcfg)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(cfg, seed, b=B, s=S):
    """Tokens and labels, and for a vlm config seeded image embeddings in
    front of them: s positions in all, as JAX's ``make_batch`` lays out a
    sequence (``text_len``)."""
    rng = np.random.default_rng(seed)
    s = text_len(cfg, s)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                 np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                 np.int32)}
    if cfg.family == "vlm":
        batch["img_embeds"] = rng.normal(
            0, 1, (b, cfg.num_image_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_tree_close(ours, theirs, tol):
    """``ours``: a port tree or its leaves in order; ``theirs``: JAX's."""
    ours = ours if isinstance(ours, list) else tree_leaves(ours)
    flat = jax.tree_util.tree_flatten_with_path(theirs)[0]
    assert len(flat) == len(ours)
    for (path, j), t in zip(flat, ours):
        np.testing.assert_allclose(_np(t), _np(j), err_msg=str(path), **tol)


# --------------------------------------------------------------- attention ---

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("q_chunk,kv_chunk", [(32, 32), (16, 8), (8, 16)])
def test_blockwise_attention_and_its_gradient_match_jax(q_chunk, kv_chunk,
                                                        causal):
    q = RNG.normal(0, 1, (2, 32, 2, 3, 16)).astype(np.float32)
    k = RNG.normal(0, 1, (2, 32, 2, 16)).astype(np.float32)
    v = RNG.normal(0, 1, (2, 32, 2, 16)).astype(np.float32)
    w = RNG.normal(0, 1, q.shape).astype(np.float32)

    def jfn(q, k, v):
        out = jattn.blockwise_attention(q, k, v, causal, q_chunk, kv_chunk)
        return jnp.sum(out * w), out

    (_, jout), jg = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1, 2),
                                               has_aux=True))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tout = tattn.blockwise_attention(tq, tk, tv, causal, q_chunk, kv_chunk)
    tg = torch.autograd.grad((tout * torch.from_numpy(w)).sum(),
                             (tq, tk, tv))
    np.testing.assert_allclose(_np(tout), _np(jout), **FWD)
    exp = jattn.dense_attention(*map(jnp.asarray, (q, k, v)), causal)
    np.testing.assert_allclose(_np(tout), _np(exp), **FWD)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(_np(a), _np(b), **GRAD)


# -------------------------------------------------------------------- loss ---

@pytest.mark.parametrize("impl", ["kernel", "plain"])
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_and_its_gradient_match_jax(z_loss, impl):
    """Padded vocab (300 of 384 columns live), z-loss on and off."""
    x = RNG.normal(0, 3, (2, 6, 384)).astype(np.float32)
    y = RNG.integers(0, 300, (2, 6)).astype(np.int32)

    def jfn(x):
        return jcommon.cross_entropy(x, jnp.asarray(y), 300, z_loss=z_loss)

    (jloss, jaux), jg = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    tloss, taux = tcommon.cross_entropy(tx, torch.from_numpy(y), 300,
                                        z_loss=z_loss, impl=impl)
    (tg,) = torch.autograd.grad(tloss, tx)
    np.testing.assert_allclose(_np(tloss), _np(jloss), **FWD)
    for key in ("nll", "z_loss"):
        np.testing.assert_allclose(_np(taux[key]), _np(jaux[key]), **FWD)
    np.testing.assert_allclose(_np(tg), _np(jg), **GRAD)
    assert float(tg[..., 300:].abs().max()) == 0.0


@pytest.mark.parametrize("name", ARCHS)
def test_lm_loss_and_every_gradient_match_jax(name):
    jcfg, jlm, jparams, tcfg, tlm = setup(name)
    batch = _batch(jcfg, 1)
    (jloss, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss(p, batch, JOPTS), has_aux=True))(jparams)
    params = from_jax(_tree_np(jparams), tcfg, "cpu", torch.float32)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    tloss, tm = tlm.loss(params, _tbatch(batch), TOPTS)
    tg = torch.autograd.grad(tloss, leaves)
    for key in ("loss", "nll", "z_loss", "moe_aux"):
        np.testing.assert_allclose(_np(tm[key]), _np(jm[key]), **FWD)
    _assert_tree_close(list(tg), jg, GRAD)
    ev = make_eval_step(tlm, TOPTS)(params, batch)
    np.testing.assert_allclose(_np(ev["loss"]), _np(jm["loss"]), **FWD)


# --------------------------------------------------------------- optimizer ---

@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_update_matches_jax(clip):
    """A moment-laden state at step 5 (mid-warmup is past, cosine running);
    gradients 50x the parameters' scale, so clip 1.0 really clips; 1-d
    leaves take no decay, stacked (L, d) norm scales do, as in JAX."""
    jcfg, jlm, jparams, tcfg, _ = setup("qwen3-4b")
    jt = JTrainConfig(**TCFG, grad_clip=clip)
    tt = TrainConfig(**TCFG, grad_clip=clip)
    grads = jax.tree.map(lambda p: RNG.normal(0, 1, p.shape).astype(
        np.float32), _tree_np(jparams))
    m0 = jax.tree.map(lambda p: RNG.normal(0, 0.1, p.shape).astype(
        np.float32), grads)
    v0 = jax.tree.map(lambda p: RNG.uniform(0, 0.1, p.shape).astype(
        np.float32), grads)
    jopt = {"m": jax.tree.map(jnp.asarray, m0),
            "v": jax.tree.map(jnp.asarray, v0)}
    jp, jo, js = jax.jit(jadamw_update, static_argnums=4)(
        jax.tree.map(jnp.asarray, grads), jopt, jparams, jnp.int32(5), jt)
    params = from_jax(_tree_np(jparams), tcfg, "cpu", torch.float32)
    opt = {"m": from_jax(m0, tcfg, "cpu", torch.float32),
           "v": from_jax(v0, tcfg, "cpu", torch.float32)}
    ts = adamw_update(from_jax(grads, tcfg, "cpu", torch.float32), opt,
                      params, 5, tt)
    np.testing.assert_allclose(_np(ts["grad_norm"]), _np(js["grad_norm"]),
                               rtol=1e-5)
    np.testing.assert_allclose(ts["lr"], _np(js["lr"]), rtol=1e-6)
    _assert_tree_close(params, jp, GRAD)
    _assert_tree_close(opt["m"], jo["m"], GRAD)
    _assert_tree_close(opt["v"], jo["v"], GRAD)
    assert "master" not in init_opt_state(params)


@pytest.mark.parametrize("step", [0, 1, 2, 7, 39, 40, 100])
def test_lr_schedule_matches_jax(step):
    from repro.train import lr_schedule as jlr
    cfg = dict(learning_rate=3e-4, warmup_steps=4, total_steps=40)
    np.testing.assert_allclose(lr_schedule(TrainConfig(**cfg), step),
                               float(jlr(JTrainConfig(**cfg),
                                         jnp.int32(step))), rtol=1e-6)


# -------------------------------------------------------------- train step ---

@functools.lru_cache(maxsize=None)
def jax_trajectory(name, microbatches):
    """Three JAX train steps: the initial state, the state after two steps,
    the final state and the metrics of every step (numpy)."""
    jcfg, jlm, _, _, _ = setup(name)
    jt = JTrainConfig(**TCFG)
    state = jinit_train_state(jlm, jax.random.key(0), jt)
    step = jax.jit(jmake_train_step(jlm, jt, JOPTS,
                                    microbatches=microbatches))
    states, metrics = [_tree_np(state)], []
    for i in range(3):
        state, m = step(state, _batch(jcfg, 10 + i))
        states.append(_tree_np(state))
        metrics.append({k: float(v) for k, v in m.items()})
    return states, metrics


# The recurrent families' gradients agree with JAX's to ~2e-5 of each
# leaf's largest value, not elementwise: their chunked scans sum fp32 decay
# products in another order.  AdamW divides by sqrt(v), so where an
# element's gradient is small its step m/sqrt(v) carries that noise
# magnified, up to a full step of either sign where the gradient is at the
# noise level.  Their parameters after AdamW are held to GRAD but for at
# most ADAM_OUTLIERS of a leaf's elements (seen: 10 of 65,536, 1 of 1,280),
# each within two full steps (2 x the summed learning rates); the moments
# themselves, and every dense and vlm parameter, are held to GRAD.
RECURRENT = ("zamba2-1.2b", "rwkv6-1.6b")
ADAM_OUTLIERS = 1e-3


def _assert_adam_close(ours, theirs, lr_sum):
    flat = jax.tree_util.tree_flatten_with_path(theirs)[0]
    ours = tree_leaves(ours)
    assert len(flat) == len(ours)
    for (path, j), t in zip(flat, ours):
        t, j = _np(t), _np(j)
        off = ~np.isclose(t, j, **GRAD)
        assert off.mean() <= ADAM_OUTLIERS, (path, int(off.sum()))
        assert (np.abs(t - j)[off] <= 2 * lr_sum).all(), path


def _assert_state_close(ours, theirs, name=None, lr_sum=0.0):
    assert ours["step"] == int(theirs["step"])
    if name in RECURRENT:
        _assert_adam_close(ours["params"], theirs["params"], lr_sum)
    else:
        _assert_tree_close(ours["params"], theirs["params"], GRAD)
    for key in ("m", "v"):
        _assert_tree_close(ours["opt"][key], theirs["opt"][key], GRAD)


def _lr_sum(first, last):
    return sum(lr_schedule(TrainConfig(**TCFG), i) for i in range(first, last))


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("name", ARCHS)
def test_three_train_steps_match_jax(name, microbatches):
    jcfg, jlm, _, tcfg, tlm = setup(name)
    states, jmetrics = jax_trajectory(name, microbatches)
    state = train_state_from_jax(states[0], tcfg, "cpu")
    step = make_train_step(tlm, TrainConfig(**TCFG), TOPTS,
                           microbatches=microbatches)
    for i in range(3):
        state, m = step(state, _batch(jcfg, 10 + i))
        for key in ("loss", "nll", "z_loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), jmetrics[i][key],
                                       rtol=1e-5, err_msg=f"{i} {key}")
    _assert_state_close(state, states[3], name, _lr_sum(0, 3))


@pytest.mark.parametrize("name", ARCHS)
def test_jax_state_carried_across_continues_to_the_jax_result(name):
    """Two JAX steps, the state carried into the port, one port step: the
    third JAX step's state."""
    jcfg, _, _, tcfg, tlm = setup(name)
    states, _ = jax_trajectory(name, 1)
    state = train_state_from_jax(states[2], tcfg, "cpu")
    assert state["step"] == 2
    step = make_train_step(tlm, TrainConfig(**TCFG), TOPTS)
    state, _ = step(state, _batch(jcfg, 12))
    _assert_state_close(state, states[3], name, _lr_sum(2, 3))


# -------------------------------------------------------------------- data ---

@pytest.mark.parametrize("dp_rank,dp_size", [(0, 1), (1, 2)])
def test_loader_batches_are_byte_equal_to_jax(tmp_path, dp_rank, dp_size):
    toks = tdata.synthetic_corpus(50_000, 512, seed=3)
    np.testing.assert_array_equal(toks, jdata.synthetic_corpus(50_000, 512,
                                                               seed=3))
    tdata.write_token_shards(str(tmp_path), toks, shard_tokens=8192)
    ours = tdata.DeterministicLoader(
        tdata.TokenDataset(str(tmp_path)),
        tdata.LoaderConfig(8, 64, dp_rank=dp_rank, dp_size=dp_size, seed=5))
    theirs = jdata.DeterministicLoader(
        jdata.TokenDataset(str(tmp_path)),
        jdata.LoaderConfig(8, 64, dp_rank=dp_rank, dp_size=dp_size, seed=5))
    for step in (0, 1, 17):
        a, b = ours.batch_at(step), theirs.batch_at(step)
        for key in ("tokens", "labels"):
            assert a[key].dtype == b[key].dtype
            assert a[key].tobytes() == b[key].tobytes()


# ------------------------------------------------------------- checkpoints ---

def _port_state(name="qwen3-4b"):
    _, _, _, tcfg, _ = setup(name)
    states, _ = jax_trajectory(name, 1)
    return train_state_from_jax(states[1], tcfg, "cpu")


def test_checkpoint_roundtrip_and_latest(tmp_path):
    state = _port_state()
    d = str(tmp_path / "ckpt")
    tckpt.save_checkpoint(d, state, 7)
    tckpt.save_checkpoint(d, state, 14)
    assert tckpt.latest_step(d) == 14
    restored, s = tckpt.load_checkpoint(d, template=state)
    assert s == 14 and restored["step"] == state["step"] == 1
    for a, b in zip(tree_leaves(state["params"]) + tree_leaves(state["opt"]),
                    tree_leaves(restored["params"])
                    + tree_leaves(restored["opt"])):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_corruption_detected(tmp_path):
    state = _port_state()
    d = str(tmp_path / "ckpt")
    tckpt.save_checkpoint(d, state, 1)
    shard = next(Path(d, "step_00000001").glob("shard_*.npz"))
    data = bytearray(shard.read_bytes())
    data[100] ^= 0xFF
    shard.write_bytes(bytes(data))
    with pytest.raises(IOError, match="corruption"):
        tckpt.load_checkpoint(d, template=state)


def test_checkpoint_gc_keeps_last_k(tmp_path):
    state = _port_state()
    d = str(tmp_path / "ckpt")
    for s in range(1, 7):
        tckpt.save_checkpoint(d, state, s, keep_last=3)
    dirs = sorted(p.name for p in Path(d).glob("step_*"))
    assert dirs == ["step_00000004", "step_00000005", "step_00000006"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_between_jax_and_port(tmp_path, writer):
    """The same leaf paths, shapes and dtypes: a JAX checkpoint restores in
    the port, and a port checkpoint in JAX."""
    jstate = jax_trajectory("qwen3-4b", 1)[0][1]
    state = _port_state()
    d = str(tmp_path / writer)
    if writer == "jax":
        jckpt.save_checkpoint(d, jax.tree.map(jnp.asarray, jstate), 1)
        restored, step = tckpt.load_checkpoint(d, template=state)
        got, exp = restored, jstate
    else:
        tckpt.save_checkpoint(d, state, 1)
        restored, step = jckpt.load_checkpoint(d, template=jstate)
        got, exp = state, _tree_np(restored)
    assert step == 1 and got["step"] == int(exp["step"]) == 1
    _assert_tree_close(got["params"], exp["params"], dict(rtol=0, atol=0))
    _assert_tree_close(got["opt"], exp["opt"], dict(rtol=0, atol=0))


# ------------------------------------------------------------------ FT loop --

def _ft_parts():
    """The FT runs' train step, initial-state function and 12 batches."""
    jcfg, _, _, tcfg, tlm = setup("qwen3-4b")
    init_np = jax_trajectory("qwen3-4b", 1)[0][0]
    step = make_train_step(tlm, TrainConfig(**TCFG), TOPTS)
    batches = {i: _batch(jcfg, 100 + i, b=2) for i in range(12)}

    def init():
        return train_state_from_jax(init_np, tcfg, "cpu")

    return step, init, batches


@pytest.fixture(scope="module")
def clean_ft_run(tmp_path_factory):
    """The failure-free run, shared by the failure cases."""
    step, init, batches = _ft_parts()
    clean = FTTrainLoop(step, init, str(tmp_path_factory.mktemp("clean")),
                        ckpt_every=3)
    clean.run(batches.__getitem__, 12)
    return clean


@pytest.mark.parametrize("fail", [(5, 10), (1, 5, 10)])
def test_ft_loop_failure_equivalence(tmp_path, fail, clean_ft_run):
    """The loss trajectory with injected crashes equals the failure-free run
    (rel 1e-5, as the JAX reference asserts); a crash before the first
    checkpoint restarts from a freshly built initial state."""
    step, init, batches = _ft_parts()
    clean = clean_ft_run
    faulty = FTTrainLoop(step, init, str(tmp_path / "b"), ckpt_every=3)
    final = faulty.run(batches.__getitem__, 12, fail_at=lambda s: s in fail)
    assert faulty.restarts == len(fail)
    assert final["step"] == 12
    assert faulty.reg.counter("job_restarts").get() == len(fail)
    assert faulty.reg.counter("checkpoints_written").get() >= 4
    assert faulty.reg.histogram("train_step_seconds").count() > 12
    clean_by_step = {m["step"]: m["loss"] for m in clean.metrics_log}
    fault_by_step = {m["step"]: m["loss"] for m in faulty.metrics_log}
    for s in range(12):
        assert fault_by_step[s] == pytest.approx(clean_by_step[s], rel=1e-5)


def test_young_interval_and_job_mtbf_match_jax():
    assert job_mtbf_seconds(96) == pytest.approx(jjob_mtbf(96), rel=1e-12)
    for delta, steps in ((90.0, 5.0), (1.0, 0.3)):
        m = job_mtbf_seconds(96)
        assert tyoungs.young_interval(delta, m) == \
            jyoungs.young_interval(delta, m)
        assert tyoungs.checkpoint_every_n_steps(delta, m, steps) == \
            jyoungs.checkpoint_every_n_steps(delta, m, steps)
    mgr = tckpt.CheckpointManager("unused", delta_seconds=90.0,
                                  mtbf_seconds=job_mtbf_seconds(96),
                                  step_time=5.0)
    assert 1000 < mgr.every < 15000
    assert not mgr.should_save(mgr.every - 1) and mgr.should_save(mgr.every)


# ---------------------------------------------------------------- launcher ---

def _run(args, tmp_path):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "TMPDIR": str(tmp_path)}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], capture_output=True, text=True, cwd=ROOT,
                          env=env, timeout=300)


def test_launch_train_runs_on_cpu(tmp_path):
    res = _run(["--device", "cpu", "--reduced", "--steps", "3"], tmp_path)
    assert res.returncode == 0, res.stderr
    assert "arch=qwen3-4b-reduced" in res.stdout
    assert "done: 3 steps" in res.stdout and "3 checkpoints" in res.stdout
    assert (tmp_path / "repro_torch_ckpt" / "LATEST").exists()


def test_launch_train_without_a_card_fails(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    res = _run(["--reduced", "--steps", "1"], tmp_path)
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
