"""The encdec family in the port (seamless-m4t-large-v2: the encoder over a
stub audio frontend's frame embeddings, the causal decoder with
cross-attention, LayerNorm, GELU, biases and an untied head) against the
JAX package on the CPU: the config, ``encode``, ``decoder_forward`` and
``forward`` with their collected caches, the loss and every gradient leaf,
remat none/selective/full bitwise, one AdamW train step, ``prefill`` then
16 greedy ``decode_step``s over the dense cache, decode against the
forward, and the refusals (the paged backend, pool groups, the serve
engine, chunked prefill, and the train launcher's missing ``enc_embeds``,
as JAX's launcher fails on them).

A reduced seamless (2 + 2 layers, d 128) in fp32, JAX weights from
``key(0)`` with every bias and LayerNorm leaf redrawn from a seed (JAX
initialises them to 0 and (1, 0), which would hide a dropped bias),
carried over by ``from_jax``.  Tolerances: 2e-5 for outputs and logits,
the GRAD tolerance of ``tests/test_torch_train.py`` for gradients and
parameters after a step; greedy tokens JAX's but at a top-2 gap below
1e-4 (counted, 0 asserted)."""
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

import repro.serve as jserve
import repro_torch.serve as tserve
from repro.configs import CONFIGS as JCONFIGS
from repro.configs import TrainConfig as JTrainConfig
from repro.launch import train as jlaunch_train
from repro.models import LM as JLM
from repro.models import ForwardOpts as JOpts
from repro.models import encdec as jencdec
from repro.train import init_train_state as jinit_train_state
from repro.train import make_train_step as jmake_train_step
from repro_torch.configs import CONFIGS as TCONFIGS
from repro_torch.configs import TrainConfig
from repro_torch.models import LM, ForwardOpts
from repro_torch.models import encdec as tencdec
from repro_torch.models.params import from_jax, train_state_from_jax
from repro_torch.train import make_train_step
from repro_torch.train.optimizer import tree_leaves
from test_torch_tenancy import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
NAME = "seamless-m4t-large-v2"
FWD = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)
GAP = 1e-4
TCFG = dict(learning_rate=5e-3, warmup_steps=2, total_steps=40)
JOPTS = JOpts(attn_impl="blockwise", q_chunk=16, kv_chunk=8, remat="none")
TOPTS = ForwardOpts(attn_impl="blockwise", norm_impl="plain",
                    mixer_impl="plain", q_chunk=16, kv_chunk=8,
                    remat="none")
B, S = 2, 32


def _redraw(tree, rng):
    """Every bias ~ N(0, 0.2) and LayerNorm scale ~ N(1, 0.2), in place."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _redraw(v, rng)
        elif k in ("bias", "scale"):
            tree[k] = (rng.normal(0, 0.2, v.shape)
                       + (k == "scale")).astype(np.float32)


@functools.lru_cache(maxsize=None)
def setup():
    jcfg = dataclasses.replace(JCONFIGS[NAME].reduced(), dtype="float32")
    tcfg = dataclasses.replace(TCONFIGS[NAME].reduced(), dtype="float32")
    jlm = JLM(jcfg)
    tree = jax.tree.map(np.asarray, jlm.init(jax.random.key(0)))
    _redraw(tree, np.random.default_rng(31))
    jparams = jax.tree.map(jnp.asarray, tree)
    return jcfg, jlm, jparams, tcfg, LM(tcfg), from_jax(tree, tcfg, "cpu")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _batch(seed, b=B, s=S):
    cfg = setup()[0]
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(
                np.int32),
            "enc_embeds": rng.normal(0, 1, (b, s // cfg.enc_ratio,
                                            cfg.d_model)).astype(np.float32)}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_tree_close(ours, theirs, tol):
    ours = ours if isinstance(ours, list) else tree_leaves(ours)
    flat = jax.tree_util.tree_flatten_with_path(theirs)[0]
    assert len(flat) == len(ours)
    for (path, j), t in zip(flat, ours):
        np.testing.assert_allclose(_np(t), _np(j), err_msg=str(path), **tol)


# ------------------------------------------------------------- forward ---

def test_spec_matches_jax_and_biases_are_redrawn():
    jcfg, _, jparams, tcfg, tlm, tparams = setup()
    assert jcfg.norm == "layernorm" and jcfg.use_bias
    flat = jax.tree_util.tree_flatten_with_path(jparams)[0]
    ours = tree_leaves(tparams)
    assert len(flat) == len(ours)
    for (path, j), t in zip(flat, ours):
        assert tuple(t.shape) == j.shape, path
    assert "q_norm" not in tparams["dec_layers"]["cross_attn"]
    assert tparams["dec_layers"]["ln3"]["bias"].abs().min() > 0
    assert tlm.is_encdec and set(tlm.spec()) == set(jparams)


@pytest.mark.parametrize("impl", ["flash", "dense", "blockwise"])
def test_encode_decoder_forward_and_cache_match_jax(impl):
    """``encode`` (non-causal; ``flash`` is K2's plain version on the CPU),
    then ``decoder_forward`` with its collected self- and cross-attention
    K/V, and ``forward``; JAX runs its default blockwise attention."""
    jcfg, jlm, jparams, tcfg, tlm, tparams = setup()
    batch = _batch(1)
    jopts = JOpts(remat="none")
    jenc = jencdec.encode(jparams, jcfg, jnp.asarray(batch["enc_embeds"]),
                          jopts)
    jl, jc = jencdec.decoder_forward(jparams, jcfg,
                                     jnp.asarray(batch["tokens"]), jenc,
                                     jopts, collect_cache=True)
    tb = _t(batch)
    opts = ForwardOpts(attn_impl=impl, norm_impl="plain")
    with torch.no_grad():
        tenc = tencdec.encode(tparams, tcfg, tb["enc_embeds"], opts)
        tl, tc = tencdec.decoder_forward(tparams, tcfg, tb["tokens"].long(),
                                         tenc, opts, collect_cache=True)
        fl, fc = tlm.forward(tparams, tb["tokens"].long(), opts,
                             collect_cache=True, enc_embeds=tb["enc_embeds"])
    np.testing.assert_allclose(_np(tenc), np.asarray(jenc), **FWD)
    np.testing.assert_allclose(_np(tl), np.asarray(jl), **FWD)
    assert torch.equal(fl, tl)
    for key in ("k", "v", "xk", "xv"):
        np.testing.assert_allclose(_np(tc["layers"][key]),
                                   np.asarray(jc[key]), err_msg=key, **FWD)
        assert torch.equal(fc["layers"][key], tc["layers"][key])
    with pytest.raises(ValueError, match="enc_embeds"):
        tlm.forward(tparams, tb["tokens"].long())


def test_loss_gradients_and_remat_match_jax():
    """The loss and every gradient leaf against ``jax.grad``; remat none,
    selective and full give bitwise-equal losses and gradients."""
    _, jlm, jparams, tcfg, tlm, _ = setup()
    batch = _batch(2)
    (_, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss(p, batch, JOPTS), has_aux=True))(jparams)
    params = from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu",
                      torch.float32)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    runs = {}
    for remat in ("none", "selective", "full"):
        loss, m = tlm.loss(params, _t(batch),
                           dataclasses.replace(TOPTS, remat=remat))
        runs[remat] = (loss.detach(), m, torch.autograd.grad(loss, leaves))
    loss, tm, tg = runs["none"]
    for key in ("loss", "nll", "z_loss", "moe_aux"):
        np.testing.assert_allclose(_np(tm[key]), _np(jm[key]), **FWD)
    _assert_tree_close(list(tg), jg, GRAD)
    for remat in ("selective", "full"):
        assert torch.equal(runs[remat][0], loss), remat
        assert all(torch.equal(a, b) for a, b in zip(runs[remat][2], tg)), \
            remat


def test_train_step_matches_jax():
    """One AdamW step from JAX's initial state with the redrawn weights:
    metrics, parameters and moments."""
    jcfg, jlm, jparams, tcfg, tlm, _ = setup()
    jt = JTrainConfig(**TCFG)
    state = dict(jinit_train_state(jlm, jax.random.key(0), jt),
                 params=jparams)
    tstate = train_state_from_jax(jax.tree.map(np.asarray, state), tcfg,
                                  "cpu")
    batch = _batch(3)
    state, jm = jax.jit(jmake_train_step(jlm, jt, JOPTS))(state, batch)
    tstate, tm = make_train_step(tlm, TrainConfig(**TCFG), TOPTS)(tstate,
                                                                  batch)
    for key in ("loss", "nll", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-5, err_msg=key)
    _assert_tree_close(tstate["params"], state["params"], GRAD)
    for key in ("m", "v"):
        _assert_tree_close(tstate["opt"][key], state["opt"][key], GRAD)


# -------------------------------------------------------------- decode ---

STEPS = 16


def _dense_cache(cache, steps, pad):
    """A prefill's cache grown by ``steps`` rows along S (the decode rows);
    the cross-attention K/V as they are."""
    return {"layers": {k: pad(v, steps) if k in ("k", "v") else v
                       for k, v in cache["layers"].items()}}


def _jpad(x, n):
    return jnp.pad(x, [(0, 0), (0, 0), (0, n), (0, 0), (0, 0)])


def _tpad(x, n):
    return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, n))


@functools.lru_cache(maxsize=None)
def _jax_rollout():
    jcfg, jlm, jparams, _, _, _ = setup()
    batch = _batch(4)
    jl, jc = jlm.prefill(jparams, {"tokens": batch["tokens"],
                                   "enc_embeds": batch["enc_embeds"]}, JOPTS)
    jc = _dense_cache(jc, STEPS, _jpad)
    step = jax.jit(jlm.decode_step)
    logits = [np.asarray(jl[:, -1])]
    for t in range(STEPS):
        nxt = logits[-1][:, :jcfg.vocab_size].argmax(-1).astype(np.int32)
        jl, jc = step(jparams, jnp.asarray(nxt[:, None]), jc,
                      jnp.full((B,), S + t, jnp.int32))
        logits.append(np.asarray(jl[:, -1]))
    return logits, jax.tree.map(np.asarray, jc)


def test_prefill_and_16_decode_steps_match_jax():
    """``LM.prefill`` then 16 greedy ``decode_step``s over the dense cache
    (each package fed JAX's token): logits to 2e-5 at every step, the
    port's greedy token JAX's but at a top-2 gap below 1e-4 (counted, 0
    asserted), the cache written in place and equal to JAX's at the end."""
    jcfg, _, _, _, tlm, tparams = setup()
    exp, jcache = _jax_rollout()
    batch = _t(_batch(4))
    with torch.no_grad():
        tl, cache = tlm.prefill(tparams, batch["tokens"].long(),
                                enc_embeds=batch["enc_embeds"])
        cache = _dense_cache(cache, STEPS, _tpad)
        leaves = dict(cache["layers"])
        got, ties, v = _np(tl[:, -1]), 0, jcfg.vocab_size
        for t, want in enumerate(exp):
            np.testing.assert_allclose(got, want, err_msg=f"step {t}", **FWD)
            top2 = np.sort(want[:, :v], axis=-1)[:, -2:]
            same = got[:, :v].argmax(-1) == want[:, :v].argmax(-1)
            assert (same | (top2[:, 1] - top2[:, 0] < GAP)).all(), t
            ties += int((~same).sum())
            if t == STEPS:
                break
            nxt = torch.from_numpy(want[:, :v].argmax(-1)[:, None]).long()
            tl, out = tlm.decode_step(tparams, nxt, cache,
                                      torch.full((B,), S + t,
                                                 dtype=torch.int32))
            assert out is cache
            got = _np(tl[:, -1])
    print(f"{NAME}: {ties} greedy steps of {B * (STEPS + 1)} equal only by "
          "the tie rule")
    assert ties == 0
    for key, t in cache["layers"].items():
        assert t is leaves[key]
        np.testing.assert_allclose(_np(t), jcache["layers"][key],
                                   err_msg=key, **FWD)


def test_decode_matches_forward():
    """JAX's ``test_decode_consistent_with_forward``: the prefill of S − 1
    tokens in a cache of ``LM.init_cache`` (enc_len = S / enc_ratio), one
    decode step at S − 1 against the forward's last row."""
    jcfg, _, _, _, tlm, tparams = setup()
    batch = _t(_batch(5))
    toks = batch["tokens"].long()
    with torch.no_grad():
        full, _ = tlm.forward(tparams, toks, enc_embeds=batch["enc_embeds"])
        _, pc = tlm.prefill(tparams, toks[:, :-1],
                            enc_embeds=batch["enc_embeds"])
        cache = tlm.init_cache(B, S, backend=None, device="cpu",
                               dtype=torch.float32)
        assert cache["layers"]["xk"].shape[2] == S // jcfg.enc_ratio
        for key, t in pc["layers"].items():
            cache["layers"][key][:, :, :t.shape[2]] = t
        dl, _ = tlm.decode_step(tparams, toks[:, -1:], cache,
                                torch.full((B,), S - 1, dtype=torch.int32))
    a, b = _np(full)[:, -1], _np(dl)[:, 0]
    assert np.abs(a - b).max() / np.abs(a).max() < 1e-4


# ------------------------------------------------------------ refusals ---

def test_paged_engine_and_chunked_refusals_mirror_jax():
    """The paged backend, a pool group, the serve engine and chunked
    prefill refuse encdec, each with JAX's reason."""
    _, jlm, jparams, _, tlm, tparams = setup()
    with pytest.raises(NotImplementedError) as j:
        jlm.init_cache(2, 32, backend="paged")
    with pytest.raises(ValueError) as t:
        tlm.init_cache(2, 32, backend="paged", device="cpu")
    assert str(j.value) in str(t.value)
    for kw in ({"backend": "contiguous"}, {"backend": None,
                                           "pool_group": object()}):
        with pytest.raises(ValueError, match="per-request dense state"):
            tlm.init_cache(2, 32, device="cpu", **kw)
    with pytest.raises(AssertionError, match="attention-cache families"):
        jserve.ServeEngine(jlm, jparams, 2, 32)
    with pytest.raises(ValueError, match="attention-cache families"):
        tserve.ServeEngine(tlm, tparams, 2, 32, device="cpu")
    with pytest.raises(AssertionError) as j:
        jlm.prefill_chunk(jparams, None, None, None, None, None)
    with pytest.raises(ValueError) as t:
        tlm.prefill_chunk(tparams, None, None, None, None, None)
    assert str(t.value) == str(j.value)
    cache = tlm.init_cache(2, 32, backend=None, device="cpu")
    with pytest.raises(ValueError, match="decoder-only"):
        tlm.decode_step(tparams, torch.zeros(2, 1, dtype=torch.long),
                        dict(cache, page_table=torch.zeros(2, 2)),
                        torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="decoder-only"):
        tlm.decode_step(tparams, torch.zeros(2, 1, dtype=torch.long), cache,
                        torch.zeros(2, dtype=torch.int32),
                        pool_group=object())


def test_train_launchers_fail_on_the_missing_enc_embeds(tmp_path,
                                                        monkeypatch):
    """The token loader makes no frame embeddings: JAX's launcher fails on
    the first step with ``KeyError: 'enc_embeds'``, the port's with a
    ``ValueError`` that names them."""
    args = ["--arch", NAME, "--reduced", "--steps", "1", "--batch", "2",
            "--seq", "32", "--data-dir", str(tmp_path / "data"),
            "--ckpt-dir"]
    monkeypatch.setattr(sys, "argv", ["train"] + args
                        + [str(tmp_path / "jax_ckpt")])
    with pytest.raises(KeyError, match="enc_embeds"):
        jlaunch_train.main()
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "TMPDIR": str(tmp_path)}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         *args, str(tmp_path / "ckpt")], capture_output=True, text=True,
        cwd=ROOT, env=env, timeout=300)
    assert res.returncode != 0
    assert "ValueError" in res.stderr and "enc_embeds" in res.stderr
    assert "family=encdec" in res.stdout
