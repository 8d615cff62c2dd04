"""Recurrent prefill states and decode of the port (zamba2, hybrid; rwkv6,
ssm) against the JAX package, on the same weights (``from_jax`` on JAX's
``key(0)`` tree with its norm, bias, token-shift and skip leaves redrawn
from a seeded numpy generator: JAX initializes the shift mixes at zero,
which would hide the channel mix's shift state) and the same numpy inputs:

* the chunked scans from an initial state with their final states, and
  one decode step of each block;
* ``LM.prefill``: the last row's logits and every state leaf (zamba2's
  shared-block K/V too);
* 16-token greedy rollouts through ``decode_step`` from ``LM.prefill``
  (states updated in place), the greedy token JAX's except at a top-2 gap
  below 1e-4 (counted, 0 asserted), and bf16 decode steps against JAX's
  bf16 decode (the decode's rounding points differ from the forward's in
  JAX too);
* JAX's decode-vs-forward check (``tests/test_models.py``) on the port.

Reduced configs; fp32 to 2e-5, bf16 to 2e-2."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS
from repro.models import ForwardOpts as JOpts
from repro.models import LM as JLM
from repro.models import mamba2 as jmamba
from repro.models import rwkv6 as jrwkv
from repro_torch.configs import CONFIGS as TCONFIGS
from repro_torch.models import LM, ForwardOpts
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models.params import from_jax
from repro_torch.models.transformer import layer_params
from test_torch_tenancy import one_torch_thread  # noqa: F401

NAMES = ["zamba2-1.2b", "rwkv6-1.6b"]
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
GAP = 1e-4            # a greedy tie: both tokens are right
JOPTS = JOpts(attn_impl="dense", remat="none")
PATHS = {"kernel": ForwardOpts(),
         "plain": ForwardOpts(attn_impl="dense", norm_impl="plain",
                              mixer_impl="plain")}
B, S, STEPS = 2, 20, 16   # S: a ragged tail for both scans' chunks


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _redraw(tree, seed: int):
    """Norm scales and biases, the shift mixes (``mu*``) and mamba2's skip
    ``D`` drawn from a seeded numpy generator (numpy tree in and out)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        key = path[-1].key
        if key == "bias":
            return rng.normal(0.0, 0.2, a.shape).astype(a.dtype)
        if key in ("scale", "D"):
            return rng.normal(1.0, 0.2, a.shape).astype(a.dtype)
        if key.startswith("mu"):
            return rng.uniform(0.0, 1.0, a.shape).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(leaf, tree)


@functools.lru_cache(maxsize=None)
def setup(name, dtype="float32"):
    jcfg = dataclasses.replace(JCONFIGS[name].reduced(), dtype=dtype)
    tcfg = dataclasses.replace(TCONFIGS[name].reduced(), dtype=dtype)
    jlm = JLM(jcfg)
    tree = _redraw(jax.tree.map(np.asarray, jlm.init(jax.random.key(0))),
                   seed=NAMES.index(name))
    return (jcfg, jlm, jax.tree.map(jnp.asarray, tree), tcfg, LM(tcfg),
            from_jax(tree, tcfg, device="cpu"))


def _tokens(cfg, seed, s=S):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, s)).astype(np.int32)


def _leaves(cache):
    """(path, array) for every state leaf, ``page_table`` aside."""
    return [(f"{top}/{k}", v) for top in ("layers", "shared")
            for k, v in sorted(cache.get(top, {}).items())]


def _assert_caches_close(tc, jc, tol):
    ours, theirs = _leaves(tc), _leaves(jc)
    assert [p for p, _ in ours] == [p for p, _ in theirs]
    for (path, t), (_, j) in zip(ours, theirs):
        assert tuple(t.shape) == tuple(j.shape), path
        np.testing.assert_allclose(_np(t), _np(j), err_msg=path, **tol)


# ---------------------------------------------------------- the blocks ----

@pytest.mark.parametrize("s", [16, 21])
def test_chunked_scans_from_a_state_match_jax(s):
    """``ssd_chunked`` and ``wkv6_chunked`` from a random initial state,
    ragged S included: outputs and final states."""
    rng = np.random.default_rng(s)
    b, h, p, n = 2, 3, 8, 4
    x = rng.normal(0, 1, (b, s, h, p)).astype(np.float32)
    da = -rng.uniform(0, 0.5, (b, s, h)).astype(np.float32)
    bm, cm = (rng.normal(0, 1, (b, s, n)).astype(np.float32) for _ in "bc")
    h0 = rng.normal(0, 1, (b, h, p, n)).astype(np.float32)
    jy, jh = jmamba.ssd_chunked(*map(jnp.asarray, (x, da, bm, cm)), 8,
                                initial_state=jnp.asarray(h0),
                                return_final=True)
    ty, th = tmamba.ssd_chunked(*map(torch.from_numpy, (x, da, bm, cm)), 8,
                                initial_state=torch.from_numpy(h0),
                                return_final=True)
    for a, e in ((ty, jy), (th, jh)):
        np.testing.assert_allclose(_np(a), _np(e), **TOL["float32"])
    k = 8
    r, kk, v = (rng.normal(0, 1, (b, s, h, k)).astype(np.float32)
                for _ in "rkv")
    lw = np.maximum(-np.exp(rng.normal(-1, 1, (b, s, h, k))),
                    trwkv.LOG_DECAY_FLOOR).astype(np.float32)
    u = rng.normal(0, 0.3, (h, k)).astype(np.float32)
    s0 = rng.normal(0, 1, (b, h, k, k)).astype(np.float32)
    jy, js = jrwkv.wkv6_chunked(*map(jnp.asarray, (r, kk, v, lw, u)), 8,
                                initial_state=jnp.asarray(s0),
                                return_final=True)
    ty, ts = trwkv.wkv6_chunked(*map(torch.from_numpy, (r, kk, v, lw, u)), 8,
                                initial_state=torch.from_numpy(s0),
                                return_final=True)
    for a, e in ((ty, jy), (ts, js)):
        np.testing.assert_allclose(_np(a), _np(e), **TOL["float32"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", NAMES)
def test_block_decode_steps_match_jax(name, dtype):
    """Three chained single-token steps of layer 0's blocks from random
    states: outputs and new states (mamba2: conv and SSM; rwkv6: the time
    mix's shift and WKV, the channel mix's shift)."""
    jcfg, _, jparams, tcfg, _, tparams = setup(name)
    jt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    rng = np.random.default_rng(6)
    jp = jax.tree.map(lambda a: a[0], jparams["layers"])
    tp = layer_params(tparams, 0)
    d = jcfg.d_model
    if name == "zamba2-1.2b":
        w, c = jcfg.ssm_conv_dim, jcfg.d_inner + 2 * jcfg.ssm_state
        st = [rng.normal(0, 1, (B, w - 1, c)).astype(np.float32),
              rng.normal(0, 1, (B, jcfg.ssm_heads, jcfg.ssm_head_dim,
                                jcfg.ssm_state)).astype(np.float32)]
    else:
        st = [rng.normal(0, 1, (B, 1, d)).astype(np.float32),
              rng.normal(0, 1, (B, jcfg.rwkv_heads, jcfg.rwkv_head_dim,
                                jcfg.rwkv_head_dim)).astype(np.float32),
              rng.normal(0, 1, (B, 1, d)).astype(np.float32)]
    jst = [jnp.asarray(a).astype(jt if i != 1 else jnp.float32)
           for i, a in enumerate(st)]
    tst = [torch.from_numpy(a).to(tt if i != 1 else torch.float32)
           for i, a in enumerate(st)]
    for _ in range(3):
        x = rng.normal(0, 1, (B, 1, d)).astype(np.float32)
        jx, tx = jnp.asarray(x).astype(jt), torch.from_numpy(x).to(tt)
        if name == "zamba2-1.2b":
            jy, jst = jmamba.mamba_block(jp["mamba"], jcfg, jx,
                                         conv_state=jst[0], ssm_state=jst[1],
                                         decode=True)
            ty, (conv, ssm) = tmamba.mamba_block(
                tp["mamba"], tcfg, tx, conv_state=tst[0], ssm_state=tst[1],
                decode=True)
            tst = [torch.cat(conv, dim=-1), ssm]
        else:
            jy, (s1, wkv) = jrwkv.tmix_block(jp["tmix"], jcfg, jx,
                                             shift_state=jst[0],
                                             wkv_state=jst[1], decode=True)
            jy2, s2 = jrwkv.cmix_block(jp["cmix"], jcfg, jx,
                                       shift_state=jst[2])
            jy, jst = jy + jy2, [s1, wkv, s2]
            ty, (s1, wkv) = trwkv.tmix_block(tp["tmix"], tcfg, tx,
                                             shift_state=tst[0],
                                             wkv_state=tst[1], decode=True)
            ty2, s2 = trwkv.cmix_block(tp["cmix"], tcfg, tx,
                                       shift_state=tst[2])
            ty, tst = ty + ty2, [s1, wkv, s2]
        assert ty.dtype == tt and tst[1].dtype == torch.float32
        np.testing.assert_allclose(_np(ty), _np(jy), **TOL[dtype])
        for a, e in zip(tst, jst):
            np.testing.assert_allclose(_np(a), _np(e), **TOL[dtype])


# ----------------------------------------------------------- LM.prefill ----

@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("name", NAMES)
def test_prefill_caches_match_jax(name, path):
    """``LM.prefill`` on the kernel path (a collected cache takes the plain
    chunked mixers, as JAX's takes "xla") and on the plain path: the last
    row's logits and every state leaf, fp32 states in fp32."""
    jcfg, jlm, jparams, tcfg, tlm, tparams = setup(name)
    toks = _tokens(jcfg, 7)
    jl, jc = jlm.prefill(jparams, {"tokens": jnp.asarray(toks)}, JOPTS)
    tl, tc = tlm.prefill(tparams, torch.from_numpy(toks).long(), PATHS[path])
    assert tuple(tl.shape) == (B, 1, tcfg.padded_vocab)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL["float32"])
    _assert_caches_close(tc, jc, TOL["float32"])
    state = "ssm" if name == "zamba2-1.2b" else "wkv"
    assert tc["layers"][state].dtype == torch.float32
    assert ("shared" in tc) == (name == "zamba2-1.2b")


def _grow(cache, extra: int, pad):
    """The shared K/V rows grown by ``extra`` zero rows along S."""
    if "shared" in cache:
        cache["shared"] = {k: pad(v, extra)
                           for k, v in cache["shared"].items()}
    return cache


def _jpad(x, extra):
    return jnp.pad(x, [(0, 0), (0, 0), (0, extra), (0, 0), (0, 0)])


def _tpad(x, extra):
    return torch.nn.functional.pad(x, (0, 0, 0, 0, 0, extra))


@functools.lru_cache(maxsize=None)
def _jax_rollout(name, dtype="float32", steps=STEPS):
    """JAX's logits at the prefill and each of ``steps`` greedy decode
    steps (each from JAX's own token), and its final cache."""
    jcfg, jlm, jparams, *_ = setup(name, dtype)
    toks = _tokens(jcfg, 8)
    jl, jc = jlm.prefill(jparams, {"tokens": jnp.asarray(toks)}, JOPTS)
    jc = _grow(jc, steps, _jpad)
    step = jax.jit(jlm.decode_step)
    logits = [np.asarray(jl[:, -1].astype(jnp.float32))]
    for t in range(steps):
        nxt = logits[-1][:, :jcfg.vocab_size].argmax(-1).astype(np.int32)
        jl, jc = step(jparams, jnp.asarray(nxt[:, None]), jc,
                      jnp.full((B,), S + t, jnp.int32))
        logits.append(np.asarray(jl[:, -1].astype(jnp.float32)))
    return logits, jax.tree.map(np.asarray, jc)


@pytest.mark.parametrize("name", NAMES)
def test_greedy_rollouts_match_jax(name):
    """``LM.prefill`` then 16 greedy ``decode_step``s (each package fed
    JAX's token): logits to 2e-5 at every step, the port's greedy token
    JAX's except at a top-2 gap below 1e-4 (counted; 0 asserted), states
    updated in place and equal to JAX's at the end."""
    jcfg, _, _, tcfg, tlm, tparams = setup(name)
    exp, jcache = _jax_rollout(name)
    toks = _tokens(jcfg, 8)
    tl, cache = tlm.prefill(tparams, torch.from_numpy(toks).long())
    cache = _grow(cache, STEPS, _tpad)
    leaves = [t for _, t in _leaves(cache)]
    ties, got = 0, _np(tl[:, -1])
    for t, want in enumerate(exp):
        np.testing.assert_allclose(got, want, err_msg=f"step {t}",
                                   **TOL["float32"])
        v = jcfg.vocab_size
        top2 = np.sort(want[:, :v], axis=-1)[:, -2:]
        same = got[:, :v].argmax(-1) == want[:, :v].argmax(-1)
        assert (same | (top2[:, 1] - top2[:, 0] < GAP)).all(), t
        ties += int((~same).sum())
        if t == STEPS:
            break
        nxt = want[:, :v].argmax(-1)[:, None]
        tl, out = tlm.decode_step(tparams, torch.from_numpy(nxt).long(),
                                  cache, torch.full((B,), S + t,
                                                    dtype=torch.int32))
        assert out is cache
        got = _np(tl[:, -1])
    print(f"{name}: {ties} greedy steps of {B * (STEPS + 1)} equal only by "
          "the tie rule")
    assert ties == 0
    assert all(a is b for a, b in zip(leaves, [t for _, t in
                                               _leaves(cache)]))
    _assert_caches_close(cache, jcache, TOL["float32"])


@pytest.mark.parametrize("name", NAMES)
def test_bf16_decode_steps_match_jax_decode(name):
    """bf16 weights and compute: the prefill and 4 greedy decode steps
    against JAX's bf16 prefill and decode on the same tree (the decode's
    rounding points are JAX's decode's, not the forward's): logits to 2e-2,
    the final states to 2e-2 of each leaf's largest value."""
    jcfg, _, _, tcfg, tlm, tparams = setup(name, "bfloat16")
    exp, jcache = _jax_rollout(name, "bfloat16", steps=4)
    tl, cache = tlm.prefill(tparams, torch.from_numpy(_tokens(jcfg, 8))
                            .long())
    assert tl.dtype == torch.bfloat16
    cache = _grow(cache, 4, _tpad)
    for t, want in enumerate(exp):
        np.testing.assert_allclose(_np(tl[:, -1]), want,
                                   err_msg=f"step {t}", **TOL["bfloat16"])
        if t == 4:
            break
        nxt = want[:, :jcfg.vocab_size].argmax(-1)[:, None]
        tl, cache = tlm.decode_step(tparams, torch.from_numpy(nxt).long(),
                                    cache, torch.full((B,), S + t,
                                                      dtype=torch.int32))
    # four bf16 steps apart, a state element is held at its leaf's scale:
    # a normed shift row may differ by a few bf16 units where it is small
    for (path, a), (_, e) in zip(_leaves(cache), _leaves(jcache)):
        np.testing.assert_allclose(
            _np(a), _np(e), rtol=2e-2, atol=2e-2 * float(np.abs(_np(e)).max()),
            err_msg=path)


@pytest.mark.parametrize("name", NAMES)
def test_decode_consistent_with_forward(name):
    """JAX's ``test_decode_consistent_with_forward`` on the port: prefill
    all but the last token (shared K/V padded by one row), decode it, and
    the logits match the full forward's last row to 1e-4 relative."""
    jcfg, _, _, tcfg, tlm, tparams = setup(name)
    toks = torch.from_numpy(_tokens(tcfg, 9, s=32)).long()
    full, _ = tlm.forward(tparams, toks, PATHS["kernel"])
    _, cache = tlm.prefill(tparams, toks[:, :-1], PATHS["kernel"])
    cache = _grow(cache, 1, _tpad)
    dl, new = tlm.decode_step(tparams, toks[:, -1:], cache,
                              torch.full((B,), 31, dtype=torch.int32))
    a, b = _np(full[:, -1]), _np(dl[:, 0])
    err = np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-9)
    assert err < 1e-4, f"{name}: decode/forward mismatch {err:.2e}"
    assert [p for p, _ in _leaves(new)] == [p for p, _ in _leaves(cache)]
