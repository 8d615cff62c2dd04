"""The moe family in the port (moonshot-v1-16b-a3b: 64 experts top-6;
arctic-480b: 128 experts top-2 beside a dense residual FFN) against the JAX
package on the CPU.

- ``route`` and ``moe_ffn`` on the same numpy inputs and weights: a size
  where the 1.25 capacity factor drops tokens; router columns built to tie
  exactly; NaN rows (ids, keep, the dispatch buffer and the outputs, a
  dropped NaN row's spread into slot cap − 1 included); arctic's dense
  residual; ``moe_ffn_decode``; the aux loss.  ``torch.topk`` in place of
  the stable sort (monkeypatched) must fail the tie and NaN cases.  JAX's
  buffer is read where its ``moe_ffn`` hands it to ``constrain``; ``keep``
  is held to a plain loop over the slot-major order.
- The gradients of ``moe_ffn`` with respect to x, the router and the
  experts against ``jax.grad``.
- ``LM.forward``, ``LM.loss`` (``moe_aux`` included) and one AdamW train
  step against JAX's, for both configs; remat none/selective/full give
  bitwise-equal losses and gradients.
- Decode against the forward with ``capacity_factor=8.0`` (JAX's
  ``tests/test_models.py`` check).
- ``ServeEngine`` in lockstep with JAX's engine for moonshot reduced over
  native pages, int8 pages and the contiguous cache; feeding the parked
  slots or padding the prompt buckets with another token changes a live
  stream; a tenancy run with a preemption; a fault plan with every outcome
  equal to JAX's (``decode_impl="gather"``); two gloo ranks against one;
  ``--prefill-chunk`` refused with JAX's message.

Reduced configs (2 layers, 8 experts, top-2) in fp32, JAX weights from
``key(0)`` carried over by ``from_jax``.  Tolerances: 2e-5 for outputs and
logits, the GRAD tolerance of ``tests/test_torch_train.py`` for gradients
and parameters after a step; greedy streams equal."""
import dataclasses
import functools
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as jserve
import repro_torch.serve as tserve
from repro.configs import CONFIGS as JCONFIGS
from repro.configs import TrainConfig as JTrainConfig
from repro.models import LM as JLM
from repro.models import ForwardOpts as JOpts
from repro.models import moe as jmoe
from repro.train import init_train_state as jinit_train_state
from repro.train import make_train_step as jmake_train_step
from repro_torch.configs import CONFIGS as TCONFIGS
from repro_torch.configs import TrainConfig
from repro_torch.models import LM, ForwardOpts
from repro_torch.models import moe as tmoe
from repro_torch.models.params import from_jax, train_state_from_jax
from repro_torch.train import make_train_step
from repro_torch.train.optimizer import tree_leaves
from test_torch_sharded import ROOT, _env, _free_port, _streams
from test_torch_tenancy import one_torch_thread  # noqa: F401

NAMES = ["moonshot-v1-16b-a3b", "arctic-480b"]
MOONSHOT = NAMES[0]
FWD = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=1e-4, atol=1e-6)
TCFG = dict(learning_rate=5e-3, warmup_steps=2, total_steps=40)
JOPTS = JOpts(attn_impl="blockwise", q_chunk=16, kv_chunk=8, remat="none")
TOPTS = ForwardOpts(attn_impl="blockwise", norm_impl="plain",
                    mixer_impl="plain", q_chunk=16, kv_chunk=8,
                    remat="none")


@functools.lru_cache(maxsize=None)
def setup(name, **changes):
    jcfg = dataclasses.replace(JCONFIGS[name].reduced(), dtype="float32",
                               **changes)
    tcfg = dataclasses.replace(TCONFIGS[name].reduced(), dtype="float32",
                               **changes)
    jlm = JLM(jcfg)
    jparams = jlm.init(jax.random.key(0))
    tparams = from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, jlm, jparams, tcfg, LM(tcfg), tparams


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _layer0(tree):
    return jax.tree.map(lambda a: np.asarray(a)[0], tree)


def moe_params(name, seed=None):
    """Layer 0's moe subtree, JAX's (numpy) and the port's; with ``seed``
    the router is redrawn ~ N(0, 1) so routing is decided by clear
    margins (JAX's init scale leaves every prob near 1/E)."""
    jcfg, _, jparams, tcfg, _, tparams = setup(name)
    jp = _layer0(jax.tree.map(np.asarray, jparams["layers"]["moe"]))
    if seed is not None:
        rng = np.random.default_rng(seed)
        jp["router"]["kernel"] = rng.normal(
            0, 1, jp["router"]["kernel"].shape).astype(np.float32)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jcfg, tcfg, jp, tp


# ------------------------------------------------------------ moe_ffn ---

def jax_moe(jp, jcfg, x, groups=0):
    """JAX's ``moe_ffn``, eagerly, with the arrays it hands ``constrain``
    recorded: [xg, the (G, E, cap, d) dispatch buffer, h, out]."""
    seen = []
    orig = jmoe.constrain

    def record(a, axes):
        seen.append(np.asarray(a))
        return orig(a, axes)
    jmoe.constrain = record
    try:
        y, aux = jmoe.moe_ffn(jax.tree.map(jnp.asarray, jp), jcfg,
                              jnp.asarray(x), groups=groups)
    finally:
        jmoe.constrain = orig
    return np.asarray(y), float(aux), seen[1]


def port_moe(tp, tcfg, x, groups=0):
    """The port's ``moe_ffn`` and its pieces: y, aux, ids, keep, buffer."""
    xt = torch.from_numpy(x)
    b, s, d = xt.shape
    g = groups or b
    xg = xt.reshape(g, b * s // g, d)
    cap = tmoe._capacity(xg.shape[1], tcfg)
    gates, ids, _ = tmoe.route(tp["router"], tcfg, xg)
    flat, keep = tmoe.capacity_slots(ids, gates, cap, tcfg.num_experts)
    buf = tmoe.dispatch(xg, flat, keep, tcfg.num_experts * cap)
    y, aux = tmoe.moe_ffn(tp, tcfg, xt, groups)
    return dict(y=_np(y), aux=float(aux), ids=ids.numpy(),
                keep=keep.numpy(), buf=_np(buf).reshape(
                    g, tcfg.num_experts, cap, d), cap=cap)


def plain_keep(ids, gates, cap, e):
    """The capacity rule as a loop: slot-major (every token's j-th choice
    before any (j+1)-th), a running count per expert, kept while under
    ``cap`` and the gate positive."""
    g, s, k = ids.shape
    keep = np.zeros(ids.shape, np.float32)
    for gi in range(g):
        count = np.zeros(e, np.int64)
        for j in range(k):
            for t in range(s):
                ex = ids[gi, t, j]
                keep[gi, t, j] = float(count[ex] < cap
                                       and gates[gi, t, j] > 0)
                count[ex] += 1
    return keep


def check_against_jax(name, x, groups=0, seed=None, params=None):
    """Route, keep, buffer, outputs and aux of the port equal JAX's;
    returns the port's pieces."""
    jcfg, tcfg, jp, tp = params or moe_params(name, seed)
    jy, jaux, jbuf = jax_moe(jp, jcfg, x, groups)
    got = port_moe(tp, tcfg, x, groups)
    g = groups or x.shape[0]
    jg, jids, _ = jmoe.route(jax.tree.map(jnp.asarray, jp["router"]), jcfg,
                             jnp.asarray(x.reshape(g, -1, x.shape[-1])))
    np.testing.assert_array_equal(got["ids"], np.asarray(jids))
    np.testing.assert_array_equal(
        got["keep"], plain_keep(np.asarray(jids), np.asarray(jg), got["cap"],
                                jcfg.num_experts))
    np.testing.assert_allclose(got["buf"], jbuf, **FWD)
    np.testing.assert_allclose(got["y"], jy, **FWD)
    np.testing.assert_allclose(got["aux"], jaux, **FWD)
    return got


def _unit(v):
    return v / np.linalg.norm(v)


def _x(seed, shape, scale=1.0):
    return np.random.default_rng(seed).normal(0, scale, shape).astype(
        np.float32)


@pytest.mark.parametrize("name", NAMES)
def test_moe_ffn_drops_tokens_like_jax(name):
    """Two sequences of 40 tokens, top-2 of 8 experts: capacity 13; the
    redrawn router overloads some experts, so some slots are dropped;
    arctic adds its dense residual."""
    got = check_against_jax(name, _x(1, (2, 40, 128)), seed=3)
    assert 0 < (got["keep"] == 0).sum() < got["keep"].size


def test_moe_ffn_decode_matches_jax():
    """``moe_ffn_decode``: one group over a batch of single tokens, capacity
    3, with five tokens leaning to expert 0, so some are dropped."""
    jcfg, tcfg, jp, tp = moe_params(MOONSHOT, seed=4)
    x = _x(2, (8, 1, 128))
    x[:5, 0] += 4.0 * _unit(jp["router"]["kernel"][:, 0])
    jy, _ = jmoe.moe_ffn_decode(jax.tree.map(jnp.asarray, jp), jcfg,
                                jnp.asarray(x))
    ty, _ = tmoe.moe_ffn_decode(tp, tcfg, torch.from_numpy(x))
    np.testing.assert_allclose(_np(ty), np.asarray(jy), **FWD)
    got = check_against_jax(MOONSHOT, x, groups=1, seed=4)
    assert (got["keep"] == 0).any()


def _tied_params(name):
    """Router columns 1, 3 and 6 equal, and column 5 equal to column 2,
    so every row's probs tie exactly between those experts."""
    jcfg, tcfg, jp, _ = moe_params(name, seed=5)
    w = jp["router"]["kernel"]
    w[:, 3] = w[:, 1]
    w[:, 6] = w[:, 1]
    w[:, 5] = w[:, 2]
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), jp)
    return jcfg, tcfg, jp, tp


def _with_topk():
    """The port's ``top_k`` replaced by ``torch.topk``."""
    def topk(probs, k):
        return torch.topk(probs, k, dim=-1)
    return topk


def test_tied_router_columns_route_like_jax(monkeypatch):
    params = _tied_params(MOONSHOT)
    x = _x(6, (2, 24, 128))
    got = check_against_jax(MOONSHOT, x, params=params)
    # the ties decide: some row's top-2 holds two tied experts, or one of
    # them beside a third
    tied = np.isin(got["ids"], [1, 3, 6, 2, 5]).all(-1)
    assert tied.any()
    monkeypatch.setattr(tmoe, "top_k", _with_topk())
    with pytest.raises(AssertionError):
        check_against_jax(MOONSHOT, x, params=params)


def _nan_case():
    """Sequence 0: 30 tokens whose router logits favour expert 0 (so it
    fills to capacity with first choices), then 4 NaN rows, dropped at
    expert 0 and landing in its slot cap − 1; sequence 1: NaN rows among
    random ones."""
    jcfg, tcfg, jp, tp = moe_params(MOONSHOT, seed=7)
    x = _x(8, (2, 34, 128))
    x[0, :30] += 4.0 * _unit(jp["router"]["kernel"][:, 0])
    x[0, 30:] = np.nan
    x[1, [3, 11, 20]] = np.nan
    return (jcfg, tcfg, jp, tp), x


def test_nan_rows_take_capacity_and_spread_like_jax(monkeypatch):
    params, x = _nan_case()
    got = check_against_jax(MOONSHOT, x, params=params)
    cap = got["cap"]
    nan_rows = np.isnan(x).any(-1)
    # a NaN row routes to experts [0, 1] (lax.top_k's NaN order) and keeps
    # no slot, but its update lands: the dropped ones in slot cap − 1
    assert (got["ids"][nan_rows] == [0, 1]).all()
    assert (got["keep"][nan_rows] == 0).all()
    assert np.isnan(got["buf"][0, 0, cap - 1]).all()
    # ... which turns the kept row in that slot NaN too
    out_nan = np.isnan(got["y"]).any(-1)
    assert out_nan[0].sum() > nan_rows[0].sum()
    monkeypatch.setattr(tmoe, "top_k", _with_topk())
    with pytest.raises(AssertionError):
        check_against_jax(MOONSHOT, x, params=params)


def test_moe_gradients_match_jax():
    """d/dx, d/drouter and d/dexperts of sum(y · w) + aux."""
    jcfg, tcfg, jp, tp = moe_params("arctic-480b", seed=9)
    x = _x(10, (2, 24, 128))
    w = _x(11, x.shape)

    def jloss(p, x):
        y, aux = jmoe.moe_ffn(p, jcfg, x)
        return jnp.sum(y * w) + aux
    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    y, aux = tmoe.moe_ffn(tp, tcfg, xt)
    tg = torch.autograd.grad((y * torch.from_numpy(w)).sum() + aux,
                             leaves + [xt])
    np.testing.assert_allclose(_np(tg[-1]), np.asarray(jg[1]), **GRAD)
    flat = jax.tree_util.tree_flatten_with_path(jg[0])[0]
    assert [jax.tree_util.keystr(k) for k, _ in flat] == [
        "['dense']['wg']['kernel']", "['dense']['wi']['kernel']",
        "['dense']['wo']['kernel']", "['router']['kernel']",
        "['wg']['kernel']", "['wi']['kernel']", "['wo']['kernel']"]
    for (path, j), t in zip(flat, tg[:-1]):
        np.testing.assert_allclose(_np(t), np.asarray(j), err_msg=str(path),
                                   **GRAD)


def test_router_stays_fp32_in_bf16():
    _, _, jparams, tcfg, _, _ = setup(MOONSHOT)
    p = from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu",
                 dtype=torch.bfloat16)
    assert p["layers"]["moe"]["router"]["kernel"].dtype == torch.float32
    assert p["layers"]["moe"]["wi"]["kernel"].dtype == torch.bfloat16
    arctic = setup("arctic-480b")[5]
    assert set(arctic["layers"]["moe"]) == {"router", "wi", "wg", "wo",
                                            "dense"}
    assert len(tree_leaves(arctic)) == len(jax.tree.leaves(
        setup("arctic-480b")[2]))


# ------------------------------------------------------------------ LM ---

def _batch(cfg, seed, b=4, s=32):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
            for k in ("tokens", "labels")}


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_tree_close(ours, theirs, tol):
    ours = ours if isinstance(ours, list) else tree_leaves(ours)
    flat = jax.tree_util.tree_flatten_with_path(theirs)[0]
    assert len(flat) == len(ours)
    for (path, j), t in zip(flat, ours):
        np.testing.assert_allclose(_np(t), _np(j), err_msg=str(path), **tol)


@pytest.mark.parametrize("name", NAMES)
def test_forward_prefill_and_loss_match_jax(name):
    """Logits and the prefill's K/V through every path (K2 and K3's plain
    versions, dense, blockwise), and the loss with its moe_aux."""
    jcfg, jlm, jparams, tcfg, tlm, tparams = setup(name)
    batch = _batch(jcfg, 1)
    jl, jaux, jcache = jlm.forward(jparams, batch, JOpts(
        attn_impl="dense", remat="none"), collect_cache=True)
    toks = torch.from_numpy(batch["tokens"]).long()
    with torch.no_grad():
        for opts in (ForwardOpts(), ForwardOpts("dense", "plain"), TOPTS):
            tl, tc, taux = tlm.forward(tparams, toks, opts,
                                       collect_cache=True, return_aux=True)
            np.testing.assert_allclose(_np(tl), np.asarray(jl), **FWD)
            np.testing.assert_allclose(float(taux),
                                       float(jaux["moe_aux"]), **FWD)
            for key in ("k", "v"):
                np.testing.assert_allclose(
                    _np(tc["layers"][key]),
                    np.asarray(jcache["layers"][key]), **FWD)
        _, tm = tlm.loss(tparams, _tbatch(batch))
    _, jm = jlm.loss(jparams, batch, JOPTS)
    assert float(jm["moe_aux"]) > 1.0
    for key in ("loss", "nll", "z_loss", "moe_aux"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), **FWD)


def _loss_and_grads(tlm, params, batch, remat):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opts = dataclasses.replace(TOPTS, remat=remat)
    loss, m = tlm.loss(params, _tbatch(batch), opts)
    return loss.detach(), m, torch.autograd.grad(loss, leaves)


@pytest.mark.parametrize("name", NAMES)
def test_loss_gradients_and_remat_match_jax(name):
    """Every gradient leaf (the router's and the experts' included) against
    ``jax.grad``; remat none, selective and full give bitwise-equal losses
    and gradients."""
    jcfg, jlm, jparams, tcfg, tlm, _ = setup(name)
    batch = _batch(jcfg, 2)
    (_, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jlm.loss(p, batch, JOPTS), has_aux=True))(jparams)
    params = from_jax(jax.tree.map(np.asarray, jparams), tcfg, "cpu",
                      torch.float32)
    runs = {r: _loss_and_grads(tlm, params, batch, r)
            for r in ("none", "selective", "full")}
    loss, tm, tg = runs["none"]
    for key in ("loss", "moe_aux"):
        np.testing.assert_allclose(_np(tm[key]), _np(jm[key]), **FWD)
    _assert_tree_close(list(tg), jg, GRAD)
    for remat in ("selective", "full"):
        assert torch.equal(runs[remat][0], loss), remat
        assert all(torch.equal(a, b) for a, b in zip(runs[remat][2], tg)), \
            remat


@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_jax(name):
    """One AdamW step from JAX's initial state: metrics, parameters and
    moments."""
    jcfg, jlm, _, tcfg, tlm, _ = setup(name)
    jt = JTrainConfig(**TCFG)
    state = jinit_train_state(jlm, jax.random.key(0), jt)
    tstate = train_state_from_jax(jax.tree.map(np.asarray, state), tcfg,
                                  "cpu")
    batch = _batch(jcfg, 3)
    state, jm = jax.jit(jmake_train_step(jlm, jt, JOPTS))(state, batch)
    tstate, tm = make_train_step(tlm, TrainConfig(**TCFG), TOPTS)(tstate,
                                                                  batch)
    for key in ("loss", "nll", "moe_aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[key]), float(jm[key]),
                                   rtol=1e-5, err_msg=key)
    _assert_tree_close(tstate["params"], state["params"], GRAD)
    for key in ("m", "v"):
        _assert_tree_close(tstate["opt"][key], state["opt"][key], GRAD)


@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_forward_and_jax(name):
    """JAX's ``test_decode_consistent_with_forward`` with
    ``capacity_factor=8.0`` (no token dropped either way): the prefill of
    S − 1 tokens, its K/V copied into the dense cache, one decode step at
    position S − 1 against the forward's last row, and against JAX's
    decode step on the same cache."""
    jcfg, jlm, jparams, tcfg, tlm, tparams = setup(name,
                                                   capacity_factor=8.0)
    s = 32
    batch = _batch(jcfg, 4, b=2, s=s)
    opts = JOpts(attn_impl="dense", remat="none")
    full, _, _ = jlm.forward(jparams, batch, opts)
    _, jc = jlm.prefill(jparams, {"tokens": batch["tokens"][:, :-1]}, opts)
    jc = {"layers": {k: jnp.pad(v, [(0, 0), (0, 0), (0, 1), (0, 0),
                                   (0, 0)])
                     for k, v in jc["layers"].items()}}
    jd, _ = jlm.decode_step(jparams, batch["tokens"][:, -1:], jc,
                            jnp.int32(s - 1))
    toks = torch.from_numpy(batch["tokens"]).long()
    with torch.no_grad():
        tfull, _ = tlm.forward(tparams, toks)
        _, pc = tlm.prefill(tparams, toks[:, :-1])
        cache = tlm.init_cache(2, s, backend=None, device="cpu")
        for key in ("k", "v"):
            cache["layers"][key][:, :, :s - 1] = pc["layers"][key]
        td, _ = tlm.decode_step(tparams, toks[:, -1:], cache,
                                torch.full((2,), s - 1, dtype=torch.int32))
    a, b = _np(tfull)[:, -1], _np(td)[:, 0]
    assert np.abs(a - b).max() / np.abs(a).max() < 1e-4
    np.testing.assert_allclose(b, np.asarray(jd)[:, 0], **FWD)
    np.testing.assert_allclose(_np(tfull), np.asarray(full), **FWD)


# -------------------------------------------------------------- engine ---

MODS = (jserve, tserve)
COUNTERS = ("serve_admission_deferred_total", "serve_preemptions_total",
            "serve_prefill_dispatches_total", "serve_prefill_tokens_total",
            "serve_decode_dispatches_total", "serve_tokens_total",
            "serve_faults_injected_total", "serve_stream_retries_total",
            "serve_dead_letter_total")


def engine(mod, lm=None, **kw):
    """An engine of ``mod`` on moonshot reduced's shared weights; a
    ``fault_plan`` string is parsed by ``mod``; ``lm`` replaces the port's
    model."""
    _, jlm, jparams, _, tlm, tparams = setup(MOONSHOT)
    if isinstance(kw.get("fault_plan"), str):
        kw["fault_plan"] = mod.FaultPlan.parse(kw["fault_plan"])
    if mod is jserve:
        return jserve.ServeEngine(jlm, jparams, **kw)
    return tserve.ServeEngine(lm or tlm, tparams, device="cpu", **kw)


def snapshot(eng):
    snap = ([None if r is None else r.id for r in eng.slot_req],
            [r.id for r in eng.queue], eng.active.tolist(),
            eng.slot_pos.tolist(), eng.next_token.tolist(),
            {c: sorted(eng.reg.counter(c).labels_values())
             for c in COUNTERS})
    if eng.kv.backend == "paged":
        snap += (eng.kv.page_table.tolist(),
                 eng.kv.memory_stats().pages_in_use)
    return snap


def outcome(eng):
    return sorted((r.id, r.status, tuple(r.out_tokens), r.preemptions,
                   r.retries) for r in eng.finished)


def drive(eng, mod, arrivals, max_iters=300):
    """Submit ``arrivals`` ({iteration: [(id, prompt, max_new, tenant)]})
    and step until drained; returns the snapshots after every step."""
    snaps = []
    last = max(arrivals)
    for it in range(max_iters):
        for i, prompt, new, tenant in arrivals.get(it, []):
            eng.submit(mod.Request(i, prompt.copy(), max_new_tokens=new,
                                   tenant=tenant))
        live = eng.step()
        snaps.append(snapshot(eng))
        if it >= last and not live and not eng.queue:
            return snaps
    raise AssertionError("the engine did not drain")


def lockstep(make_engine, arrivals):
    """A JAX and a port engine through the same arrivals, equal snapshots
    after every step (slots, queue, positions, pending tokens, counters,
    tables), then equal outcomes.  Returns both engines."""
    engs = [make_engine(mod) for mod in MODS]
    snaps = [drive(e, m, arrivals) for e, m in zip(engs, MODS)]
    assert len(snaps[1]) == len(snaps[0])
    for it, (a, b) in enumerate(zip(*snaps)):
        assert b == a, f"step {it}"
    assert outcome(engs[1]) == outcome(engs[0])
    if engs[1].kv.backend == "paged":
        engs[1].kv.verify()
    return engs


def workload(seed=5, tenant="default"):
    """Nine requests over four slots: prompts of 3-13 tokens (buckets 4, 8
    and 16, so most rows of a prefill group are padding), 4-10 new tokens,
    arriving at iterations 0, 2 and 5, so slots sit parked between
    requests."""
    rng = np.random.default_rng(seed)
    reqs = [(i, rng.integers(1, 512, int(n)).astype(np.int32), int(new),
             tenant)
            for i, (n, new) in enumerate(zip(rng.integers(3, 14, 9),
                                             rng.integers(4, 11, 9)))]
    return {0: reqs[:3], 2: reqs[3:5], 5: reqs[5:]}


BASE = dict(max_batch=4, max_seq=48)


@pytest.mark.parametrize("backend,kv_dtype", [("paged", "native"),
                                              ("paged", "int8"),
                                              ("contiguous", "native")])
def test_engine_matches_jax_in_lockstep(backend, kv_dtype):
    kw = dict(BASE, cache_backend=backend, kv_dtype=kv_dtype)
    if backend == "paged":
        kw["page_size"] = 8
    engs = lockstep(lambda m: engine(m, **kw), workload())
    assert all(r.status == "completed" for r in engs[1].finished)
    assert len(engs[1].finished) == 9


def _port_outcome():
    eng = engine(tserve, page_size=8, **BASE)
    drive(eng, tserve, workload())
    return outcome(eng)


def test_parked_slots_take_capacity(monkeypatch):
    """The workload routes through the parked slots: a decode step that
    feeds the idle slots token 7 instead of their stale pending token
    changes a live stream (the engine above equals JAX's without it)."""
    base = _port_outcome()
    fused = tserve.ServeEngine._fused

    def idle_fed_7(self, positions, steps, poison=None):
        keep = self.next_token.copy()
        self.next_token[~self.active] = 7
        try:
            return fused(self, positions, steps, poison)
        finally:
            self.next_token[:] = keep
    monkeypatch.setattr(tserve.ServeEngine, "_fused", idle_fed_7)
    assert _port_outcome() != base


def test_bucket_padding_takes_capacity():
    """Each of the workload's prompts padded to its bucket: padding with
    token 5 instead of the engines' 0 moves the real rows' prefill logits
    (the pads' first choices outrank the real rows' second ones); the
    lockstep above holds the engines' zero-padded prefills to JAX's."""
    tlm, tparams = setup(MOONSHOT)[4:]
    moved = []
    for reqs in workload().values():
        for _, prompt, _, _ in reqs:
            n = len(prompt)
            bucket = 1 << (n - 1).bit_length()
            rows = []
            for pad in (0, 5):
                toks = np.full((1, bucket), pad, np.int32)
                toks[0, :n] = prompt
                with torch.no_grad():
                    lg, _ = tlm.forward(tparams, torch.from_numpy(toks))
                rows.append(_np(lg)[0, :n])
            if bucket > n:
                moved.append(float(np.abs(rows[0] - rows[1]).max()))
    assert moved and min(moved) > 1e-3


def test_preemption_and_resume_match_jax():
    """Two bulk requests hold both slots; a chat request arriving at
    iteration 4 preempts one, which resumes by a prefill of its prompt and
    emitted tokens: a different routing group than its first prefill."""
    rng = np.random.default_rng(7)
    ps = [rng.integers(1, 512, n).astype(np.int32) for n in (10, 9, 6)]
    arrivals = {0: [(i, ps[i], 12, "bulk") for i in range(2)],
                4: [(2, ps[2], 4, "chat")]}

    def make(m):
        ten = m.TenancyConfig([m.TenantSpec("chat", "interactive"),
                               m.TenantSpec("bulk", "batch")])
        return engine(m, max_batch=2, max_seq=64, page_size=8, num_pages=12,
                      tenancy=ten)
    engs = lockstep(make, arrivals)
    pre = [r for r in engs[1].finished if r.preemptions]
    assert pre and all(len(r.out_tokens) == 12 for r in pre)


def test_fault_plan_outcomes_match_jax():
    """A poisoned page and a NaN logit row under JAX's engine and the
    port's with ``decode_impl="gather"`` (JAX's default): a NaN row takes
    capacity in the decode group, so the outcome rides on the exact expert
    ids; streams, statuses, retries and the fault counters equal JAX's."""
    kw = dict(max_batch=4, max_seq=64, page_size=4, num_pages=33,
              fault_plan="poison_page@2,nan_logits@5,poison_page@7",
              watchdog_iters=16, verify_cache=True)

    def make(m):
        return engine(m, **kw, **({"decode_impl": "gather"}
                                  if m is tserve else {}))
    engs = lockstep(make, workload(9))
    retried = sum(v for _, v in engs[1].reg.counter(
        "serve_stream_retries_total").labels_values())
    assert retried >= 2


def test_chunked_prefill_refused_with_jax_message():
    msgs = []
    for mod in MODS:
        with pytest.raises(ValueError) as e:
            engine(mod, max_batch=2, max_seq=64, page_size=8,
                   prefill_chunk=8)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert "MoE prompts prefill whole-prompt" in msgs[1]
    with pytest.raises(ValueError, match="dense-FFN"):
        setup(MOONSHOT)[4].prefill_chunk(None, None, {"page_table": None},
                                         None, None, None)


RANK = """
import json, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.models import LM
from repro_torch.parallel import PoolGroup
from repro_torch.serve import Request, ServeEngine
rank, port, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group('gloo', init_method=f'tcp://localhost:{port}',
                        rank=rank, world_size=2)
params, cfg, reqs = torch.load(path, weights_only=False)
out = {}
for kv_dtype in ('native', 'int8'):
    eng = ServeEngine(LM(cfg), params, 4, 48, page_size=8, device='cpu',
                      kv_dtype=kv_dtype, pool_group=PoolGroup.of())
    for i, p, new in reqs:
        eng.submit(Request(i, np.asarray(p, np.int32), max_new_tokens=new))
    out[kv_dtype] = sorted([r.id, r.out_tokens]
                           for r in eng.run_until_drained())
    eng.kv.verify()
dist.destroy_process_group()
print('STREAMS ' + json.dumps(out))
"""


def test_two_gloo_ranks_match_one(tmp_path):
    """Two gloo ranks over a pool split in two: each layer's attention
    merges over the ranks, and the FFN routes the whole batch on every
    rank, so the streams equal the single-rank engine's, native and
    int8."""
    _, _, _, tcfg, tlm, tparams = setup(MOONSHOT)
    reqs = [(i, p.tolist(), new) for arr in workload().values()
            for i, p, new, _ in arr]
    path = tmp_path / "params.pt"
    torch.save((tparams, tcfg, reqs), path)
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), str(port), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=ROOT) for r in range(2)]
    try:
        single = {}
        for kv_dtype in ("native", "int8"):
            eng = tserve.ServeEngine(tlm, tparams, 4, 48, page_size=8,
                                     device="cpu", kv_dtype=kv_dtype)
            for i, p, new in reqs:
                eng.submit(tserve.Request(i, np.asarray(p, np.int32),
                                          max_new_tokens=new))
            single[kv_dtype] = sorted([r.id, r.out_tokens]
                                      for r in eng.run_until_drained())
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert _streams(out) == single


def test_launcher_serves_the_moe_configs(capsys):
    """The serve launcher's ``--arch`` takes the moe configs and serves
    moonshot reduced; ``--prefill-chunk`` is refused for it."""
    from repro_torch.launch import serve as tlaunch
    tparams = setup(MOONSHOT)[5]
    tlaunch.parse_args(["--arch", "arctic-480b"])
    args = tlaunch.parse_args(["--device", "cpu", "--arch", MOONSHOT,
                               "--requests", "4", "--new-tokens", "4"])
    tlaunch.serve(args, None, "cpu", params=tparams)
    assert "served 4 requests (4 completed)" in capsys.readouterr().out
    args = tlaunch.parse_args(["--device", "cpu", "--arch", MOONSHOT,
                               "--prefill-chunk", "8"])
    with pytest.raises(ValueError, match="MoE prompts prefill"):
        tlaunch.serve(args, None, "cpu", params=tparams)
