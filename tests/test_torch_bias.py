"""The biased LayerNorm/GELU dense configs in the port against the JAX
package: the config copies (starcoder2-3b, the paper's Granite family,
llama3-405b), and, on the same weights with every bias and LayerNorm leaf
redrawn from a seeded numpy generator (JAX initializes biases at zero and
LayerNorm at (1, 0), which would hide them), the attention block, the
forward with its collected caches, chained paged decode at ragged
positions, a LayerNorm case through every layer body, engine streams over
native and int8 pages, whole and chunked, and one train step.

Variants beside the reduced configs, whose head layouts collapse to KV=2
(granite-13b) and G=4 (granite-20b-code): MHA (KV = H) and MQA with G=12 >
8, more query heads than one 8-row block of K1.  Reduced fp32; logits and
caches to 2e-5; greedy streams equal, counted by the tie rule of
``tests/test_torch_contiguous.py`` (0 asserted)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import CONFIGS as JCONFIGS
from repro.configs import TrainConfig as JTrainConfig
from repro.models import ForwardOpts as JOpts
from repro.models import LM as JLM
from repro.models import attention as jattn
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.train import init_train_state as jinit_train_state
from repro.train import make_train_step as jmake_train_step
from repro_torch.configs import CONFIGS as TCONFIGS
from repro_torch.configs import TrainConfig, archs
from repro_torch.models import LM, ForwardOpts
from repro_torch.models import attention as tattn
from repro_torch.models.params import from_jax, train_state_from_jax
from repro_torch.models.transformer import layer_params
from repro_torch.serve import Request, ServeEngine
from repro_torch.train import make_train_step
from repro_torch.train.optimizer import tree_leaves
from test_torch_contiguous import _assert_streams_match, _workload
from test_torch_tenancy import one_torch_thread  # noqa: F401

NEW = ["starcoder2-3b", "granite-8b", "granite-13b", "granite-20b-code",
       "llama3-405b"]
# variant -> (JAX config, change to its reduced config)
VARIANTS = {
    "starcoder2-3b": ("starcoder2-3b", {}),
    "granite-13b": ("granite-13b", {}),
    "granite-20b-code": ("granite-20b-code", {}),
    "granite-13b-mha": ("granite-13b", {"num_kv_heads": 4}),
    "granite-20b-mqa-g12": ("granite-20b-code", {"num_heads": 12}),
}
TOL = dict(rtol=2e-5, atol=2e-5)


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _redraw(tree, seed: int):
    """Every ``bias`` leaf ~ N(0, 0.2) and every norm ``scale`` ~ N(1,
    0.2), from a seeded numpy generator (numpy tree in, numpy tree out)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        key = path[-1].key
        if key == "bias":
            return rng.normal(0.0, 0.2, a.shape).astype(a.dtype)
        if key == "scale":
            return rng.normal(1.0, 0.2, a.shape).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _cfgs(name):
    base, change = VARIANTS[name]
    return tuple(dataclasses.replace(c[base].reduced(), dtype="float32",
                                     **change)
                 for c in (JCONFIGS, TCONFIGS))


@functools.lru_cache(maxsize=None)
def setup(name):
    """Both packages' models on the variant's reduced fp32 config, on JAX's
    ``key(0)`` weights with every bias and norm leaf redrawn."""
    jcfg, tcfg = _cfgs(name)
    jlm = JLM(jcfg)
    tree = _redraw(jax.tree.map(np.asarray, jlm.init(jax.random.key(0))),
                   seed=sorted(VARIANTS).index(name))
    jparams = jax.tree.map(jnp.asarray, tree)
    tparams = from_jax(tree, tcfg, device="cpu")
    return jcfg, jlm, jparams, tcfg, LM(tcfg), tparams


# ------------------------------------------------------------- configs ----

@pytest.mark.parametrize("name", NEW)
def test_config_copies_equal_jax(name):
    j, t = JCONFIGS[name], TCONFIGS[name]
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(j.reduced()) == dataclasses.asdict(t.reduced())
    assert j.param_count() == t.param_count()
    assert name in archs("dense")


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_spec_has_jax_bias_leaves_and_from_jax_keeps_their_dtypes(name):
    """The port's spec is JAX's tree (every bias leaf in JAX's layout), and
    ``from_jax`` casts matrix biases to the compute dtype, LayerNorm leaves
    staying fp32."""
    jcfg, jlm, jparams, tcfg, tlm, _ = setup(name)
    shapes = jax.tree.map(lambda a: tuple(a.shape), jparams)
    assert shapes == jax.tree.map(lambda a: tuple(a.shape),
                                  tlm.init(0, device="cpu"))
    at = shapes["layers"]["attn"]
    L, h, kv, hd = (jcfg.num_layers, jcfg.num_heads, jcfg.num_kv_heads,
                    jcfg.resolved_head_dim)
    assert (at["wq"]["bias"], at["wk"]["bias"], at["wo"]["bias"]) == (
        (L, h, hd), (L, kv, hd), (L, jcfg.d_model))
    p = from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu",
                 dtype=torch.bfloat16)
    assert p["layers"]["mlp"]["wi"]["bias"].dtype == torch.bfloat16
    assert p["layers"]["attn"]["wo"]["bias"].dtype == torch.bfloat16
    for norm in (p["layers"]["ln1"], p["final_norm"]):
        assert norm["bias"].dtype == norm["scale"].dtype == torch.float32
    exp = np.asarray(jparams["layers"]["attn"]["wq"]["bias"]
                     .astype(jnp.bfloat16), np.float32)
    np.testing.assert_array_equal(_np(p["layers"]["attn"]["wq"]["bias"]), exp)


# --------------------------------------------------------------- model ----

@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_attention_block_matches_jax(name, impl):
    jcfg, _, jparams, tcfg, _, tparams = setup(name)
    x = np.random.default_rng(1).normal(0, 1, (2, 12, jcfg.d_model)) \
        .astype(np.float32)
    jp = jax.tree.map(lambda a: a[0], jparams["layers"])["attn"]
    jy, (jk, jv) = jattn.attention_block(jp, jcfg, jnp.asarray(x),
                                         impl="dense")
    ty, (tk, tv) = tattn.attention_block(layer_params(tparams, 0)["attn"],
                                         tcfg, torch.from_numpy(x),
                                         impl=impl)
    for a, b in ((ty, jy), (tk, jk), (tv, jv)):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_forward_logits_and_caches_match_jax(name):
    jcfg, jlm, jparams, tcfg, tlm, tparams = setup(name)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab_size, (3, 16)) \
        .astype(np.int32)
    jl, _, jc = jlm.forward(jparams, {"tokens": jnp.asarray(toks)},
                            JOpts(attn_impl="dense", remat="none"),
                            collect_cache=True)
    for impl in ("flash", "dense"):
        tl, tc = tlm.forward(tparams, torch.from_numpy(toks).long(),
                             ForwardOpts(attn_impl=impl), collect_cache=True)
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
        for k in ("k", "v"):
            np.testing.assert_allclose(_np(tc["layers"][k]),
                                       _np(jc["layers"][k]), **TOL)


DECODE = dict(b=4, page=4, m=6, steps=8)


def _decode_inputs(jcfg):
    """Pools of random rows, a table with a freed slot (row of zeros,
    position 0), ragged positions and each step's tokens."""
    rng = np.random.default_rng(3)
    b, page, m = DECODE["b"], DECODE["page"], DECODE["m"]
    table = (np.arange(b * m) + 1).reshape(b, m).astype(np.int32)
    table[3] = 0
    pools = rng.normal(0, 1, (2, jcfg.num_layers, b * m + 1, page,
                              jcfg.num_kv_heads, jcfg.resolved_head_dim)
                       ).astype(np.float32)
    pos = np.array([2, 7, 12, 0], np.int32)
    steps = [(rng.integers(0, jcfg.vocab_size, (b, 1)).astype(np.int32),
              np.where(np.arange(b) == 3, 0, pos + t).astype(np.int32))
             for t in range(DECODE["steps"])]
    return table, pools, steps


@functools.lru_cache(maxsize=None)
def _jax_decode(name):
    """JAX's logits at every step and its pools after the last."""
    jcfg, jlm, jparams, *_ = setup(name)
    table, pools, steps = _decode_inputs(jcfg)
    cache = {"layers": {"k": jnp.asarray(pools[0]),
                        "v": jnp.asarray(pools[1])},
             "page_table": jnp.asarray(table)}
    step = jax.jit(jlm.decode_step)
    logits = []
    for toks, p in steps:
        lg, cache = step(jparams, jnp.asarray(toks), cache, jnp.asarray(p))
        logits.append(np.asarray(lg))
    return logits, {k: np.asarray(v) for k, v in cache["layers"].items()}


@pytest.mark.parametrize("decode_impl", ["kernel", "gather"])
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_chained_paged_decode_steps_match_jax(name, decode_impl):
    """8 decode steps at ragged per-slot positions over a paged pool, a
    freed slot parked at position 0 on the scratch page included: logits
    each step and the pools at the end."""
    jcfg, _, _, tcfg, tlm, tparams = setup(name)
    table, pools, steps = _decode_inputs(jcfg)
    exp, jpools = _jax_decode(name)
    cache = {"layers": {"k": torch.from_numpy(pools[0].copy()),
                        "v": torch.from_numpy(pools[1].copy())},
             "page_table": torch.from_numpy(table)}
    for (toks, p), jl in zip(steps, exp):
        tl, cache = tlm.decode_step(tparams, torch.from_numpy(toks).long(),
                                    cache, torch.from_numpy(p),
                                    decode_impl=decode_impl)
        # the freed slot's output is garbage by design: compare live slots
        np.testing.assert_allclose(_np(tl[:3]), jl[:3], **TOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(_np(cache["layers"][k]), jpools[k], **TOL)


def test_layernorm_reaches_every_layer_body():
    """granite-13b with LayerNorm leaves far from (1, 0): the forward, a
    decode step and a chunk of chunked prefill each normalize through the
    config's norm (``apply_norm``); a layer body that called RMSNorm
    directly would drop the mean and the bias and miss JAX by far more
    than 2e-5."""
    jcfg, jlm, jparams, tcfg, tlm, tparams = setup("granite-13b")
    assert tcfg.norm == "layernorm"
    ln = tparams["layers"]["ln1"]["bias"]
    assert float(ln.abs().max()) > 0.3
    rng = np.random.default_rng(4)
    page, plen, m = 4, 10, 4
    L, kv, hd = tcfg.num_layers, tcfg.num_kv_heads, tcfg.resolved_head_dim
    toks = rng.integers(0, tcfg.vocab_size, (1, plen)).astype(np.int32)
    jl, _, _ = jlm.forward(jparams, {"tokens": jnp.asarray(toks)},
                           JOpts(attn_impl="dense", remat="none"))
    tl, _ = tlm.forward(tparams, torch.from_numpy(toks).long())
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    # one chunk of the whole prompt into empty pools (pages 1..m), then a
    # decode step over what it wrote
    table = np.arange(1, m + 1, dtype=np.int32)[None]
    pos = np.arange(plen)
    dest = (table[0, pos // page] * page + pos % page)[None].astype(np.int32)
    start, last = np.zeros(1, np.int32), np.array([plen - 1], np.int32)
    zeros = np.zeros((L, m + 1, page, kv, hd), np.float32)
    jcache = {"layers": {"k": jnp.asarray(zeros), "v": jnp.asarray(zeros)},
              "page_table": jnp.asarray(table)}
    tcache = {"layers": {"k": torch.zeros(zeros.shape),
                         "v": torch.zeros(zeros.shape)},
              "page_table": torch.from_numpy(table)}
    jl, jcache = jlm.prefill_chunk(jparams, jnp.asarray(toks), jcache,
                                   jnp.asarray(start), jnp.asarray(dest),
                                   jnp.asarray(last))
    tl, tcache = tlm.prefill_chunk(tparams, torch.from_numpy(toks).long(),
                                   tcache, torch.from_numpy(start),
                                   torch.from_numpy(dest),
                                   torch.from_numpy(last))
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    nxt = np.array([[int(np.asarray(jl)[0, 0, :tcfg.vocab_size].argmax())]],
                   np.int32)
    jl, _ = jlm.decode_step(jparams, jnp.asarray(nxt), jcache,
                            jnp.asarray(last + 1))
    tl, _ = tlm.decode_step(tparams, torch.from_numpy(nxt).long(), tcache,
                            torch.from_numpy(last + 1))
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)


# -------------------------------------------------------------- engine ----

ENGINE = dict(max_batch=4, max_seq=32, page_size=4)
MODES = {"native": {}, "int8": {"kv_dtype": "int8"},
         "chunked": {"prefill_chunk": 4, "prefill_budget": 8},
         "chunked-int8": {"prefill_chunk": 4, "prefill_budget": 8,
                          "kv_dtype": "int8"}}


@functools.lru_cache(maxsize=None)
def _jax_streams(name, mode):
    jcfg, jlm, jparams, *_ = setup(name)
    eng = JServeEngine(jlm, jparams, cache_backend="paged", **ENGINE,
                       **MODES[mode])
    for i, prompt, new in _workload(jcfg.vocab_size):
        eng.submit(JRequest(i, prompt.copy(), max_new_tokens=new))
    return {r.id: list(r.out_tokens) for r in eng.run_until_drained()}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", ["starcoder2-3b", "granite-13b-mha",
                                  "granite-20b-mqa-g12"])
def test_engine_streams_match_jax(name, mode):
    """The shared-prefix workload through the port's engine and JAX's on
    the same tree: equal greedy streams, 0 by the tie rule, and a pool
    that drains."""
    _, _, _, tcfg, tlm, tparams = setup(name)
    eng = ServeEngine(tlm, tparams, device="cpu", **ENGINE, **MODES[mode])
    work = _workload(tcfg.vocab_size)
    for i, prompt, new in work:
        eng.submit(Request(i, prompt.copy(), max_new_tokens=new))
    got = {r.id: list(r.out_tokens) for r in eng.run_until_drained()}
    assert eng.kv.memory_stats().pages_in_use == 0
    assert (eng.reg.counter("serve_prefill_chunks_total").get() > 0) == \
        ("chunked" in mode)
    ties = _assert_streams_match(tlm, tparams, {i: p for i, p, _ in work},
                                 got, _jax_streams(name, mode))
    print(f"{name} {mode}: {ties} of {len(got)} streams equal only by the "
          "tie rule")
    assert ties == 0


# --------------------------------------------------------------- train ----

def test_train_step_matches_jax():
    """One train step of reduced starcoder2-3b (biases, LayerNorm, GELU)
    from the same state: loss, grad norm and every parameter and moment
    after the update, every bias leaf decayed as JAX decays it (by the
    stacked leaf's ndim)."""
    jcfg, jlm, _, tcfg, tlm, _ = setup("starcoder2-3b")
    kw = dict(learning_rate=5e-3, warmup_steps=2, total_steps=40)
    jt = JTrainConfig(**kw)
    jstate = jinit_train_state(jlm, jax.random.key(0), jt)
    tree = jax.tree.map(np.asarray, jstate)
    tree["params"] = _redraw(tree["params"], seed=7)
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(0, jcfg.vocab_size, (4, 32)).astype(np.int32)
             for k in ("tokens", "labels")}
    jopts = JOpts(attn_impl="blockwise", q_chunk=16, kv_chunk=8,
                  remat="none")
    topts = ForwardOpts(attn_impl="blockwise", norm_impl="plain",
                        q_chunk=16, kv_chunk=8)
    jnew, jm = jax.jit(jmake_train_step(jlm, jt, jopts))(
        jax.tree.map(jnp.asarray, tree), batch)
    state = train_state_from_jax(tree, tcfg, "cpu")
    state, m = make_train_step(tlm, TrainConfig(**kw), topts)(state, batch)
    for key in ("loss", "nll", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=2e-5,
                                   err_msg=key)
    for ours, theirs in ((state["params"], jnew["params"]),
                         (state["opt"]["m"], jnew["opt"]["m"]),
                         (state["opt"]["v"], jnew["opt"]["v"])):
        flat = jax.tree_util.tree_flatten_with_path(theirs)[0]
        leaves = tree_leaves(ours)
        assert len(flat) == len(leaves)
        for (path, j), t in zip(flat, leaves):
            np.testing.assert_allclose(_np(t), _np(j), err_msg=str(path),
                                       **TOL)
