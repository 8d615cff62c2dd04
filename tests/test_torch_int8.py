"""int8 KV pages in the port against the JAX package: ``quantize_kv`` and
``dequantize_kv`` bitwise; K1's int8 mode (its plain version) against
``repro.kernels.ref.paged_decode_ref`` and the Pallas kernel in interpret
mode; int8 decode logits on the same int8 pools; the pools the port writes
against the pools JAX writes; the int8 engine's greedy streams, dispatch
count, drain and quant gauges against the JAX int8 engine; the byte math;
the refusal of a float block by an int8 pool; and the launcher's line.
Reduced qwen3-4b in fp32 (2 layers, 2 KV heads, head dim 32), page 4,
max_batch 4, max_seq 32; tolerance 2e-5."""
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
from repro.kernels import ops as jops
from repro.kernels import quant as jquant
from repro.kernels import ref as jref
from repro.models import ForwardOpts as JOpts
from repro.models import LM as JLM
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve import kvcache as jkvcache
from repro_torch.configs import CONFIGS as TCONFIGS
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_decode as tpd
from repro_torch.kernels import quant as tquant
from repro_torch.models import LM, ForwardOpts
from repro_torch.models import attention as tattn
from repro_torch.models.attention import _scatter_paged_kv
from repro_torch.models.params import cache_from_jax, from_jax
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve import kvcache as tkvcache
from test_torch_tenancy import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-5, atol=2e-5)
PAGE, BATCH, MAX_SEQ = 4, 4, 32


@functools.lru_cache(maxsize=None)
def setup():
    jcfg = dataclasses.replace(JCONFIGS["qwen3-4b"].reduced(), dtype="float32")
    tcfg = dataclasses.replace(TCONFIGS["qwen3-4b"].reduced(), dtype="float32")
    jparams = JLM(jcfg).init(jax.random.key(0))
    tparams = from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, JLM(jcfg), jparams, tcfg, LM(tcfg), tparams


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


# -------------------------------------------------------- quantize_kv ----

def _quant_input(kind):
    """(16, 4, 64) fp32 rows from a seed: plain normals, rows of zeros,
    denormal rows, rows whose elements sit exactly on .5 boundaries (absmax
    127 gives scale 1), and rows whose magnitudes span 1e-3 .. 1e3."""
    rng = np.random.default_rng({"normal": 1, "zero_rows": 2,
                                 "denormal_rows": 3, "half_boundaries": 4,
                                 "wide_range": 5, "bfloat16": 6}[kind])
    x = rng.normal(0, 2, (16, 4, 64)).astype(np.float32)
    if kind == "zero_rows":
        x[::3] = 0.0
    elif kind == "denormal_rows":
        x[::2] = rng.normal(0, 1e-39, x[::2].shape).astype(np.float32)
        x[1, 0, :4] = np.float32(1e-45)
    elif kind == "half_boundaries":
        x = (rng.integers(-127, 127, x.shape) + 0.5).astype(np.float32)
        x[..., 0] = 127.0
    elif kind == "wide_range":
        x *= rng.uniform(1e-3, 1e3, (16, 4, 1)).astype(np.float32)
    return x


@pytest.mark.parametrize("kind", ["normal", "zero_rows", "denormal_rows",
                                  "half_boundaries", "wide_range",
                                  "bfloat16"])
def test_quantize_kv_bitwise_matches_jax(kind):
    """The same fp32 (or bf16, cast to fp32 first) inputs give bitwise the
    same int8 rows and fp32 scales, and dequantize to the same values."""
    x = _quant_input(kind)
    if kind == "bfloat16":
        jx = jnp.asarray(x, jnp.bfloat16)
        tx = torch.from_numpy(x).to(torch.bfloat16)
    else:
        jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jq, js = jquant.quantize_kv(jx)
    tq, ts = tquant.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if kind == "half_boundaries":           # round half to even, as jnp
        assert (np.asarray(js) == 1.0).all()
        np.testing.assert_array_equal(tq.numpy(), np.round(x))
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        np.testing.assert_array_equal(
            _np(tquant.dequantize_kv(tq, ts, td)),
            _np(jquant.dequantize_kv(jq, js, jd)))
    if kind in ("zero_rows", "denormal_rows"):
        tiny = np.abs(x).max(axis=-1) < 1e-30
        assert tiny.any() and (tq.numpy()[tiny] == 0).all()


# ----------------------------------------------------------- K1 int8 ----

def _int8_pools(rng, p, page, kv, d):
    """Int8 pools and scales made by the JAX quantize_kv from normals."""
    kq, ks = jquant.quantize_kv(jnp.asarray(rng.normal(size=(p, page, kv, d)),
                                            jnp.float32))
    vq, vs = jquant.quantize_kv(jnp.asarray(rng.normal(size=(p, page, kv, d)),
                                            jnp.float32))
    return [np.array(a) for a in (kq, ks, vq, vs)]


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_plain_int8_paged_decode_matches_ref_and_pallas():
    """B=6 slots at page boundaries (0, page-1, page, 2 page-1, 2 page, the
    last row) over int8 pools: the port's plain int8 K1 against the JAX
    oracle and the Pallas kernel (interpret mode) on the same pools."""
    rng = np.random.default_rng(5)
    b, kv, g, d, page, m = 6, 2, 3, 16, 4, 3
    p = b * m + 1
    q = rng.normal(size=(b, 1, kv, g, d)).astype(np.float32)
    kq, ks, vq, vs = _int8_pools(rng, p, page, kv, d)
    pt = rng.integers(1, p, (b, m)).astype(np.int32)
    pos = np.array([0, page - 1, page, 2 * page - 1, 2 * page, m * page - 1],
                   np.int32)
    before = tops.launch_counts()
    got = tops.paged_decode_attention(*_t(q, kq, vq, pt, pos, ks, vs))
    assert tops.launch_counts() == before      # plain version: no launch
    pallas = jops.paged_decode_attention(*map(jnp.asarray,
                                              (q, kq, vq, pt, pos)),
                                         k_scale=jnp.asarray(ks),
                                         v_scale=jnp.asarray(vs))
    ref = jref.paged_decode_ref(*map(jnp.asarray, (q[:, 0], kq, vq, pt, pos)),
                                k_scale=jnp.asarray(ks),
                                v_scale=jnp.asarray(vs))
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL)
    np.testing.assert_allclose(_np(got[:, 0]), _np(ref), **TOL)


def test_plain_int8_paged_decode_dead_pages_and_scratch():
    """Dead pages whose scales are poisoned (1e30 and NaN) stay out of the
    result: the same slots through a table with live-only entries and
    through one whose dead entries point at the poisoned page agree, and
    match the Pallas kernel on the poisoned table; a slot parked on scratch
    page 0 stays finite."""
    rng = np.random.default_rng(6)
    b, kv, g, d, page, m, p = 3, 1, 2, 16, 4, 4, 8
    q = rng.normal(size=(b, kv, g, d)).astype(np.float32)
    kq, ks, vq, vs = _int8_pools(rng, p, page, kv, d)
    ks[7], vs[7] = 1e30, np.nan
    pos = np.array([2, 5, 0], np.int32)
    live = np.array([[1, 2, 0, 0], [3, 4, 0, 0], [0, 0, 0, 0]], np.int32)
    dead = np.array([[1, 7, 7, 7], [3, 4, 7, 7], [0, 0, 0, 0]], np.int32)
    outs = {}
    for name, table in (("live", live), ("dead", dead)):
        outs[name] = tpd.paged_flash_decode_int8(
            *_t(q, kq, vq, ks, vs, table, pos))
    assert torch.isfinite(outs["dead"]).all()
    np.testing.assert_allclose(_np(outs["dead"]), _np(outs["live"]), **TOL)
    pallas = jops.paged_decode_attention(
        *map(jnp.asarray, (q[:, None], kq, vq, dead, pos)),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    np.testing.assert_allclose(_np(outs["dead"]), _np(pallas[:, 0]), **TOL)


# ------------------------------------------------- model read and write ----

PROMPTS = ((0, 5), (1, 9), (2, 12))     # (slot, prompt length); slot 3 free
STEPS = 5


def _prompts(vocab):
    rng = np.random.default_rng(21)
    return [(slot, rng.integers(0, vocab, plen).astype(np.int32))
            for slot, plen in PROMPTS]


def _decode_inputs(vocab):
    rng = np.random.default_rng(22)
    toks = rng.integers(0, vocab, (STEPS, BATCH, 1)).astype(np.int32)
    pos = np.zeros((STEPS, BATCH), np.int32)
    for slot, plen in PROMPTS:
        pos[:, slot] = plen + np.arange(STEPS)
    return toks, pos


@functools.lru_cache(maxsize=None)
def jax_int8_prefill():
    """A JAX int8 paged cache after the prefill of three prompts."""
    jcfg, jlm, jparams, *_ = setup()
    jkv = jlm.init_cache(BATCH, MAX_SEQ, dtype=jnp.float32, backend="paged",
                         page_size=PAGE, kv_dtype="int8")
    for slot, prompt in _prompts(jcfg.vocab_size):
        assert jkv.alloc(slot, len(prompt) + STEPS, prefix=prompt) == 0
        _, _, cache = jlm.forward(jparams, {"tokens": jnp.asarray(prompt[None])},
                                  JOpts(attn_impl="dense", remat="none"),
                                  collect_cache=True)
        jkv.write_prefill(slot, cache["layers"])
    return jkv


def _rows_written(view, positions):
    """Per layer, the (k, v) rows a decode step wrote at ``positions``, as
    (int8 (B, 1, KV, D), scale (B, 1, KV)) pairs read from its pools."""
    table, layers = view["page_table"], view["layers"]
    b = torch.arange(table.shape[0])
    pids = table[b, positions // PAGE].long()
    rows = positions.long() % PAGE
    return [(layers[n][i][pids, rows][:, None],
             layers[f"{n}_scale"][i][pids, rows][:, None])
            for i in range(layers["k"].shape[0]) for n in "kv"]


@pytest.mark.parametrize("decode_impl", ["kernel", "gather"])
def test_int8_decode_logits_match_jax_on_the_same_pools(decode_impl,
                                                        monkeypatch):
    """Read path, isolated: before every step the port is handed the JAX
    cache's int8 pools and scales (``cache_from_jax``), and the row each
    layer writes is the row JAX wrote in the same step (the port's own
    quantization of it is held within one level here and is the write
    path's test), so both read the same bytes, the just-written row
    included.  The port's decode_step logits then match the JAX int8
    decode_step's on the live slots, and its pools equal JAX's bitwise."""
    jcfg, jlm, jparams, tcfg, tlm, tparams = setup()
    view = jax_int8_prefill().decode_view()
    toks, pos = _decode_inputs(jcfg.vocab_size)
    live = [slot for slot, _ in PROMPTS]
    for t in range(STEPS):
        tview = cache_from_jax(jax.tree.map(np.asarray, view), device="cpu")
        assert tview["layers"]["k"].dtype == torch.int8
        jl, view = jlm.decode_step(jparams, jnp.asarray(toks[t]), view,
                                   jnp.asarray(pos[t]))
        after = cache_from_jax(jax.tree.map(np.asarray, view), device="cpu")
        rows = iter(_rows_written(after, torch.from_numpy(pos[t])))

        def jax_row(x):
            q, _ = tquant.quantize_kv(x)
            jq, js = next(rows)
            assert int((q.int() - jq.int()).abs().max()) <= 1
            return jq, js

        monkeypatch.setattr(tattn, "quantize_kv", jax_row)
        tl, _ = tlm.decode_step(tparams, torch.from_numpy(toks[t]).long(),
                                tview, torch.from_numpy(pos[t]),
                                decode_impl=decode_impl)
        monkeypatch.undo()
        assert next(rows, None) is None
        np.testing.assert_allclose(_np(tl[live]), _np(jl[np.array(live)]),
                                   **TOL)
        for name, pool in tview["layers"].items():
            assert torch.equal(pool, after["layers"][name]), name


def test_int8_pools_written_by_the_port_match_jax():
    """Write path: the port prefills the same prompts (its own forward,
    ``quantize_block``, ``staged_write_prefill``) and decodes the same
    tokens into its own int8 cache.  Scales agree to 1e-6 relative; int8
    values are equal except where the two frameworks' fp32 K/V fall on two
    sides of a rounding boundary, which moves an element by one level: such
    elements are counted and bounded."""
    jcfg, jlm, jparams, tcfg, tlm, tparams = setup()
    toks, pos = _decode_inputs(jcfg.vocab_size)
    jview = jax_int8_prefill().decode_view()
    for t in range(STEPS):
        _, jview = jlm.decode_step(jparams, jnp.asarray(toks[t]), jview,
                                   jnp.asarray(pos[t]))
    tkv = tlm.init_cache(BATCH, MAX_SEQ, page_size=PAGE, device="cpu",
                         kv_dtype="int8")
    for slot, prompt in _prompts(jcfg.vocab_size):
        assert tkv.alloc(slot, len(prompt) + STEPS, prefix=prompt) == 0
        _, cache = tlm.forward(tparams, torch.from_numpy(prompt[None]).long(),
                               ForwardOpts(attn_impl="dense"),
                               collect_cache=True)
        dest = tkv.prefill_dest(slot, len(prompt), len(prompt))
        tkv.staged_write_prefill(tkv.quantize_block(cache["layers"]),
                                 torch.from_numpy(dest[None]))
    for t in range(STEPS):
        tlm.decode_step(tparams, torch.from_numpy(toks[t]).long(),
                        tkv.decode_view(), torch.from_numpy(pos[t]))
    tkv.verify()
    np.testing.assert_array_equal(tkv.page_table,
                                  np.asarray(jview["page_table"]))
    layers = tkv.state["layers"]
    for name in ("k_scale", "v_scale"):
        np.testing.assert_allclose(layers[name].numpy(),
                                   np.asarray(jview["layers"][name]),
                                   rtol=1e-6, atol=0)
    straddles, total = 0, 0
    for name in ("k", "v"):
        diff = np.abs(layers[name].numpy().astype(np.int32)
                      - np.asarray(jview["layers"][name]).astype(np.int32))
        assert diff.max() <= 1, f"{name}: an element moved by {diff.max()}"
        straddles += int((diff == 1).sum())
        total += diff.size
    written = sum(len(p) + STEPS for _, p in _prompts(jcfg.vocab_size)) \
        * 2 * tcfg.num_layers * tcfg.num_kv_heads * tcfg.resolved_head_dim
    assert straddles <= written // 1000, (straddles, written, total)


# ----------------------------------------------------------- engine ----

def _shared_prefix_requests(vocab, n=12, seed=29):
    """The workload of ``tests/test_kvcache_conformance.py``: two of every
    three requests extend one of two 8-token system prompts (two shareable
    pages of 4), the third is random; 3-6 new tokens each."""
    rng = np.random.default_rng(seed)
    sys_prompts = [np.arange(8, dtype=np.int32) % vocab,
                   (np.arange(8, dtype=np.int32) + 101) % vocab]
    reqs = []
    for i in range(n):
        if i % 3 == 2:
            prompt = rng.integers(0, vocab,
                                  int(rng.integers(2, 10))).astype(np.int32)
        else:
            tail = rng.integers(0, vocab,
                                int(rng.integers(1, 5))).astype(np.int32)
            prompt = np.concatenate([sys_prompts[i % 2], tail])
        reqs.append((i, prompt, int(rng.integers(3, 7))))
    return reqs


QUANT_GAUGES = ("serve_kv_quant_enabled", "serve_kv_quant_scale_bytes",
                "serve_kv_quant_bytes_saved")


@functools.lru_cache(maxsize=None)
def jax_int8_engine():
    jcfg, jlm, jparams, *_ = setup()
    eng = JServeEngine(jlm, jparams, max_batch=BATCH, max_seq=MAX_SEQ,
                       page_size=PAGE, kv_dtype="int8")
    for i, p, n in _shared_prefix_requests(jcfg.vocab_size):
        eng.submit(JRequest(i, p.copy(), max_new_tokens=n))
    out = {r.id: list(r.out_tokens) for r in eng.run_until_drained()}
    return out, {g: eng.reg.gauge(g).get() for g in QUANT_GAUGES}


@functools.lru_cache(maxsize=None)
def port_int8_engine(decode_impl, prefix_sharing=True):
    """Streams of the port's int8 engine, ``verify()`` after every step, and
    the most pages shared at once."""
    _, _, _, tcfg, tlm, tparams = setup()
    eng = ServeEngine(tlm, tparams, max_batch=BATCH, max_seq=MAX_SEQ,
                      page_size=PAGE, prefix_sharing=prefix_sharing,
                      device="cpu", kv_dtype="int8", decode_impl=decode_impl)
    for i, p, n in _shared_prefix_requests(tcfg.vocab_size):
        eng.submit(Request(i, p.copy(), max_new_tokens=n))
    shared = 0
    while eng.step() or eng.queue:
        eng.kv.verify()
        shared = max(shared, eng.kv.memory_stats().pages_shared)
    return {r.id: list(r.out_tokens) for r in eng.finished}, eng, shared


@pytest.mark.parametrize("decode_impl", ["kernel", "gather"])
def test_int8_engine_streams_and_gauges_match_jax(decode_impl):
    """The port's int8 engine against the JAX int8 engine on the shared-
    prefix workload: equal greedy streams, one fused decode dispatch per
    iteration, a pool that drains to zero, and equal quant gauges."""
    jout, jgauges = jax_int8_engine()
    out, eng, _ = port_int8_engine(decode_impl)
    assert out == jout
    reg = eng.reg
    assert reg.counter("serve_decode_dispatches_total").get() == \
        reg.counter("serve_iterations_total").get() > 0
    st = eng.kv.memory_stats()
    assert st.pages_in_use == 0 and reg.gauge("serve_kv_pages_in_use").get() \
        == 0
    assert all(r.status == "completed" for r in eng.finished)
    assert {g: reg.gauge(g).get() for g in QUANT_GAUGES} == jgauges
    assert jgauges["serve_kv_quant_enabled"] == 1
    assert jgauges["serve_kv_quant_bytes_saved"] > 0


def test_int8_engine_streams_bitwise_across_impls_and_prefix_sharing():
    """Invariants the JAX matrix asserts about itself, bitwise inside the
    port: int8 streams under "kernel" equal those under "gather", and
    streams with prefix sharing equal those without."""
    base, _, shared = port_int8_engine("kernel")
    assert shared > 0, "the workload's system prompts were never shared"
    assert port_int8_engine("gather")[0] == base
    unshared, _, none = port_int8_engine("kernel", prefix_sharing=False)
    assert none == 0
    assert unshared == base


# -------------------------------------------------------- byte math ----

@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
@pytest.mark.parametrize("width", ["reduced", "full"])
def test_byte_math_matches_jax(width, kv_dtype):
    """kv_position_bytes, page_kv_bytes and decode_transient_bytes (kernel
    = the JAX "pallas", and gather) equal the JAX functions, in fp32 and
    bf16, on the reduced and the full-width config (no allocation)."""
    jcfg, tcfg = JCONFIGS["qwen3-4b"], TCONFIGS["qwen3-4b"]
    if width == "reduced":
        jcfg, tcfg = jcfg.reduced(), tcfg.reduced()
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        assert tkvcache.kv_position_bytes(tcfg, td, kv_dtype) == \
            jkvcache.kv_position_bytes(jcfg, jd, kv_dtype)
        for page in (4, 16):
            assert tkvcache.page_kv_bytes(tcfg, page, td, kv_dtype) == \
                jkvcache.page_kv_bytes(jcfg, page, jd, kv_dtype)
            for timpl, jimpl in (("kernel", "pallas"), ("gather", "gather")):
                for batch, m in ((4, 8), (8, 32)):
                    assert tkvcache.decode_transient_bytes(
                        tcfg, batch, m, page, td, timpl, kv_dtype) == \
                        jkvcache.decode_transient_bytes(
                            jcfg, batch, m, page, jd, jimpl, kv_dtype)
    if width == "full" and kv_dtype == "int8":
        # qwen3-4b: 36 layers, 8 KV heads, head dim 128
        assert tkvcache.kv_position_bytes(tcfg, torch.bfloat16, "int8") \
            == 76_032
        assert tkvcache.kv_position_bytes(tcfg, torch.bfloat16) == 147_456


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_memory_stats_match_jax(kv_dtype):
    """memory_stats of the port's PagedCache equal the JAX cache's after
    the same allocations, shared prefix pages included."""
    jcfg, jlm, _, tcfg, tlm, _ = setup()
    jkv = jlm.init_cache(BATCH, MAX_SEQ, dtype=jnp.float32, backend="paged",
                         page_size=PAGE, kv_dtype=kv_dtype)
    tkv = tlm.init_cache(BATCH, MAX_SEQ, page_size=PAGE, device="cpu",
                         kv_dtype=kv_dtype)
    prompt = np.arange(10, dtype=np.int32)
    for slot, length in ((0, 14), (1, 20), (2, 11)):
        assert jkv.alloc(slot, length, prefix=prompt) == \
            tkv.alloc(slot, length, prefix=prompt)
    jkv.free(1)
    tkv.free(1)
    tkv.verify()
    js, ts = jkv.memory_stats(), tkv.memory_stats()
    for field in ("backend", "bytes_total", "bytes_reserved", "page_size",
                  "pages_total", "pages_in_use", "pages_shared", "kv_dtype",
                  "bytes_scales"):
        assert getattr(ts, field) == getattr(js, field), field
    assert ts.pages_shared > 0
    assert (ts.bytes_scales > 0) == (kv_dtype == "int8")


# ------------------------------------------------------------ refusal ----

def test_float_block_into_int8_pool_raises():
    """No write path casts K/V to int8: a float prefill block, a block
    without its scales and a float decode row are refused by an int8 pool,
    and an int8 row by a float pool."""
    _, _, _, tcfg, tlm, _ = setup()
    kv = tlm.init_cache(BATCH, MAX_SEQ, page_size=PAGE, device="cpu",
                        kv_dtype="int8")
    assert kv.alloc(0, 8) == 0
    dest = torch.from_numpy(kv.prefill_dest(0, 8, 8)[None])
    shape = (tcfg.num_layers, 1, 8, tcfg.num_kv_heads, tcfg.resolved_head_dim)
    block = {n: torch.randn(shape) for n in "kv"}
    with pytest.raises(ValueError, match="k_scale"):
        kv.staged_write_prefill(block, dest)
    scales = {f"{n}_scale": torch.ones(shape[:-1]) for n in "kv"}
    with pytest.raises(TypeError, match="quantize_kv"):
        kv.staged_write_prefill({**block, **scales}, dest)
    kv.staged_write_prefill(kv.quantize_block(block), dest)
    k = kv.state["layers"]["k"][0]
    table = torch.from_numpy(kv.page_table)
    positions = torch.zeros(BATCH, dtype=torch.int32)
    row = torch.randn(BATCH, 1, *k.shape[2:])
    with pytest.raises(TypeError, match="quantize_kv"):
        _scatter_paged_kv(k, row, table, positions)
    with pytest.raises(TypeError, match="quantize_kv"):
        _scatter_paged_kv(torch.zeros(k.shape), row.to(torch.int8), table,
                          positions)


# ----------------------------------------------------------- launcher ----

@pytest.mark.parametrize("decode_impl", ["kernel", "gather"])
def test_launch_serve_int8_prints_kv_quant_line(decode_impl):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--reduced", "--kv-dtype", "int8", "--decode-impl", decode_impl,
         "--requests", "4", "--max-batch", "2", "--max-seq", "32",
         "--new-tokens", "4"], capture_output=True, text=True, cwd=ROOT,
        env=env, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "served 4 requests (4 completed), 16 tokens" in res.stdout
    assert f"decode impl [{decode_impl}]" in res.stdout
    assert "kv quant [int8]:" in res.stdout
    assert "positions per byte" in res.stdout
