"""Chunked prefill in the port against the JAX package on the CPU: the
chunked allocator (``alloc_chunked``, ``extend``, ``register_landed``,
``set_decode_shield``, ``free``) step for step against the JAX cache;
``LM.prefill_chunk`` against JAX's (plen 14, chunks of 6, page 4, native
and int8 pages), the pools it writes and the decode logits that follow, and
chunked against whole-prompt pools; the chunked engine's greedy streams and
chunk, stall, skip and dispatch counters against JAX's
``ServeEngine(prefill_chunk=...)``; the decode cadence while a long prompt
lands and the tight pool it admits into; JAX's constructor refusals; two
gloo ranks over a split pool, native and int8; and the launcher's
``--prefill-chunk`` against the JAX launcher's engine.  Reduced qwen3-4b in
fp32; tolerance 2e-5.  Greedy streams go through the tie-counted helper of
``test_torch_contiguous``, and every tie count here measures 0."""
import functools
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as jserve
import repro_torch.serve as tserve
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.launch import serve as tlaunch
from repro_torch.models.params import cache_from_jax
from repro_torch.serve import PagedCache, Request, ServeEngine
from test_torch_contiguous import (ROOT, _assert_streams_match,
                                   _jax_launcher_requests, setup)
from test_torch_sharded import _env, _free_port
from test_torch_tenancy import one_torch_thread  # noqa: F401

TOL = dict(rtol=2e-5, atol=2e-5)
COUNTERS = ("serve_prefill_chunks_total", "serve_prefill_chunk_stalls_total",
            "serve_prefill_chunks_skipped_total",
            "serve_prefill_dispatches_total", "serve_prefill_tokens_total",
            "serve_decode_stall_iters", "serve_decode_dispatches_total",
            "serve_admission_deferred_total")


# ---------------------------------------------------------- allocator ----

def _caches(b=4, s=32, num_pages=8):
    jcfg, jlm, _, tcfg, _, _ = setup()
    jkv = jlm.init_cache(b, s, dtype=jnp.float32, backend="paged",
                         page_size=4, num_pages=num_pages)
    tkv = PagedCache(tcfg, b, s, page_size=4, num_pages=num_pages,
                     device="cpu", dtype=torch.float32)
    return jkv, tkv


def _same_state(jkv, tkv):
    np.testing.assert_array_equal(tkv.page_table, jkv.page_table)
    assert tkv._slot_need == jkv._slot_need
    assert tkv._slot_shared == jkv._slot_shared
    np.testing.assert_array_equal(tkv._ref, jkv._ref)
    assert tkv._hash_to_page == jkv._hash_to_page
    jkv.verify()
    tkv.verify()


PROMPT = np.arange(12, dtype=np.int32)
# (method, args): the sequences of tests/test_chunked_prefill.py's
# allocator tests, each on a fresh pair of caches
SEQUENCES = {
    "banker": [("alloc_chunked", (0, 28, 4)), ("alloc_chunked", (1, 28, 4)),
               ("alloc", (1, 8))],
    "stall_resume": [("alloc_chunked", (0, 28, 4)), ("alloc", (1, 12)),
                     ("extend", (0, 16)), ("extend", (0, 20)), ("free", (1,)),
                     ("extend", (0, 28)), ("free", (0,))],
    "shield": [("alloc", (0, 8)), ("alloc_chunked", (1, 16, 8)),
               ("set_decode_shield", (1, True)),
               ("set_decode_shield", (1, False)),
               ("set_decode_shield", (1, True)), ("free", (1,))],
    "landed": [("alloc_chunked", (0, 16, 4, PROMPT)),
               ("alloc_chunked", (1, 16, 4, PROMPT)), ("free", (1,)),
               ("register_landed", (0, PROMPT, 4)),
               ("alloc_chunked", (2, 16, 4, PROMPT)), ("free", (2,)),
               ("extend", (0, 8)), ("register_landed", (0, PROMPT, 8)),
               ("alloc_chunked", (3, 16, 4, PROMPT))],
}


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_chunked_allocator_matches_jax(name):
    """Each call returns what JAX's returns and leaves the same table,
    needs, shares, refcounts and registry; ``verify()`` passes on both.  A
    shielded row is zero in the device table, whose tensor never
    changes, and the real row stays readable through ``table_row``."""
    jkv, tkv = _caches(num_pages=16 if name in ("shield", "landed") else 8)
    table = tkv.decode_view()["page_table"]
    ptr = table.data_ptr()
    for method, args in SEQUENCES[name]:
        kw = {"prefix": args[3]} if method == "alloc_chunked" and \
            len(args) == 4 else {}
        args = args[:3] if kw else args
        got = getattr(tkv, method)(*args, **kw)
        want = getattr(jkv, method)(*args, **kw)
        assert got == want, (method, args, got, want)
        _same_state(jkv, tkv)
        view = tkv.decode_view()["page_table"]
        assert view is table and view.data_ptr() == ptr
        np.testing.assert_array_equal(
            view.numpy(), np.asarray(jkv.decode_view()["page_table"]))
        for s in range(tkv.B):
            np.testing.assert_array_equal(tkv.table_row(s), jkv.table_row(s))
            if s in tkv._shielded:
                assert not view[s].any() and tkv.table_row(s).any()
        assert tkv._shielded == jkv._shielded
    if name == "stall_resume":
        assert tkv.memory_stats().pages_in_use == 0


# -------------------------------------------------------------- model ----

def _chunk_inputs(kv, slot, done, end, chunk, prompt):
    tokens = np.zeros((1, chunk), np.int32)
    tokens[0, :end - done] = prompt[done:end]
    return (tokens, np.array([done], np.int32),
            kv.chunk_dest(slot, done, end, chunk)[None],
            np.array([end - 1], np.int32), kv.table_row(slot)[None])


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_prefill_chunk_matches_jax_and_whole_prompt(kv_dtype):
    """A 14-token prompt lands through ``LM.prefill_chunk`` in chunks of
    6, 6 and 2 (page 4) in both packages: every chunk's logits and the
    pools agree with JAX's to 2e-5 (int8 pools to one level where a value
    sits on a rounding boundary, exactly elsewhere), and so do the decode
    logits that follow.  Native: the port's chunked pools and its
    whole-prompt pools give allclose decode logits and the final chunk's
    row matches the whole forward's last row.  int8: the same against the
    whole prompt landed as one chunk; against the bucketed prefill the
    decode step moves less than int8 pages move it against native pages,
    and the greedy tokens are the same."""
    jcfg, jlm, jparams, tcfg, tlm, tparams = setup()
    s, page, plen, chunk = 32, 4, 14, 6
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, tcfg.vocab_size, plen).astype(np.int32)
    jkv = jlm.init_cache(1, s, dtype=jnp.float32, backend="paged",
                         page_size=page, kv_dtype=kv_dtype)
    tkv = PagedCache(tcfg, 1, s, page_size=page, device="cpu",
                     dtype=torch.float32, kv_dtype=kv_dtype)
    for kv in (jkv, tkv):
        assert kv.alloc_chunked(0, plen + 4, first=chunk, prefix=prompt) == 0
    done = 0
    while done < plen:
        end = min(done + chunk, plen)
        cover = plen + 4 if end == plen else end
        assert jkv.extend(0, cover) and tkv.extend(0, cover)
        tok, start, dest, last, row = _chunk_inputs(tkv, 0, done, end,
                                                    chunk, prompt)
        jl, jc = jlm.prefill_chunk(
            jparams, jnp.asarray(tok),
            {"layers": jkv.state["layers"], "page_table": jnp.asarray(row)},
            jnp.asarray(start), jnp.asarray(dest), jnp.asarray(last))
        jkv.update({**jkv.state, "layers": jc["layers"]})
        tl, _ = tlm.prefill_chunk(
            tparams, torch.from_numpy(tok).long(),
            {**tkv.state, "page_table": torch.from_numpy(row)},
            torch.from_numpy(start), torch.from_numpy(dest),
            torch.from_numpy(last))
        assert tl.shape == (1, 1, tcfg.padded_vocab)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        done = end
    last_row = tl[0, -1, :tcfg.vocab_size]
    jpools = cache_from_jax(jax.tree.map(np.asarray, jkv.decode_view()),
                            device="cpu")["layers"]
    for name, pool in tkv.state["layers"].items():
        want = jpools[name]
        if pool.dtype == torch.int8:
            diff = (pool.int() - want.int()).abs()
            assert int(diff.max()) <= 1 and float(
                (diff > 0).float().mean()) < 1e-3, name
        else:
            np.testing.assert_allclose(pool.numpy(), want.numpy(), **TOL)
    # the decode logits that follow, over each package's own pools
    tok = rng.integers(0, tcfg.vocab_size, (1, 1))
    pos = np.array([plen], np.int32)
    jd, _ = jlm.decode_step(jparams, jnp.asarray(tok, jnp.int32),
                            jkv.decode_view(), jnp.asarray(pos))
    td, _ = tlm.decode_step(tparams, torch.from_numpy(tok).long(),
                            tkv.decode_view(), torch.from_numpy(pos))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), **TOL)
    # chunked against whole-prompt pools, in the port
    wd, wrow = _whole_prompt_decode(tlm, tparams, prompt, s, kv_dtype, tok)
    if kv_dtype == "native":
        torch.testing.assert_close(last_row, wrow, **TOL)
        torch.testing.assert_close(td, wd, **TOL)
        return
    # over int8 pages a chunk reads its earlier chunks' rows, and its own,
    # back from int8 (in JAX too) where the whole forward attends the float
    # K/V: the whole prompt landed as one chunk is the like-for-like
    # reference.  Against the bucketed prefill the decode step moves no
    # more than int8 pages move it against native pages, and greedy agrees
    one = PagedCache(tcfg, 1, s, page_size=page, device="cpu",
                     dtype=torch.float32, kv_dtype=kv_dtype)
    assert one.alloc_chunked(0, plen + 4, first=plen, prefix=prompt) == 0
    assert one.extend(0, plen + 4)
    tok1, start, dest, last, row = _chunk_inputs(one, 0, 0, plen, plen,
                                                 prompt)
    ol, _ = tlm.prefill_chunk(
        tparams, torch.from_numpy(tok1).long(),
        {**one.state, "page_table": torch.from_numpy(row)},
        torch.from_numpy(start), torch.from_numpy(dest),
        torch.from_numpy(last))
    od, _ = tlm.decode_step(tparams, torch.from_numpy(tok).long(),
                            one.decode_view(), torch.from_numpy(pos))
    torch.testing.assert_close(last_row, ol[0, -1, :tcfg.vocab_size], **TOL)
    torch.testing.assert_close(td, od, **TOL)
    nd, _ = _whole_prompt_decode(tlm, tparams, prompt, s, "native", tok)
    assert 0 < _rel(td, wd) <= _rel(wd, nd)
    assert int(td.argmax()) == int(wd.argmax())
    assert int(last_row.argmax()) == int(wrow.argmax())


def _rel(a, b) -> float:
    """max |a - b| over max |b|."""
    return float((a - b).abs().max() / b.abs().max())


def _whole_prompt_decode(tlm, tparams, prompt, s, kv_dtype, tok):
    """Whole-prompt prefill of ``prompt`` into a fresh paged cache, then
    one decode step of ``tok``: (decode logits, the forward's last row)."""
    cfg, plen = tlm.cfg, len(prompt)
    kv = PagedCache(cfg, 1, s, page_size=4, device="cpu",
                    dtype=torch.float32, kv_dtype=kv_dtype)
    assert kv.alloc(0, plen + 4, prefix=prompt) == 0
    full, cache = tlm.forward(tparams, torch.from_numpy(prompt)[None].long(),
                              collect_cache=True)
    kv.staged_write_prefill(kv.quantize_block(cache["layers"]),
                            torch.from_numpy(
                                kv.prefill_dest(0, plen, plen)[None]))
    d, _ = tlm.decode_step(tparams, torch.from_numpy(tok).long(),
                           kv.decode_view(),
                           torch.tensor([plen], dtype=torch.int32))
    return d, full[0, -1, :cfg.vocab_size]


def test_prefill_chunk_refuses_recurrent_families():
    from repro_torch.configs import get_config
    from repro_torch.models import LM
    lm = LM(get_config("rwkv6-1.6b").reduced())
    with pytest.raises(ValueError, match="dense-FFN attention-cache"):
        lm.prefill_chunk(None, None, {"layers": {}, "page_table": None},
                         None, None, None)


# ------------------------------------------------------------- engine ----

def _traffic(vocab):
    """Shared-prefix traffic (``_workload``'s shape): 8 prompts of 5-20
    tokens, every other one opening with the same 8-token prefix (two
    pages of 4), then a 20-token prompt submitted at iteration 3."""
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, vocab, 8)
    out = []
    for i in range(8):
        plen = int(rng.integers(5, 15))
        prompt = rng.integers(0, vocab, plen)
        if i % 2 == 0:
            prompt = np.concatenate([prefix, prompt[:max(plen - 8, 1)]])
        out.append((0, i, prompt.astype(np.int32), int(rng.integers(4, 8))))
    out.append((3, 8, rng.integers(0, vocab, 20).astype(np.int32), 5))
    return out


def _tight(vocab):
    """Two shorts hold 6 of a 7-page pool; a 24-token prompt (7 pages)
    arrives at iteration 2: its first chunk fits, the rest stalls until
    the shorts complete."""
    rng = np.random.default_rng(3)
    return ([(0, i, rng.integers(0, vocab, 4).astype(np.int32), 6)
             for i in range(2)]
            + [(2, 9, rng.integers(0, vocab, 24).astype(np.int32), 4)])


# workload -> (traffic, engine keywords both packages take)
ENGINES = {
    "shared": (_traffic, dict(max_batch=4, max_seq=32, page_size=4,
                              num_pages=24, prefill_chunk=4,
                              prefill_budget=8)),
    "int8": (_traffic, dict(max_batch=4, max_seq=32, page_size=4,
                            num_pages=24, prefill_chunk=6,
                            kv_dtype="int8")),
    "tight": (_tight, dict(max_batch=4, max_seq=32, page_size=4,
                           num_pages=8, prefill_chunk=4)),
}


def _drive(eng, make, traffic):
    """Submit each request at its iteration, step until drained; returns
    the streams and the counters."""
    pending = list(traffic)
    for it in range(300):
        for item in [x for x in pending if x[0] <= it]:
            pending.remove(item)
            _, i, prompt, new = item
            eng.submit(make(i, prompt.copy(), max_new_tokens=new))
        if not eng.step() and not eng.queue and not pending:
            break
    streams = {r.id: list(r.out_tokens) for r in eng.finished}
    assert len(streams) == len(traffic)
    return streams, {c: eng.reg.counter(c).get() for c in COUNTERS}


@functools.lru_cache(maxsize=None)
def _jax_run(name):
    jcfg, jlm, jparams, _, _, _ = setup()
    traffic, kw = ENGINES[name]
    eng = JServeEngine(jlm, jparams, cache_backend="paged", **kw)
    return _drive(eng, JRequest, traffic(jcfg.vocab_size))


@functools.lru_cache(maxsize=None)
def _port_run(name):
    _, _, _, tcfg, tlm, tparams = setup()
    traffic, kw = ENGINES[name]
    eng = ServeEngine(tlm, tparams, device="cpu", **kw)
    streams, counters = _drive(eng, Request, traffic(tcfg.vocab_size))
    eng.kv.verify()
    assert eng.kv.memory_stats().pages_in_use == 0 and not eng.prefilling
    return streams, counters


@pytest.mark.parametrize("name", list(ENGINES))
def test_chunked_engine_matches_jax(name):
    """The port's chunked engine and JAX's on the same weights and traffic:
    equal greedy streams (tie-counted: 0), and equal chunk, stall, skip,
    dispatch, token, decode-stall and deferral counters.  The shared
    workload skips covered chunks, the tight one stalls chunks."""
    _, _, _, tcfg, tlm, tparams = setup()
    got, gc = _port_run(name)
    exp, jc = _jax_run(name)
    assert gc == jc, (gc, jc)
    prompts = {i: p for _, i, p, _ in ENGINES[name][0](tcfg.vocab_size)}
    ties = _assert_streams_match(tlm, tparams, prompts, got, exp)
    print(f"{name}: {ties} streams equal only by the tie rule")
    assert ties == 0
    assert gc["serve_decode_stall_iters"] == 0
    assert gc["serve_prefill_chunks_total"] > 0
    if name == "shared":
        assert gc["serve_prefill_chunks_skipped_total"] > 0
    if name == "tight":
        assert gc["serve_prefill_chunk_stalls_total"] > 0
        assert gc["serve_admission_deferred_total"] == 0


def test_long_admission_never_stalls_decode_streams():
    """While a 33-token prompt lands in chunks of 8, every live stream
    emits one token every iteration (``serve_decode_stall_iters`` 0, 7
    chunks in all); the whole-prompt engine stalls them and gives the same
    streams (the port's form of tests/test_chunked_prefill.py:96)."""
    _, _, _, tcfg, tlm, tparams = setup()
    rng = np.random.default_rng(11)
    shorts = [rng.integers(0, tcfg.vocab_size, 5).astype(np.int32)
              for _ in range(2)]
    long_p = rng.integers(0, tcfg.vocab_size, 33).astype(np.int32)

    def seeded(**kw):
        eng = ServeEngine(tlm, tparams, max_batch=4, max_seq=64, page_size=8,
                          device="cpu", **kw)
        for i, p in enumerate(shorts):
            eng.submit(Request(i, p.copy(), max_new_tokens=20))
        eng.step()
        eng.step()
        eng.submit(Request(9, long_p.copy(), max_new_tokens=4))
        return eng

    eng = seeded(prefill_chunk=8)
    for _ in range(40):
        before = {i: len(eng.slot_req[i].out_tokens) for i in range(eng.B)
                  if eng.slot_req[i] is not None and eng.active[i]}
        eng.step()
        for i, n in before.items():
            assert len(eng.slot_req[i].out_tokens) == n + 1, i
        if any(r is not None and r.id == 9 and eng.active[i]
               for i, r in enumerate(eng.slot_req)):
            break
    else:
        raise AssertionError("the long prompt never finished its chunks")
    assert eng.reg.counter("serve_prefill_chunks_total").get() == 7
    assert eng.reg.counter("serve_decode_stall_iters").get() == 0
    eng.run_until_drained()
    whole = seeded()
    whole.run_until_drained()
    assert whole.reg.counter("serve_decode_stall_iters").get() >= 1
    streams = {r.id: r.out_tokens for r in eng.finished}
    assert len(streams) == 3
    assert streams == {r.id: r.out_tokens for r in whole.finished}


def test_tight_pool_admits_what_whole_prompt_defers():
    """The port's form of tests/test_chunked_prefill.py:147: the chunked
    engine admits the long prompt at once and stalls its chunks, the
    whole-prompt engine defers it, and both give the contiguous cache's
    streams."""
    _, _, _, tcfg, tlm, tparams = setup()
    traffic = _tight(tcfg.vocab_size)
    kw = ENGINES["tight"][1]
    chunked, cc = _port_run("tight")
    whole, wc = _drive(ServeEngine(tlm, tparams, device="cpu",
                                   **{**kw, "prefill_chunk": 0}),
                       Request, traffic)
    contig, _ = _drive(ServeEngine(tlm, tparams, max_batch=4, max_seq=32,
                                   device="cpu", cache_backend="contiguous"),
                       Request, traffic)
    assert cc["serve_admission_deferred_total"] == 0
    assert cc["serve_prefill_chunk_stalls_total"] > 0
    assert wc["serve_admission_deferred_total"] > 0
    assert chunked == whole == contig


def test_chunked_engine_refusals_match_jax():
    """JAX's constructor refusals, with its messages, chunked and for
    ``tenancy=``/``fault_plan=`` against the backend; the fault keywords
    and the host tier are served chunked; an unknown keyword is a
    ``TypeError``."""
    _, jlm, jparams, _, tlm, tparams = setup()
    cases = [(dict(cache_backend="contiguous", prefill_chunk=8),
              "page-aware"),
             (dict(cache_backend="paged", prefill_chunk=8,
                   prefill_budget=4), "below one chunk"),
             (dict(cache_backend="paged", prefill_budget=16),
              "prefill_chunk")]
    for kw, match in cases:
        msgs = []
        for make in (lambda: JServeEngine(jlm, jparams, 2, 32, **kw),
                     lambda: ServeEngine(tlm, tparams, 2, 32, device="cpu",
                                         **kw)):
            with pytest.raises(ValueError, match=match) as e:
                make()
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    cases = [(dict(cache_backend="contiguous"),
              lambda m: m.TenancyConfig([m.TenantSpec("chat", "interactive"),
                                         m.TenantSpec("bulk", "batch", 4)]),
              None, "quota"),
             (dict(cache_backend="contiguous"),
              lambda m: m.TenancyConfig([m.TenantSpec("bulk", "batch")]),
              None, "preemption"),
             (dict(cache_backend="paged", prefill_chunk=8),
              lambda m: m.TenancyConfig(
                  [m.TenantSpec("bulk", "batch")], classes={
                      "batch": m.PriorityClass("batch", 0,
                                               prefill_budget=4)}),
              None, "prefill_budget"),
             (dict(cache_backend="contiguous"), None,
              lambda m: m.FaultPlan([m.FaultEvent(1, "poison_page"),
                                     m.FaultEvent(2, "stall_chunk")]),
              "paged")]
    for kw, ten, plan, match in cases:
        msgs = []
        for mod, make in ((jserve, lambda **k: JServeEngine(
                jlm, jparams, 2, 32, **kw, **k)),
                          (tserve, lambda **k: ServeEngine(
                              tlm, tparams, 2, 32, device="cpu", **kw,
                              **k))):
            with pytest.raises(ValueError, match=match) as e:
                make(tenancy=ten(mod) if ten else None,
                     fault_plan=plan(mod) if plan else None)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    # the fault and watchdog keywords are served now, chunked too
    eng = ServeEngine(tlm, tparams, 2, 32, device="cpu", prefill_chunk=8,
                      watchdog_iters=4,
                      fault_plan=tserve.FaultPlan.parse("stall_chunk@1"))
    assert (eng.watchdog_iters, len(eng.fault_plan)) == (4, 1)
    # and so is the host tier, chunked too
    eng = ServeEngine(tlm, tparams, 2, 32, device="cpu", prefill_chunk=8,
                      host_pages=8)
    assert eng.kv.store.capacity == 8 and eng.chunk == 8
    with pytest.raises(TypeError, match="mesh"):
        ServeEngine(tlm, tparams, 2, 32, device="cpu", mesh=object())


# ------------------------------------------------------------ sharded ----

RANK = """
import json, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.models import LM
from repro_torch.parallel import PoolGroup
from repro_torch.serve import Request, ServeEngine
rank, n, port, params_path = (int(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
work = json.loads(sys.argv[5])
dist.init_process_group('gloo', init_method=f'tcp://localhost:{port}',
                        rank=rank, world_size=n)
group = PoolGroup.of()
params, cfg = torch.load(params_path, weights_only=False)
lm = LM(cfg)
out = {}
for name, (traffic, kw) in work.items():
    eng = ServeEngine(lm, params, device='cpu', pool_group=group, **kw)
    pending = list(traffic)
    for it in range(300):
        for item in [x for x in pending if x[0] <= it]:
            pending.remove(item)
            eng.submit(Request(item[1], np.asarray(item[2], np.int32),
                               max_new_tokens=item[3]))
        if not eng.step() and not eng.queue and not pending:
            break
    eng._check_ranks_agree()
    eng.kv.verify()
    assert eng.kv.memory_stats().pages_in_use == 0
    out[name] = {'streams': {r.id: r.out_tokens for r in eng.finished},
                 'chunks': eng.reg.counter('serve_prefill_chunks_total').get()}
dist.destroy_process_group()
print('STREAMS ' + json.dumps(out))
"""


def test_gloo_ranks_chunked_match_single_rank_and_jax(tmp_path):
    """Two gloo ranks serve the shared and int8 chunked workloads over a
    pool split in two: each chunk writes into the owning rank's shard and
    merges the ranks' C-row partials.  Both ranks' streams and chunk
    counts equal the single-rank port's and JAX's."""
    _, _, _, tcfg, _, tparams = setup()
    params_path = tmp_path / "params.pt"
    torch.save((tparams, tcfg), params_path)
    work = {name: ([(t, i, p.tolist(), k)
                    for t, i, p, k in ENGINES[name][0](tcfg.vocab_size)],
                   ENGINES[name][1]) for name in ("shared", "int8")}
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), "2", str(port),
         str(params_path), json.dumps(work)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=_env(), cwd=ROOT)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    results = [json.loads(next(line for line in out.splitlines()
                               if line.startswith("STREAMS "))[8:])
               for out, _ in outs]
    assert results[0] == results[1]
    for name, res in results[0].items():
        streams = {int(i): s for i, s in res["streams"].items()}
        single, counters = _port_run(name)
        assert streams == single == _jax_run(name)[0], name
        assert res["chunks"] == counters["serve_prefill_chunks_total"]


# ----------------------------------------------------------- launcher ----

def test_launcher_prefill_chunk_matches_jax_engine(capsys):
    """``repro_torch.launch.serve --device cpu --prefill-chunk 8`` on the
    JAX launcher's weights and the JAX engine with the JAX launcher's
    defaults and ``prefill_chunk=8`` emit the same greedy streams
    (tie-counted: 0) and chunk counts; the summary prints the chunk line."""
    jcfg, jlm, jparams, _, tlm, tparams = setup()
    args = tlaunch.parse_args(["--device", "cpu", "--prefill-chunk", "8"])
    assert (args.prefill_chunk, args.prefill_budget) == (8, 0)
    jreqs = _jax_launcher_requests(16, jcfg.vocab_size, 16)
    jeng = JServeEngine(jlm, jparams, 4, 128, cache_backend="paged",
                        prefill_chunk=8)
    for r in jreqs:
        jeng.submit(r)
    exp = {r.id: r.out_tokens for r in jeng.run_until_drained()}
    eng = tlaunch.serve(args, None, "cpu", params=tparams)
    out = capsys.readouterr().out
    chunks = eng.reg.counter("serve_prefill_chunks_total").get()
    assert chunks == jeng.reg.counter("serve_prefill_chunks_total").get()
    assert (f"chunked prefill [8 tok/chunk, budget 8]: {chunks:.0f} chunks, "
            "0 page-grant stalls, decode stall iters=0") in out
    assert "fully-shared chunks skipped their forward" in out
    got = {r.id: r.out_tokens for r in eng.finished}
    ties = _assert_streams_match(tlm, tparams,
                                 {r.id: r.prompt for r in jreqs}, got, exp)
    print(f"launcher --prefill-chunk 8: {ties} streams equal only by the "
          "tie rule")
    assert ties == 0


def test_launch_serve_mesh_2_prefill_chunk_under_torchrun():
    """``--mesh 2 --prefill-chunk 4`` under ``torch.distributed.run`` on
    the CPU: every request completes and rank 0 prints the chunk line."""
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-port", str(_free_port()), "-m",
         "repro_torch.launch.serve", "--device", "cpu", "--reduced",
         "--mesh", "2", "--requests", "4", "--max-batch", "2", "--max-seq",
         "32", "--new-tokens", "4", "--prefill-chunk", "4",
         "--prefill-budget", "8"],
        capture_output=True, text=True, cwd=ROOT, env=_env(), timeout=240)
    assert res.returncode == 0, res.stderr
    assert res.stdout.count("served 4 requests (4 completed), 16 tokens") == 1
    assert "chunked prefill [4 tok/chunk, budget 8]: " in res.stdout
    assert "decode stall iters=0" in res.stdout
