"""The port's host-RAM page tier and persistent prefix store
(``repro_torch.serve.offload``; ``PagedCache``/``ServeEngine``
``host_pages=``/``prefix_store=``) against the JAX package on the CPU: the
same random op stream through both ``PrefixStore``s at capacities 2-8, also
with a 1-byte digest (stats, key order and payload bytes equal); the cache
after an offload and a prefetch (allocations, tables, store stats, fp32
logits, native and int8); engine streams and the host-tier counters, whole
and chunked, native and int8, and through a tight pool split into two
chips; the 10x working-set soak; the three host-tier fault cases of the
JAX serve-fault suite; the view hazard (a freed page claimed and rewritten
before the drain must still offload its first content); and the launcher's
``--host-pages``/``--prefix-store`` against the JAX launcher.  The 2-layer
reduced llama3.2-3b of ``test_torch_tenancy`` (the launcher: the JAX
launcher's reduced qwen3-4b), fp32, logits held to 2e-5."""
import contextlib
import io
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as jserve
import repro_torch.serve as tserve
from repro.launch import serve as jlaunch
from repro.serve.offload import HostTierError as JHostTierError
from repro_torch.launch import serve as tlaunch
from repro_torch.serve.offload import HostTierError
from test_torch_contiguous import setup as launcher_setup
from test_torch_gpu import _chip_smoke
from test_torch_tenancy import (MODS, engine, model,  # noqa: F401
                                one_torch_thread, outcome)

TOL = dict(rtol=2e-5, atol=2e-5)
HOST_COUNTERS = ("serve_prefix_store_hits_total",
                 "serve_prefix_store_misses_total",
                 "serve_host_evictions_total",
                 "serve_host_offload_bytes_total",
                 "serve_host_prefetch_bytes_total",
                 "serve_prefill_chunks_skipped_total")


def host_metrics(eng):
    """The five host-tier counters, the chunk skips and the residency
    gauge: what the two engines must agree on."""
    out = {c: eng.reg.counter(c).get() for c in HOST_COUNTERS}
    out["serve_host_pages_in_use"] = eng.reg.gauge(
        "serve_host_pages_in_use").get()
    return out


# ------------------------------------------------------------- store ----

SPEC = {"k": ((2, 3), "float32"), "q": ((2, 3), "int8"),
        "s": ((2,), "float32")}


def _stores(cap, digest):
    """A JAX and a port store of ``cap`` pages over SPEC with a ``digest``
    byte index; digest 0 maps every key to one index entry."""
    class J(jserve.PrefixStore):
        digest_size = digest or 16

        def _digest(self, key):
            return super()._digest(key) if digest else b"\x00"

    class T(tserve.PrefixStore):
        digest_size = digest or 16

        def _digest(self, key):
            return super()._digest(key) if digest else b"\x00"

    js, ts = J(cap), T(cap)
    js.bind({n: (s, np.dtype(d)) for n, (s, d) in SPEC.items()})
    ts.bind({n: (s, getattr(torch, d)) for n, (s, d) in SPEC.items()})
    return js, ts


def _same_payload(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        assert set(a) == set(b)
        for name in a:
            assert np.asarray(a[name]).tobytes() == b[name].numpy().tobytes()


@pytest.mark.parametrize("digest", [16, 1])
@pytest.mark.parametrize("cap", [2, 5, 8])
def test_prefix_store_matches_jax_on_random_ops(cap, digest):
    """400 seeded ops (put, lookup, quarantine, poison, drop, touch, has)
    over 12 keys through JAX's store and the port's: after every op the
    stats, the key order (LRU) and the op's result are equal, both stores
    verify, and a lookup returns the same payload bytes (NaN from a poison
    included).  A 1-byte digest makes most keys collide."""
    js, ts = _stores(cap, digest)
    rng = np.random.default_rng(100 * cap + digest)
    keys = [bytes([i]) * (i + 1) for i in range(12)]
    ops = ("put", "put", "lookup", "lookup", "quarantine", "poison", "drop",
           "touch", "has")
    for step in range(400):
        op, key = ops[rng.integers(len(ops))], keys[rng.integers(12)]
        if op == "put":
            payload = {n: (rng.normal(size=s) * 50).astype(d)
                       for n, (s, d) in SPEC.items()}
            js.put(key, payload)
            ts.put(key, payload)
        elif op == "lookup":
            _same_payload(js.lookup(key), ts.lookup(key))
        else:
            assert getattr(js, op)(key) == getattr(ts, op)(key), (step, op)
        assert ts.stats() == js.stats(), (step, op)
        assert ts.keys() == js.keys(), (step, op)
        js.verify()
        ts.verify()
    assert ts.pages_in_use() == js.pages_in_use() <= cap
    assert ts.bytes_in_use() == js.bytes_in_use()
    for key in js.keys():
        _same_payload(js.lookup(key), ts.lookup(key))
    stats = ts.stats()
    assert stats["hits"] and stats["evictions"] and stats["poisoned"]
    if digest == 1:
        assert stats["collisions"]


def test_prefix_store_refusals_and_collisions_match_jax():
    """A second bind with another page format raises in both with the same
    text (up to the dtype names); the JAX fault suite's collision pin: a
    colliding lookup is a miss, a colliding put replaces; ``verify`` finds
    a store whose entries and slots disagree."""
    js, ts = _stores(4, 16)
    with pytest.raises(JHostTierError) as je:
        js.bind({"k": ((2, 4), np.dtype("float32"))})
    with pytest.raises(HostTierError) as te:
        ts.bind({"k": ((2, 4), torch.float32)})
    for e in (je, te):
        assert str(e.value).startswith(
            "host tier bound to a different page format: ")
        assert str(e.value).endswith(
            "(a persistent prefix store is reusable only across caches "
            "with identical page shape/dtype)")
    js, ts = _stores(8, 0)
    a, b = b"prefix-a", b"prefix-b"
    pay = {n: np.ones(s, d) for n, (s, d) in SPEC.items()}
    for s in (js, ts):
        s.put(a, pay)
        assert s.lookup(b) is None
        s.put(b, {n: v * 2 for n, v in pay.items()})
        assert s.lookup(a) is None
        assert float(np.asarray(s.lookup(b)["k"])[0, 0]) == 2.0
        s.verify()
    assert ts.stats() == js.stats() and ts.stats()["collisions"] == 3
    ts.tier._used.add(7)
    with pytest.raises(HostTierError, match="used-slots disagree"):
        ts.verify()


# ------------------------------------------------------------- cache ----

@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32",
                                   "float64"])
def test_payload_finite_check_equals_isfinite(dtype):
    """The prefetch's finite check (exponent bits on an integer view)
    agrees with ``torch.isfinite`` on payloads with NaN, +-Inf, the
    largest and smallest finite values and subnormals, one at a time, and
    an int8 payload is never checked."""
    dt = getattr(torch, dtype)
    info = torch.finfo(dt)
    specials = [float("nan"), float("inf"), -float("inf"), info.max,
                -info.max, info.tiny, info.tiny / 4, 0.0, -0.0, 1.5]
    rng = np.random.default_rng(0)
    for v in specials:
        a = torch.from_numpy(rng.normal(size=(3, 4, 5))).to(dt)
        a[1, 2, 3] = v
        payload = {"k": a, "q": torch.zeros(3, dtype=torch.int8)}
        assert tserve.PagedCache._payload_finite(payload) == \
            bool(torch.isfinite(a).all()), v


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_cache_prefetch_matches_jax(kv_dtype):
    """The JAX conformance suite's eight slots at eight depths (page 8):
    both caches prefill the prompts (each its own forward) and decode one
    step, then free every slot (the full prompt pages offload), re-admit
    the same prompts (host hits, prefetched into fresh pages) and decode
    again.  Allocation returns, page tables, store stats and keys are
    equal; the port's logits are within 2e-5 of JAX's and, after the
    round trip, bitwise its own first ones (int8: rows and scales come back
    byte for byte)."""
    jcfg, jlm, jparams, tlm, tparams = model()
    B, S, pg = 8, 32, 8
    rng = np.random.default_rng(7)
    lens = [3, 11, 7, 1, 14, 5, 9, 2]
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
               for n in lens]
    jkv = jlm.init_cache(B, S, dtype=jnp.float32, backend="paged",
                         page_size=pg, kv_dtype=kv_dtype, host_pages=16)
    tkv = tlm.init_cache(B, S, page_size=pg, device="cpu",
                         kv_dtype=kv_dtype, host_pages=16)
    jblocks, tblocks = [], []

    def write(b, prompt, shared):
        dest = tkv.prefill_dest(b, len(prompt), len(prompt), shared)
        tkv.staged_write_prefill(tkv.quantize_block(tblocks[b]),
                                 torch.from_numpy(dest[None]))
        jkv.write_prefill(b, jblocks[b])

    # one forward of the prompts padded to 16 (causal: a prompt's K/V do
    # not see the padding after it), each slot's block cut to its prompt
    tokens = np.zeros((B, 16), np.int32)
    for b, prompt in enumerate(prompts):
        tokens[b, :len(prompt)] = prompt
    _, _, pc = jlm.forward(jparams, {"tokens": jnp.asarray(tokens)},
                           collect_cache=True)
    _, cache = tlm.forward(tparams, torch.from_numpy(tokens).long(),
                           collect_cache=True)
    for b, prompt in enumerate(prompts):
        assert tkv.alloc(b, len(prompt) + 4, prefix=prompt) == \
            jkv.alloc(b, len(prompt) + 4, prefix=prompt) == 0
        n = len(prompt)
        jblocks.append({k: v[:, b:b + 1, :n] for k, v in pc["layers"].items()})
        tblocks.append({k: v[:, b:b + 1, :n]
                        for k, v in cache["layers"].items()})
        write(b, prompt, 0)
    toks = rng.integers(0, jcfg.vocab_size, (B, 1))
    pos = np.array(lens, np.int32)

    def decode():
        lj, _ = jlm.decode_step(jparams, jnp.asarray(toks, jnp.int32),
                                jkv.decode_view(), jnp.asarray(pos))
        lt, _ = tlm.decode_step(tparams, torch.from_numpy(toks).long(),
                                tkv.decode_view(), torch.from_numpy(pos))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        return lt

    first = decode()
    for b in range(B):
        jkv.free(b)
        tkv.free(b)
    jkv.drain_offloads()
    tkv.drain_offloads()
    assert tkv.store.pages_in_use() == sum(n // pg for n in lens) == 3
    assert tkv.store.stats() == jkv.store.stats()
    assert tkv.store.keys() == jkv.store.keys()
    for b, prompt in enumerate(prompts):
        got = tkv.alloc(b, len(prompt) + 4, prefix=prompt)
        assert got == jkv.alloc(b, len(prompt) + 4, prefix=prompt) == \
            (len(prompt) // pg) * pg
        write(b, prompt, got)
    np.testing.assert_array_equal(tkv.page_table, jkv.page_table)
    assert tkv.store.stats() == jkv.store.stats()
    assert tkv.store.stats()["prefetch_bytes"] == 3 * tkv.store.tier.page_bytes
    again = decode()
    assert torch.equal(first, again)
    tkv.verify()
    st, jst = tkv.memory_stats(), jkv.memory_stats()
    for name in ("host_pages_total", "host_pages_in_use", "host_bytes",
                 "bytes_total", "pages_in_use"):
        assert getattr(st, name) == getattr(jst, name), name


def test_cache_host_tier_refusals_match_jax():
    """The tier needs prefix sharing (the same assertion) and the paged
    backend (the JAX contiguous factory's ``ValueError``, word for word);
    the store is bound to the page format of its first cache."""
    jcfg, jlm, _, tlm, _ = model()
    for make in (lambda **k: jlm.init_cache(2, 16, backend="paged", **k),
                 lambda **k: tlm.init_cache(2, 16, device="cpu", **k)):
        with pytest.raises(AssertionError, match="prefix_sharing=True"):
            make(host_pages=4, prefix_sharing=False)
    msgs = []
    for make in (lambda: jlm.init_cache(2, 16, backend="contiguous",
                                        host_pages=4),
                 lambda: tlm.init_cache(2, 16, backend="contiguous",
                                        device="cpu", host_pages=4)):
        with pytest.raises(ValueError) as e:
            make()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    store = tserve.PrefixStore(4)
    tlm.init_cache(2, 16, page_size=4, device="cpu", prefix_store=store)
    with pytest.raises(HostTierError, match="different page format"):
        tlm.init_cache(2, 16, page_size=8, device="cpu", prefix_store=store)


# ------------------------------------------------------------ engine ----

def _shared_prefix_requests(vocab, n=12, seed=29):
    """The JAX conformance suite's workload: two of every three requests
    extend one of two 8-token system prompts (two full pages at page 4),
    the third is random; staggered lifetimes make some admissions share a
    live prefix and others hit it in the host tier."""
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


def _serve(mod, reqs, **kw):
    eng = engine(mod, max_batch=4, max_seq=32, page_size=4, **kw)
    for i, p, n in reqs:
        eng.submit(mod.Request(i, p.copy(), max_new_tokens=n))
    return outcome(eng.run_until_drained()), eng


ENGINE_CASES = [
    pytest.param(dict(kv_dtype=kv, host_pages=32, prefill_chunk=chunk),
                 id=f"{kv}-{'chunked' if chunk else 'whole'}")
    for kv in ("native", "int8") for chunk in (0, 4)
] + [pytest.param(dict(host_pages=24, num_pages=10, locality_chips=2),
                  id="tight-chips2")]


@pytest.mark.parametrize("kw", ENGINE_CASES)
def test_engine_host_tier_matches_jax(kw):
    """The JAX conformance matrix's host-tier rows with ``verify_cache``:
    the port's engine and the JAX engine emit the same streams and
    statuses, the store's stats and keys are equal, so are the five
    host-tier counters, ``serve_prefill_chunks_skipped_total`` and the
    residency gauge; offloads and hits happened, one decode dispatch an
    iteration, and the pool drains to zero (the tight pool also defers)."""
    reqs = _shared_prefix_requests(512)
    (jout, jeng), (tout, teng) = [_serve(mod, reqs, verify_cache=True, **kw)
                                  for mod in MODS]
    assert tout == jout
    assert teng.kv.store.stats() == jeng.kv.store.stats()
    assert teng.kv.store.keys() == jeng.kv.store.keys()
    assert host_metrics(teng) == host_metrics(jeng)
    stats = teng.kv.store.stats()
    assert stats["offloads"] > 0 and stats["hits"] > 0
    assert teng.reg.counter("serve_decode_dispatches_total").get() == \
        teng.reg.counter("serve_iterations_total").get()
    st = teng.kv.memory_stats()
    assert st.pages_in_use == 0 and st.slots_in_use == 0
    assert 0 < st.host_pages_in_use <= kw["host_pages"]
    if kw.get("prefill_chunk"):
        assert teng.reg.counter(
            "serve_prefill_chunks_skipped_total").get() > 0
    if kw.get("num_pages"):
        assert teng.reg.counter("serve_admission_deferred_total").get() > 0
        assert st.mesh_chips == 2


def test_soak_working_set_10x_pool_matches_jax():
    """The JAX 10x working-set soak: 20 distinct 12-token prefixes (60
    prefix pages) revisited through a 6-usable-page pool with a 64-page
    tier, requests arriving over 120 iterations.  The port's streams equal
    the JAX engine's, ``serve_kv_pages_in_use`` never exceeds the pool and
    ends at 0, the store's stats and keys are JAX's, and the working set
    really is 10x the pool."""
    rng = np.random.default_rng(53)
    n_prefix = 20
    prefixes = [rng.integers(0, 512, 12).astype(np.int32)
                for _ in range(n_prefix)]
    reqs = []
    for i in range(2 * n_prefix):
        tail = rng.integers(0, 512, int(rng.integers(1, 3))).astype(np.int32)
        reqs.append((i, np.concatenate([prefixes[i % n_prefix], tail]),
                     int(rng.integers(2, 5))))
    arrivals: dict = {}
    for idx in rng.permutation(len(reqs)):
        arrivals.setdefault(int(rng.integers(0, 120)), []).append(reqs[idx])
    engs = []
    for mod in MODS:
        eng = engine(mod, max_batch=4, max_seq=32, page_size=4, num_pages=7,
                     host_pages=64)
        total = eng.kv.memory_stats().pages_total
        gauge = eng.reg.gauge("serve_kv_pages_in_use")
        for step in range(400):
            for i, p, n in arrivals.get(step, []):
                eng.submit(mod.Request(i, p.copy(), max_new_tokens=n))
            eng.step()
            assert 0 <= gauge.get() <= total, step
        eng.run_until_drained(max_iters=2000)
        engs.append(eng)
    jeng, teng = engs
    assert outcome(teng.finished) == outcome(jeng.finished)
    assert len(teng.finished) == len(reqs)
    assert teng.kv.store.stats() == jeng.kv.store.stats()
    assert teng.kv.store.keys() == jeng.kv.store.keys()
    assert host_metrics(teng) == host_metrics(jeng)
    st = teng.kv.memory_stats()
    assert st.pages_in_use == 0 and gauge.get() == 0
    assert n_prefix * 3 >= 10 * st.pages_total
    assert teng.kv.store.stats()["hits"] > 0
    teng.kv.verify()


# ------------------------------------------------------------ faults ----

def _fault_engine(mod, **kw):
    return engine(mod, max_batch=4, max_seq=64, page_size=4, num_pages=33,
                  **kw)


def test_host_poisoned_page_quarantined_at_prefetch():
    """A poisoned host-resident prefix page (NaN payload) is caught by the
    prefetch's finite check before it is registered: quarantined, the
    prefix recomputed, streams those of an engine without a tier; the
    store's stats and the clean bytes re-offloaded afterwards are JAX's
    outcome."""
    prefix = np.arange(100, 108, dtype=np.int32)

    def reqs(mod, ids):
        return [mod.Request(i, np.concatenate(
            [prefix, np.asarray([(i * 7 + 3) % 512], np.int32)]),
            max_new_tokens=5) for i in ids]

    results = []
    for mod in MODS:
        base = _fault_engine(mod)
        for r in reqs(mod, range(4)):
            base.submit(r)
        base = outcome(base.run_until_drained())
        eng = _fault_engine(mod, host_pages=16, verify_cache=True)
        for r in reqs(mod, [0, 1]):
            eng.submit(r)
        wave1 = outcome(eng.run_until_drained())
        eng.kv.drain_offloads()
        keys = [eng.kv._key(prefix, i) for i in range(2)]
        assert all(eng.kv.store.has(k) for k in keys)
        assert all(eng.kv.store.poison(k) for k in keys)
        for r in reqs(mod, [2, 3]):
            eng.submit(r)
        wave2 = [w for w in outcome(eng.run_until_drained())
                 if w[0] in (2, 3)]
        assert wave2 == [b for b in base if b[0] in (2, 3)]
        assert eng.kv.store.stats()["poisoned"] >= 1
        got = eng.kv.store.lookup(keys[0])
        assert got is not None
        assert all(bool(np.isfinite(np.asarray(v, np.float32)).all())
                   for v in got.values())
        eng.kv.verify()
        results.append((base, wave1, wave2, eng.kv.store.stats(),
                        host_metrics(eng)))
    assert results[1] == results[0]


def test_digest_collision_is_miss_never_crosstalk():
    """Every digest collides (one digest, so one entry): the engine's
    streams stay those of an engine without a tier, and the outcome, the
    store's stats and its one key are JAX's."""
    results = []
    for mod in MODS:
        class Colliding(mod.PrefixStore):
            def _digest(self, key):
                return b"\x00"

        def reqs():
            rng = np.random.default_rng(0)
            return [mod.Request(i, np.concatenate(
                [np.arange(8, dtype=np.int32) + (i % 2) * 50,
                 rng.integers(0, 512, 2).astype(np.int32)]),
                max_new_tokens=6) for i in range(6)]

        base = _fault_engine(mod)
        for r in reqs():
            base.submit(r)
        base = outcome(base.run_until_drained())
        eng = _fault_engine(mod, prefix_store=Colliding(16),
                            verify_cache=True)
        for r in reqs():
            eng.submit(r)
        out = outcome(eng.run_until_drained())
        assert out == base
        assert eng.kv.store.stats()["collisions"] >= 1
        assert eng.kv.store.pages_in_use() <= 1
        eng.kv.verify()
        results.append((out, eng.kv.store.stats(), eng.kv.store.keys()))
    assert results[1] == results[0]


def test_evict_while_shared_never_offloads_live_pages():
    """Preempting one sharer of a prefix while another still reads it
    offloads nothing; the last free offloads both pages and a later
    admission prefetches them: the same counts, refcounts and tables as
    the JAX cache at every step."""
    jcfg, jlm, jparams, tlm, tparams = model()
    prompt = np.arange(8, dtype=np.int32)
    jkv = jlm.init_cache(4, 32, dtype=jnp.float32, backend="paged",
                         page_size=4, num_pages=16, host_pages=8)
    tkv = tlm.init_cache(4, 32, page_size=4, num_pages=16, device="cpu",
                         host_pages=8)
    _, _, pc = jlm.forward(jparams, {"tokens": jnp.asarray(prompt[None])},
                           collect_cache=True)
    assert jkv.alloc(0, 12, prefix=prompt) == 0
    jkv.write_prefill(0, pc["layers"])
    assert tkv.alloc(0, 12, prefix=prompt) == 0
    _, cache = tlm.forward(tparams, torch.from_numpy(prompt[None]).long(),
                           collect_cache=True)
    tkv.staged_write_prefill(cache["layers"], torch.from_numpy(
        tkv.prefill_dest(0, 8, 8)[None]))
    for kv in (jkv, tkv):
        assert kv.alloc(1, 12, prefix=prompt) == 8
        shared = list(kv._slot_pages[1][:2])
        kv.evict(0)
        kv.drain_offloads()
        assert kv.store.pages_in_use() == 0
        assert all(kv._ref[p] == 1 for p in shared)
        assert all(p in kv._page_to_hash for p in shared)
        kv.verify()
        kv.free(1)
        kv.drain_offloads()
        assert kv.store.pages_in_use() == 2
        assert kv.store.stats()["offloads"] == 2
        assert kv.alloc(2, 12, prefix=prompt) == 8
        assert kv.store.stats()["hits"] == 2
        kv.verify()
    assert tkv.store.stats() == jkv.store.stats()
    np.testing.assert_array_equal(tkv.page_table, jkv.page_table)
    # the prefetched pages hold the bytes the first prefill wrote
    pages = tkv._slot_pages[2][:2]
    for name, pool in tkv.state["layers"].items():
        np.testing.assert_allclose(
            pool[:, pages].numpy(),
            np.asarray(jkv.state["layers"][name])[:, pages], **TOL)


# ----------------------------------------------------------- hazards ----

def _view_hazard(cls):
    """Prompt A (8 tokens, two full pages) lands in slot 0 while prompt B
    (12 tokens) is admitted for chunked prefill in slot 1 and lands its
    first chunk.  Slot 0 frees (A's pages offload); B's ``extend`` claims
    the pages just freed, with no store lookup and so no drain between,
    and its next chunks rewrite them; then the drain.  Returns whether the
    store holds A's K/V under A's keys, and whether it holds what B wrote
    into A's pages."""
    _, _, _, tlm, tparams = model()
    kv = cls(tlm.cfg, 2, 16, page_size=4, num_pages=8, device="cpu",
             dtype=torch.float32, host_pages=4)
    rng = np.random.default_rng(3)
    a = rng.integers(0, 512, 8).astype(np.int32)
    b = rng.integers(0, 512, 12).astype(np.int32)
    blocks, pages = {}, {}
    for name, prompt in (("a", a), ("b", b)):
        _, cache = tlm.forward(tparams, torch.from_numpy(prompt[None]).long(),
                               collect_cache=True)
        blocks[name] = cache["layers"]
        pages[name] = {n: t[:, 0].reshape(t.shape[0], -1, 4, *t.shape[3:])
                       for n, t in blocks[name].items()}

    def land(slot, name, start, end):
        dest = kv.chunk_dest(slot, start, end, end - start)
        kv.staged_write_prefill({n: t[:, :, start:end]
                                 for n, t in blocks[name].items()},
                                torch.from_numpy(dest[None]))

    assert kv.alloc(0, 12, prefix=a) == 0
    land(0, "a", 0, 8)
    assert kv.alloc_chunked(1, 12, 4, prefix=b) == 0
    land(1, "b", 0, 4)
    a_pages = list(kv._slot_pages[0][:2])
    kv.free(0)
    assert kv.extend(1, 12)
    land(1, "b", 4, 12)
    b_pages = list(kv._slot_pages[1])
    taken = [i for i in range(2) if a_pages[i] in b_pages]
    assert taken                  # a freed page was reclaimed and rewritten
    kv.drain_offloads()
    stored = [kv.store.lookup(kv._key(a, i)) for i in range(2)]
    holds_a = all(torch.equal(stored[i][n], pages["a"][n][:, i])
                  for i in range(2) for n in ("k", "v"))
    holds_b = all(torch.equal(stored[i][n],
                              pages["b"][n][:, b_pages.index(a_pages[i])])
                  for i in taken for n in ("k", "v"))
    return holds_a, holds_b


@pytest.mark.parametrize("variant", ["port", "view-storing"])
def test_offload_is_a_snapshot_not_a_view(variant):
    """The offload copies the freed page at ``free``: the store holds
    prompt A's K/V although prompt B's chunks took A's pages at once and
    rewrote them before the drain.  The same check run on a cache that stores a
    view of the page finds B's K/V there instead: the hazard is real, and
    this test tells the two apart."""
    if variant == "port":
        holds_a, holds_b = _view_hazard(tserve.PagedCache)
        assert holds_a and not holds_b
    else:
        # the card smoke's view-storing cache (JAX's slice taken literally)
        holds_a, holds_b = _view_hazard(_chip_smoke()._view_cache())
        assert holds_b and not holds_a


# ---------------------------------------------------------- launcher ----

def _host_summary(text):
    """The launcher lines that carry no time: the outcome, the host tier,
    the chunk counts."""
    keep = []
    for line in text.splitlines():
        if line.startswith("served "):
            keep.append(line.split(" in ")[0])
        elif line.startswith(("host tier [", "chunked prefill [",
                              "  ", "warmup pass: ")):
            keep.append(line.split("ms, ")[-1])
    return keep


def test_launcher_host_pages_prefix_store_matches_jax_launcher(monkeypatch):
    """``--host-pages 16 --prefix-store --page-size 4 --prefill-chunk 8
    --requests 6``: the port's launcher on the JAX launcher's weights
    prints the JAX launcher's outcome, host-tier and chunk lines: the
    warm-up engine fills the store, the reported engine hits it."""
    tparams = launcher_setup()[5]
    flags = ["--host-pages", "16", "--prefix-store", "--page-size", "4",
             "--prefill-chunk", "8", "--requests", "6"]
    monkeypatch.setattr(sys, "argv", ["serve"] + flags)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jlaunch.main()
    exp = _host_summary(buf.getvalue())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        eng = tlaunch.serve(tlaunch.parse_args(["--device", "cpu"] + flags),
                            None, "cpu", params=tparams)
    got = _host_summary(buf.getvalue())
    assert sorted(got) == sorted(exp), (got, exp)
    assert any(line.startswith("host tier [16 pages, persistent store]")
               for line in got)
    assert eng.kv.store.stats()["hits"] > 0
    with pytest.raises(SystemExit, match="--host-pages"):
        tlaunch.main(["--device", "cpu", "--prefix-store"])
