"""Multi-tenant serving in the port against the JAX package on the CPU:
``TenancyConfig``, its ``parse`` and ``next_victim`` on seeded inputs; the
paged allocator's quotas, ``last_deny``, ``evict``, ``fail_chip`` and
``poison_page`` step for step against the JAX cache; and the port's engine
against the JAX engine in lockstep (slots, queue, positions and counters
after every step, then streams and statuses) for priority admission with
a quota skip, the deferral reason split, preemption and recompute on
resume (whole-prompt and chunked, also against the engine without
tenancy), the no-preemption mode, equal priority, the per-class chunk cap
and the per-class latency histograms; and seeded sampling across a
preemption, port against port.  A 2-layer ``llama3.2-3b.reduced()`` in
fp32 with the JAX weights carried over by ``from_jax``."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serve as jserve
import repro_torch.serve as tserve
from repro.configs import CONFIGS as JCONFIGS
from repro.models import LM as JLM
from repro_torch.configs import CONFIGS as TCONFIGS
from repro_torch.models import LM
from repro_torch.models.params import from_jax

MODS = (jserve, tserve)
COUNTERS = ("serve_admission_deferred_total", "serve_quota_denied_total",
            "serve_preemptions_total", "serve_prefill_chunks_total",
            "serve_prefill_dispatches_total", "serve_prefill_tokens_total",
            "serve_decode_dispatches_total", "serve_faults_injected_total",
            "serve_stream_retries_total", "serve_dead_letter_total")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's engines here are tiny: one intra-op thread serves them
    as fast as many, and spares the other test workers' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def model():
    """The JAX serve tests' model: 2-layer reduced llama3.2-3b, fp32, JAX
    weights from ``key(0)``, and the same weights in the port."""
    jcfg = dataclasses.replace(JCONFIGS["llama3.2-3b"].reduced(),
                               dtype="float32", num_layers=2)
    tcfg = dataclasses.replace(TCONFIGS["llama3.2-3b"].reduced(),
                               dtype="float32", num_layers=2)
    jparams = JLM(jcfg).init(jax.random.key(0))
    tparams = from_jax(jax.tree.map(np.asarray, jparams), tcfg, device="cpu")
    return jcfg, JLM(jcfg), jparams, LM(tcfg), tparams


def engine(mod, **kw):
    """A paged engine of ``mod`` (``repro.serve`` or ``repro_torch.serve``)
    on the shared weights; a ``fault_plan`` string is parsed by ``mod``."""
    _, jlm, jparams, tlm, tparams = model()
    if isinstance(kw.get("fault_plan"), str):
        kw["fault_plan"] = mod.FaultPlan.parse(kw["fault_plan"])
    kw.setdefault("cache_backend", "paged")
    if mod is jserve:
        return jserve.ServeEngine(jlm, jparams, **kw)
    return tserve.ServeEngine(tlm, tparams, device="cpu", **kw)


def snapshot(eng):
    """What the two engines must agree on after every step."""
    snap = ([None if r is None else r.id for r in eng.slot_req],
            [r.id for r in eng.queue], eng.active.tolist(),
            eng.slot_pos.tolist(), sorted(eng.prefilling),
            {c: sorted(eng.reg.counter(c).labels_values())
             for c in COUNTERS})
    if eng.kv.backend == "paged":
        snap += (eng.kv.page_table.tolist(),
                 eng.kv.memory_stats().tenant_pages)
    return snap


def outcome(done):
    return sorted((r.id, r.tenant, r.status, tuple(r.out_tokens), r.retries,
                   r.preemptions, r.error) for r in done)


def lockstep(make_engine, arrivals, max_iters=400):
    """Drive a JAX and a port engine from ``make_engine(mod)`` through the
    same ``arrivals`` ({iteration: [(id, prompt, max_new, tenant, sampling
    kwargs)]}), asserting equal snapshots after every step; returns both
    engines once drained."""
    engs = [make_engine(mod) for mod in MODS]
    last = max(arrivals, default=0)
    for it in range(max_iters):
        for eng, mod in zip(engs, MODS):
            for i, prompt, new, tenant, sp in arrivals.get(it, []):
                eng.submit(mod.Request(i, prompt.copy(), max_new_tokens=new,
                                       tenant=tenant,
                                       sampling=mod.SamplingParams(**sp)))
        live = [eng.step() for eng in engs]
        assert snapshot(engs[1]) == snapshot(engs[0]), f"step {it}"
        assert live[0] == live[1]
        if it >= last and not any(live) and not engs[0].queue:
            break
    else:
        raise AssertionError("the engines did not drain")
    assert outcome(engs[1].finished) == outcome(engs[0].finished)
    engs[1].kv.verify()
    return engs


def prompts(seed, *lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, n).astype(np.int32) for n in lens]


def two_class(mod, bulk_quota=None, preemption=True, classes=None):
    if classes is not None:
        classes = {k: mod.PriorityClass(k, *v) for k, v in classes.items()}
    return mod.TenancyConfig([mod.TenantSpec("chat", "interactive"),
                              mod.TenantSpec("bulk", "batch",
                                             page_quota=bulk_quota)],
                             classes=classes, preemption=preemption)


# ------------------------------------------------------------ policies ----

def test_tenancy_config_and_next_victim_match_jax():
    """``TenancyConfig`` and ``parse`` give the same tables and refuse with
    the same messages; ``next_victim`` picks the same slot on 300 seeded
    candidate lists."""
    for tenants, quotas, pre in (("chat=interactive,bulk=batch", "bulk=8",
                                  True),
                                 ("a,b=interactive,c=batch", "", False),
                                 (" x=batch , y ", "x=3,y=1", True)):
        cfgs = [m.TenancyConfig.parse(tenants, quotas, preemption=pre)
                for m in MODS]
        assert [sorted((t.name, t.cls, t.page_quota)
                       for t in c.tenants.values()) for c in cfgs][0] == \
            sorted((t.name, t.cls, t.page_quota)
                   for t in cfgs[1].tenants.values())
        assert cfgs[0].preemption == cfgs[1].preemption
        assert cfgs[0].has_quotas() == cfgs[1].has_quotas()
        for name in cfgs[0].tenants:
            assert (cfgs[0].priority_of(name), cfgs[0].class_of(name)
                    .preemptible) == (cfgs[1].priority_of(name),
                                      cfgs[1].class_of(name).preemptible)
    bad = [lambda m: m.TenancyConfig.parse("a", "b=2"),
           lambda m: m.TenancyConfig([]),
           lambda m: m.TenancyConfig([m.TenantSpec("a"), m.TenantSpec("a")]),
           lambda m: m.TenancyConfig([m.TenantSpec("a", "gold")]),
           lambda m: m.TenancyConfig([m.TenantSpec("a", page_quota=0)]),
           lambda m: m.TenancyConfig([m.TenantSpec("a")], classes={
               "x": m.PriorityClass("y", 1)}),
           lambda m: m.TenancyConfig([m.TenantSpec("a")]).spec("zz")]
    for make in bad:
        msgs = []
        for m in MODS:
            with pytest.raises(ValueError) as e:
                make(m)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    rng = np.random.default_rng(0)
    for _ in range(300):
        n = int(rng.integers(0, 6))
        cands = [(int(s), int(rng.choice([0, 50, 100])),
                  bool(rng.integers(0, 2)), int(rng.integers(0, 5)))
                 for s in rng.permutation(8)[:n]]
        prio = int(rng.choice([0, 50, 100, 150]))
        got = [m.next_victim([m.Victim(*c) for c in cands], prio)
               for m in MODS]
        assert (got[0] and dataclasses.astuple(got[0])) == \
            (got[1] and dataclasses.astuple(got[1]))


# ----------------------------------------------------------- allocator ----

def _cache_pair(b=4, s=32, num_pages=16, **kw):
    _, jlm, _, tlm, _ = model()
    jkv = jlm.init_cache(b, s, dtype=jnp.float32, backend="paged",
                         page_size=4, num_pages=num_pages, **kw)
    tkv = tlm.init_cache(b, s, page_size=4, num_pages=num_pages,
                         device="cpu", dtype=torch.float32, **kw)
    return jkv, tkv


PROMPT = np.arange(8, dtype=np.int32)       # two full shareable pages
SEQUENCES = {
    # test_serve_tenant.py's quota walk, then the lifted cap
    "quota": [("set_quota", ("bulk", 6)),
              ("alloc", (0, 12), dict(prefix=PROMPT, tenant="bulk")),
              ("alloc", (1, 12), dict(prefix=PROMPT, tenant="bulk")),
              ("alloc", (2, 4), dict(tenant="bulk")),
              ("alloc", (2, 4), dict(tenant="chat")),
              ("slot_freeable", (1,)), ("evict", (1,)),
              ("set_quota", ("bulk", 2)),
              ("alloc", (1, 12), dict(tenant="bulk")),
              ("set_quota", ("bulk", None)),
              ("alloc", (1, 12), dict(tenant="bulk")),
              ("free", (0,)), ("free", (2,)), ("evict", (1,))],
    # chunked claims charge the whole footprint up front; a pool deny
    "chunked": [("set_quota", ("bulk", 9)),
                ("alloc_chunked", (0, 28, 4), dict(tenant="bulk")),
                ("alloc_chunked", (1, 12, 4), dict(tenant="bulk")),
                ("alloc_chunked", (1, 28, 4), dict(tenant="chat")),
                ("alloc", (2, 32), dict(tenant="chat")),
                ("alloc", (3, 28), dict(tenant="chat")),
                ("extend", (0, 16)), ("extend", (1, 20)),
                ("slot_freeable", (0,)), ("evict", (0,)),
                ("alloc", (3, 28), dict(tenant="chat")), ("free", (1,)),
                ("free", (2,)), ("alloc", (3, 28), dict(tenant="chat")),
                ("free", (3,))],
    # a failed chip: its free pages go, its owners are named, its pages
    # never come back, and the pool shrinks
    "fail_chip": [("alloc", (0, 12), dict(prefix=PROMPT, tenant="bulk")),
                  ("alloc", (1, 20), dict(tenant="chat")),
                  ("alloc", (2, 16)), ("register_landed", (0, PROMPT, 8)),
                  ("fail_chip", (1,)), ("fail_chip", (1,)),
                  ("usable_pages", ()), ("can_ever_fit", (32,)),
                  ("unregister_pages", ([1, 2, 3],)),
                  ("evict", (1,)), ("free", (2,)),
                  ("alloc", (1, 28), dict(prefix=PROMPT)),
                  ("usable_pages", ()), ("can_ever_fit", (28,)),
                  ("evict", (0,)), ("free", (1,))],
}


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_paged_cache_ops_match_jax(name):
    """The same sequence on the JAX and the port caches: equal returns,
    ``last_deny``, tables, refcounts, free lists, tenant pages and
    registries after every op, and the same ``verify`` verdict."""
    kw = {"locality_chips": 2} if name == "fail_chip" else {}
    jkv, tkv = _cache_pair(**kw)
    for op, args, *rest in SEQUENCES[name]:
        opts = rest[0] if rest else {}
        got = [getattr(kv, op)(*args, **opts) for kv in (jkv, tkv)]
        assert got[0] == got[1], (op, args, got)
        assert jkv.last_deny == tkv.last_deny, (op, args)
        np.testing.assert_array_equal(tkv.page_table, jkv.page_table)
        np.testing.assert_array_equal(tkv._ref, jkv._ref)
        assert tkv._hash_to_page == jkv._hash_to_page
        assert tkv._free_chip == jkv._free_chip
        js, ts = jkv.memory_stats(), tkv.memory_stats()
        assert (ts.tenant_pages, ts.chips_failed, ts.pages_total,
                ts.pages_in_use) == (js.tenant_pages, js.chips_failed,
                                     js.pages_total, js.pages_in_use)
        # between a chip failure and its victims' eviction, both caches
        # must report the same broken invariant
        assert _verdict(jkv) == _verdict(tkv), (op, args)
    assert _verdict(tkv) is None
    assert tkv.memory_stats().tenant_pages == {}


def _verdict(kv):
    try:
        kv.verify()
    except AssertionError as e:
        return str(e)
    return None


@pytest.mark.parametrize("kv_dtype", ["native", "int8"])
def test_poison_page_writes_nan_in_place_as_jax(kv_dtype):
    """``poison_page`` NaNs the same elements as JAX's (the scales of an
    int8 pool), in place: the pool tensors are the same objects after."""
    jkv, tkv = _cache_pair(kv_dtype=kv_dtype)
    ptrs = {n: t.data_ptr() for n, t in tkv.state["layers"].items()}
    for kv in (jkv, tkv):
        kv.poison_page(5)
    for name, t in tkv.state["layers"].items():
        assert t.data_ptr() == ptrs[name]
        np.testing.assert_array_equal(
            np.isnan(t.float().numpy()),
            np.isnan(np.asarray(jkv.state["layers"][name], np.float32)))
        assert bool(torch.isnan(t.float()).any()) == (
            name in (("k_scale", "v_scale") if kv_dtype == "int8"
                     else ("k", "v")))


# -------------------------------------------------------------- engines ----

def test_priority_admission_and_quota_skip_match_jax():
    """Interactive admits first though submitted last; the quota-capped
    third bulk request is skipped, not a block; the tenant gauges."""
    ps = prompts(0, 8, 8, 8, 4)
    arrivals = {0: [(i, p, 4, t, {}) for i, (p, t) in enumerate(
        zip(ps, ["bulk", "bulk", "bulk", "chat"]))]}
    engs = lockstep(lambda m: engine(m, max_batch=4, max_seq=64,
                                     page_size=8, num_pages=16,
                                     tenancy=two_class(m, bulk_quota=4)),
                    arrivals)
    for eng in engs:
        assert eng.reg.counter("serve_quota_denied_total").get() >= 1
        assert eng.reg.gauge("serve_tenant_quota_pages").get(
            {"tenant": "bulk"}) == 4
    first = [r.id for r in sorted(engs[1].finished,
                                  key=lambda r: r.first_token_at)]
    assert first.index(3) < first.index(2)


def test_deferral_reason_split_matches_jax():
    """The unlabeled deferral series is the sum of its reason series, and
    both split as JAX's (quota and pool denies, no preemption)."""
    ps = prompts(1, 12, 12, 12, 12)
    arrivals = {0: [(i, p, 4, "chat" if i == 3 else "bulk", {})
                    for i, p in enumerate(ps)]}
    engs = lockstep(lambda m: engine(
        m, max_batch=2, max_seq=64, page_size=8, num_pages=8,
        tenancy=two_class(m, bulk_quota=2, preemption=False)), arrivals)
    c = engs[1].reg.counter("serve_admission_deferred_total")
    pool, quota = (c.get({"reason": r})
                   for r in ("pool_exhausted", "quota_denied"))
    assert quota > 0 and pool > 0 and c.get() == pool + quota


def _mixed(chunk=0, tenants=True, preemption=True, sampling=None):
    """JAX's preemption trace: two bulk decodes fill both slots, then a
    chat request arrives at iteration 4 and must preempt one."""
    ps = prompts(7, 10, 10, 6)
    sp = sampling or {}
    arrivals = {0: [(i, ps[i], 12, "bulk" if tenants else "default", sp)
                    for i in range(2)],
                4: [(2, ps[2], 4, "chat" if tenants else "default", sp)]}

    def make(m):
        kw = dict(max_batch=2, max_seq=64, page_size=8, num_pages=12)
        if chunk:
            kw["prefill_chunk"] = chunk
        if tenants:
            kw["tenancy"] = two_class(m, preemption=preemption)
        return engine(m, **kw)
    return arrivals, make


@pytest.mark.parametrize("chunk", [0, 8])
def test_preemption_resume_matches_jax_and_untenanted(chunk):
    """The preempted bulk stream resumes through a recompute prefill of
    prompt + emitted tokens: the port steps with JAX, and its streams
    equal the engine without tenancy (chat waits there instead)."""
    arrivals, make = _mixed(chunk)
    engs = lockstep(make, arrivals)
    oracle = lockstep(_mixed(chunk, tenants=False)[1],
                      _mixed(chunk, tenants=False)[0])
    for eng in engs:
        assert eng.reg.counter("serve_preemptions_total").get() >= 1
    assert oracle[1].reg.counter("serve_preemptions_total").get() == 0
    streams = [sorted((r.id, tuple(r.out_tokens)) for r in e.finished)
               for e in (engs[1], oracle[1])]
    assert streams[0] == streams[1]
    pre = [r for r in engs[1].finished if r.preemptions]
    assert pre and all(r.tenant == "bulk" and len(r.out_tokens) == 12
                       for r in pre)


def test_no_preemption_mode_matches_jax():
    arrivals, make = _mixed(preemption=False)
    engs = lockstep(make, arrivals)
    assert engs[1].reg.counter("serve_preemptions_total").get() == 0
    assert len(engs[1].finished) == 3


def test_equal_priority_never_preempts_matches_jax():
    ps = prompts(3, 6, 6)

    def make(m):
        ten = m.TenancyConfig([m.TenantSpec("bulk_a", "batch"),
                               m.TenantSpec("bulk_b", "batch")])
        return engine(m, max_batch=1, max_seq=64, page_size=8, num_pages=4,
                      tenancy=ten)
    engs = lockstep(make, {0: [(0, ps[0], 4, "bulk_a", {}),
                               (1, ps[1], 4, "bulk_b", {})]})
    assert engs[1].reg.counter("serve_preemptions_total").get() == 0


@pytest.mark.parametrize("capped", [True, False])
def test_class_prefill_cap_matches_jax(capped):
    """A batch-class cap of one chunk lands two bulk prompts one chunk an
    iteration where the global budget allows two; the streams are the
    uncapped ones."""
    ps = prompts(4, 16, 16)
    classes = {"batch": (0, True, 8)} if capped else None

    def make(m):
        return engine(m, max_batch=2, max_seq=64, page_size=8,
                      prefill_chunk=8, prefill_budget=16,
                      tenancy=two_class(m, classes=classes))
    engs = lockstep(make, {0: [(i, p, 2, "bulk", {})
                               for i, p in enumerate(ps)]})
    assert engs[1].reg.counter("serve_prefill_chunks_total").get() == 4
    assert engs[1].reg.counter("serve_prefill_dispatches_total").get() == \
        (4 if capped else 2)


def test_class_histograms_count_as_jax():
    arrivals, make = _mixed()
    engs = lockstep(make, arrivals)
    counts = [{(name, cls): e.reg.histogram(name).count({"class": cls})
               for name in ("serve_class_ttft_seconds",
                            "serve_class_itl_seconds")
               for cls in ("interactive", "batch")} for e in engs]
    assert counts[0] == counts[1]
    assert counts[1] == {("serve_class_ttft_seconds", "interactive"): 1,
                         ("serve_class_ttft_seconds", "batch"): 2,
                         ("serve_class_itl_seconds", "interactive"): 3,
                         ("serve_class_itl_seconds", "batch"): 22}


def test_seeded_sampling_across_preemption_port():
    """A seeded non-greedy stream (temperature 0.8, top-k 20, top-p 0.95)
    preempted and resumed equals the same stream never preempted, bitwise
    (the pending token is re-drawn at the same (seed, step))."""
    sp = dict(temperature=0.8, top_k=20, top_p=0.95, seed=9)
    out = []
    for preemption in (True, False):
        arrivals, make = _mixed(sampling=sp, preemption=preemption)
        eng = make(tserve)
        for it in range(200):
            for i, p, new, t, s in arrivals.get(it, []):
                eng.submit(tserve.Request(i, p.copy(), max_new_tokens=new,
                                          tenant=t,
                                          sampling=tserve.SamplingParams(**s)))
            if not eng.step() and not eng.queue and it >= 4:
                break
        assert (eng.reg.counter("serve_preemptions_total").get() > 0) == \
            preemption
        out.append(sorted((r.id, tuple(r.out_tokens)) for r in eng.finished))
    assert out[0] == out[1] and len(out[0]) == 3
