"""Fault-tolerant serving in the port against the JAX package on the CPU:
``FaultPlan.parse``/``random``; every fault kind, whole-prompt and chunked,
through the port's engine and the JAX engine on the same weights and
requests (greedy: streams, statuses, errors and the fault counters equal),
and the port's recovered streams against its own fault-free run, bitwise,
greedy and seeded; retry exhaustion; ``chip_failure`` and
``capacity_lost`` with ``locality_chips=2``; a random soak on three seeds;
a persistent ``dispatch_error``; ``run_until_drained``'s raise and status
modes; ``verify`` against corrupted tenant and failed-chip bookkeeping;
the contiguous backend's NaN guard and its refusal of the paged-only
kinds; a poisoned page recycled into fresh requests; two gloo ranks over a
split pool under ``chip_failure`` and ``poison_page``; and the launcher
with tenants and a fault plan against the JAX launcher.  The 2-layer
reduced llama3.2-3b of ``test_torch_tenancy`` (the launcher: the JAX
launcher's reduced qwen3-4b), fp32."""
import contextlib
import io
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.serve as jserve
import repro_torch.serve as tserve
from repro.launch import serve as jlaunch
from repro_torch.launch import serve as tlaunch
from test_torch_contiguous import ROOT
from test_torch_contiguous import setup as launcher_setup
from test_torch_sharded import _env, _free_port
from test_torch_tenancy import (MODS, engine, model,  # noqa: F401
                                one_torch_thread, outcome)

FAULT_COUNTERS = ("serve_faults_injected_total", "serve_stream_retries_total",
                  "serve_dead_letter_total", "serve_preemptions_total",
                  "serve_prefill_chunk_stalls_total")


def requests(mod, n=6, max_new=6, seed=0, greedy=True):
    """test_serve_faults.py's workload; ``greedy=False`` makes the odd ids
    seeded top-p draws (temperature 0.8), which only the port's own runs
    can be held to."""
    rng = np.random.default_rng(seed)
    return [mod.Request(i, rng.integers(0, 512, 6 + (i % 5)).astype(np.int32),
                        max_new_tokens=max_new,
                        sampling=mod.SamplingParams(
                            temperature=0.0 if greedy or i % 2 == 0 else 0.8,
                            seed=i))
            for i in range(n)]


def counters(eng):
    out = {c: sorted(eng.reg.counter(c).labels_values())
           for c in FAULT_COUNTERS}
    out["recoveries"] = eng.reg.histogram("serve_recovery_iters").count()
    out["quarantined"] = eng.reg.gauge("serve_streams_quarantined").get()
    return out


def drain(eng, reqs, max_iters=2000):
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained(max_iters=max_iters)
    return outcome(done), counters(eng)


def streams(result):
    return {r[0]: r[3] for r in result[0] if r[2] == "completed"}


def fault_engine(mod, chunked=False, **kw):
    kw.setdefault("num_pages", 33)
    kw.setdefault("max_batch", 4)
    if chunked:
        kw.setdefault("prefill_chunk", 8)
    return engine(mod, max_seq=64, page_size=4, **kw)


# ------------------------------------------------------------ the plan ----

def test_fault_plan_parse_and_random_match_jax():
    spec = ("nan_logits@5,poison_page@9:slot=2,chip_failure@12:chip=1,"
            "stall_chunk@3:slot=0:dur=8,dispatch_error@7:dur=2,"
            "poison_page@2:page=7")
    plans = [m.FaultPlan.parse(spec, seed=4) for m in MODS]
    assert [dataclass_tuple(e) for e in plans[0].events] == \
        [dataclass_tuple(e) for e in plans[1].events]
    assert repr(plans[0]) == repr(plans[1]) and len(plans[1]) == 6
    assert plans[1].events_at(3)[0].duration == 8
    for seed in range(5):
        for kinds in ((), ("nan_logits", "chip_failure")):
            kw = {"kinds": kinds} if kinds else {}
            got = [m.FaultPlan.random(12, 90, seed=seed, **kw) for m in MODS]
            assert [dataclass_tuple(e) for e in got[0].events] == \
                [dataclass_tuple(e) for e in got[1].events]
    for bad in ("typo_kind@3", "nan_logits", "nan_logits@2:bogus=1",
                "nan_logits@-1", "nan_logits@1:dur=0"):
        msgs = []
        for m in MODS:
            with pytest.raises(ValueError) as e:
                m.FaultPlan.parse(bad)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def dataclass_tuple(e):
    return (e.iteration, e.kind, e.slot, e.chip, e.page, e.duration)


# ------------------------------------------------------- each fault kind ----

KINDS = {
    "nan_logits": dict(fault_plan="nan_logits@2,nan_logits@6",
                       watchdog_iters=16),
    "poison_page": dict(fault_plan="poison_page@2,poison_page@6",
                        watchdog_iters=16),
    # whole-prompt only: NaN scales on an int8 pool
    "poison_page-int8": dict(fault_plan="poison_page@2,poison_page@6",
                             watchdog_iters=16, kv_dtype="int8"),
    # whole-prompt: no chunk to stall, so the event is dropped uncounted
    "stall_chunk": dict(fault_plan="stall_chunk@1:dur=50", watchdog_iters=6),
    "dispatch_error": dict(fault_plan="dispatch_error@3:dur=2"),
    "chip_failure": dict(fault_plan="chip_failure@3:chip=1", num_pages=24,
                         locality_chips=2, watchdog_iters=16, n=8),
}


@pytest.mark.parametrize("kind,chunked", [
    (k, c) for k in KINDS for c in (False, True)
    if not (k.endswith("int8") and c)],
    ids=lambda v: ("chunked" if v else "whole_prompt")
    if isinstance(v, bool) else v)
def test_each_kind_matches_jax_and_resumes_bitwise(kind, chunked):
    """One plan per kind through both engines with ``verify_cache``: the
    port's greedy outcome (streams, statuses, retries, errors) and fault
    counters equal JAX's; every stream the port completes equals its own
    fault-free run, greedy and seeded."""
    kw = dict(KINDS[kind])
    n = kw.pop("n", 6)
    res = [drain(fault_engine(m, chunked, verify_cache=True, **kw),
                 requests(m, n)) for m in MODS]
    assert res[1] == res[0]
    injected = sum(v for _, v in res[1][1]["serve_faults_injected_total"])
    assert injected == (0 if kind == "stall_chunk" and not chunked else
                        len(kw["fault_plan"].split(",")))
    clean_kw = {k: v for k, v in kw.items()
                if k not in ("fault_plan", "watchdog_iters")}
    for greedy in (True, False):
        got = res[1] if greedy else drain(
            fault_engine(tserve, chunked, verify_cache=True, **kw),
            requests(tserve, n, greedy=False))
        base = drain(fault_engine(tserve, chunked, **clean_kw),
                     requests(tserve, n, greedy=greedy))
        done = streams(got)
        assert done and all(done[i] == streams(base)[i] for i in done)
        assert got[1]["quarantined"] == 0
    if kind.startswith(("nan", "poison")):
        assert dict(res[1][1]["serve_stream_retries_total"])[
            (("reason", "nonfinite_logits"),)] >= 1
        assert res[1][1]["recoveries"] >= 1
    if kind == "stall_chunk" and chunked:
        assert dict(res[1][1]["serve_stream_retries_total"])[
            (("reason", "watchdog"),)] >= 1


def test_retry_exhaustion_dead_letters_and_spares_neighbours():
    """nan_logits re-firing on slot 0 exhausts a budget of one retry: that
    request is dead-lettered with the reason on it, its neighbour
    completes as in the fault-free run, and the outcome is JAX's."""
    kw = dict(max_batch=2, num_pages=33, max_retries=1, verify_cache=True,
              fault_plan="nan_logits@1:slot=0,nan_logits@3:slot=0")
    res = [drain(fault_engine(m, **kw), requests(m, 2)) for m in MODS]
    assert res[1] == res[0]
    done = {r[0]: r for r in res[1][0]}
    assert done[0][2] == "dead_letter" and done[0][4] == 2
    assert "nonfinite_logits" in done[0][6]
    base = drain(fault_engine(tserve, max_batch=2), requests(tserve, 2))
    assert done[1][2] == "completed" and done[1][3] == streams(base)[1]


def test_chip_failure_dead_letters_unservable_footprints():
    """After chip 1 of a 12-page pool fails, queued footprints of 6 pages
    no longer fit the 5 that survive: ``capacity_lost``, as JAX."""
    out = []
    for m in MODS:
        eng = engine(m, max_batch=2, max_seq=64, page_size=4, num_pages=12,
                     locality_chips=2, fault_plan="chip_failure@2:chip=1")
        rng = np.random.default_rng(0)
        big = m.Request(0, rng.integers(0, 512, 14).astype(np.int32),
                        max_new_tokens=10)
        small = m.Request(1, rng.integers(0, 512, 4).astype(np.int32),
                          max_new_tokens=4)
        third = m.Request(2, rng.integers(0, 512, 14).astype(np.int32),
                          max_new_tokens=10)
        out.append(drain(eng, [small, big, third]))
        assert eng.kv.usable_pages() == 5
    assert out[1] == out[0]
    dead = [r for r in out[1][0] if r[2] == "dead_letter"]
    assert dead and all("capacity_lost" in r[6] for r in dead)


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_random_soak_matches_jax(seed):
    """Requests trickle in under a seeded random plan of every recoverable
    kind (chunked, watchdog 16, 8 retries): the port's engine over the
    gathered decode and through K1 drains, every request terminal and
    the pool clean; on seed 3 the JAX engine too, and the port over the
    gathered decode (JAX's default, which lets a recycled poisoned page
    through as JAX's does, see ``test_recycled_poisoned_page``) reaches
    its outcome and counters."""
    rng = np.random.default_rng(11)
    arrivals = {}
    for i in range(16):
        arrivals.setdefault(int(rng.integers(0, 60)), []).append(
            (i, rng.integers(0, 512, int(rng.integers(2, 12)))
             .astype(np.int32), int(rng.integers(2, 7))))
    res = []
    runs = ((jserve, None),) if seed == 3 else ()
    for m, impl in runs + ((tserve, "gather"), (tserve, "kernel")):
        eng = fault_engine(m, chunked=True, watchdog_iters=16, max_retries=8,
                           verify_cache=True,
                           fault_plan=m.FaultPlan.random(10, 150, seed=seed),
                           **({"decode_impl": impl} if impl else {}))
        it = 0
        while it < 200 or eng.queue or any(eng.slot_req):
            for i, p, new in arrivals.get(it, []):
                eng.submit(m.Request(i, p.copy(), max_new_tokens=new))
            eng.step()
            it += 1
            assert it < 1000, "the soak did not drain"
        res.append((outcome(eng.finished), counters(eng)))
        eng.kv.verify()
    if runs:
        assert res[1] == res[0]
    for out, count in res[len(runs):]:
        assert len(out) == 16
        assert all(r[2] in ("completed", "dead_letter") for r in out)
        assert sum(v for _, v in count["serve_faults_injected_total"]) >= 1
        assert count["quarantined"] == 0


def test_persistent_dispatch_error_is_engine_fatal():
    """More dispatch failures in a row than ``max_retries`` re-raise, with
    JAX's message, after JAX's count of retries."""
    out = []
    for m in MODS:
        eng = fault_engine(m, max_retries=2,
                           fault_plan="dispatch_error@2:dur=10")
        for r in requests(m, 2):
            eng.submit(r)
        with pytest.raises(m.TransientDispatchError) as e:
            eng.run_until_drained(max_iters=100)
        out.append((str(e.value), counters(eng)))
    assert out[0] == out[1]


@pytest.mark.parametrize("mode", ["raise", "status"])
def test_run_until_drained_out_of_iterations_matches_jax(mode):
    out = []
    for m in MODS:
        eng = fault_engine(m)
        for r in requests(m, 2):
            eng.submit(r)
        if mode == "raise":
            with pytest.raises(m.EngineStuckError) as e:
                eng.run_until_drained(max_iters=2)
            out.append((str(e.value), outcome(e.value.stuck)))
        else:
            out.append(outcome(eng.run_until_drained(max_iters=3,
                                                     on_stuck="status")))
    assert out[0] == out[1]
    stuck = out[1][1] if mode == "raise" else out[1]
    assert [r for r in stuck if r[2] == "stuck"]
    assert all("slot" in r[6] or "queued" in r[6] for r in stuck
               if r[2] == "stuck")


# ------------------------------------------------------------ the cache ----

CORRUPTIONS = {
    "refcount": lambda kv: kv._ref.__setitem__(kv._slot_pages[0][0], 2),
    "tenant_total": lambda kv: kv._tenant_pages.__setitem__(
        "bulk", kv._tenant_pages["bulk"] + 1),
    "tenant_charge": lambda kv: kv._slot_charge.__setitem__(0, 0),
    "failed_free": lambda kv: (kv.free(1), kv.fail_chip(1),
                               kv._free_chip[1].append(kv.P - 1)),
    "failed_owned": lambda kv: kv.fail_chip(1),
}


@pytest.mark.parametrize("name", list(CORRUPTIONS))
def test_verify_catches_corrupted_bookkeeping(name):
    """Hand-corrupted refcounts, tenant totals and charges, and failed-chip
    pages listed free or still owned: both caches' ``verify`` raise
    ``CacheInvariantError`` with the same message."""
    _, jlm, _, tlm, _ = model()
    msgs = []
    for kv in (jlm.init_cache(2, 32, dtype=np.float32, backend="paged",
                              page_size=4, num_pages=10, locality_chips=2),
               tlm.init_cache(2, 32, page_size=4, num_pages=10,
                              locality_chips=2, device="cpu",
                              dtype=torch.float32)):
        assert kv.alloc(0, 8, prefix=np.arange(5, dtype=np.int32),
                        tenant="bulk") == 0
        assert kv.alloc(1, 20) == 0          # spills onto chip 1
        kv.verify()
        CORRUPTIONS[name](kv)
        with pytest.raises(AssertionError) as e:
            kv.verify()
        assert type(e.value).__name__ == "CacheInvariantError"
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_contiguous_nan_guard_and_paged_only_refusal():
    """On the contiguous backend nan_logits recovers bitwise, as JAX's;
    plans with page- or chip-level kinds are refused with JAX's message."""
    res = []
    for m in MODS:
        eng = engine(m, max_batch=4, max_seq=64, cache_backend="contiguous",
                     fault_plan="nan_logits@2")
        res.append(drain(eng, requests(m)))
    assert res[1] == res[0]
    base = drain(engine(tserve, max_batch=4, max_seq=64,
                        cache_backend="contiguous"), requests(tserve))
    assert streams(res[1]) == streams(base) and len(streams(base)) == 6
    assert dict(res[1][1]["serve_stream_retries_total"])[
        (("reason", "nonfinite_logits"),)] >= 1
    msgs = []
    for m in MODS:
        with pytest.raises(ValueError, match="paged") as e:
            engine(m, max_batch=2, max_seq=64, cache_backend="contiguous",
                   fault_plan="poison_page@1,chip_failure@2")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------- a recycled poisoned page ----

@pytest.mark.parametrize("chunked", [False, True],
                         ids=["whole_prompt", "chunked"])
def test_recycled_poisoned_page(chunked):
    """One slot; request 0's latest page is poisoned and, with no retry
    left, it is dead-lettered; its pages go back to the pool still NaN
    and requests 1 and 2 take them, the poisoned one at a live page whose
    rows past the position were never rewritten.  JAX's gathered decode
    and its chunk attention multiply a masked probability of 0 by those
    NaN rows, so both newcomers are dead-lettered too: the port's gathered
    decode and chunk attention do the same, outcome for outcome.  K1 (its
    plain version here) never reads rows past the position, so through
    it the whole-prompt newcomers complete."""
    kw = dict(max_batch=1, max_seq=64, page_size=4, num_pages=12,
              max_retries=0, verify_cache=True,
              fault_plan="poison_page@3")
    if chunked:
        kw["prefill_chunk"] = 4

    def run(m, **extra):
        rng = np.random.default_rng(1)
        reqs = [m.Request(i, rng.integers(0, 512, 5).astype(np.int32),
                          max_new_tokens=6) for i in range(3)]
        return drain(engine(m, **kw, **extra), reqs, max_iters=300)

    jax_res = run(jserve)
    assert run(tserve, decode_impl="gather") == jax_res
    assert [r[2] for r in jax_res[0]] == ["dead_letter"] * 3
    k1 = run(tserve)
    assert [r[2] for r in k1[0]] == (["dead_letter"] * 3 if chunked else
                                     ["dead_letter", "completed",
                                      "completed"])


# ---------------------------------------------------------- gloo ranks ----

RANK = """
import json, sys
import numpy as np, torch, torch.distributed as dist
from repro_torch.models import LM
from repro_torch.parallel import PoolGroup
from repro_torch.serve import FaultPlan, Request, ServeEngine
rank, n, port, path, plan = (int(sys.argv[1]), int(sys.argv[2]),
                             int(sys.argv[3]), sys.argv[4], sys.argv[5])
dist.init_process_group('gloo', init_method=f'tcp://localhost:{port}',
                        rank=rank, world_size=n)
params, cfg, reqs = torch.load(path, weights_only=False)
eng = ServeEngine(LM(cfg), params, 4, 64, page_size=4, num_pages=24,
                  device='cpu', pool_group=PoolGroup.of(),
                  fault_plan=FaultPlan.parse(plan), watchdog_iters=16,
                  verify_cache=True)
for i, p, new in reqs:
    eng.submit(Request(i, np.asarray(p, np.int32), max_new_tokens=new))
done = eng.run_until_drained(max_iters=2000)
print('OUT ' + json.dumps(sorted((r.id, r.status, r.out_tokens, r.retries)
                                 for r in done)))
print('FAULTS ' + json.dumps(sorted(
    str(k) for k in eng.reg.counter('serve_faults_injected_total')
    .labels_values())))
dist.destroy_process_group()
"""


def test_gloo_ranks_chip_failure_and_poison_page(tmp_path):
    """Two gloo ranks over a pool split in two, under ``poison_page`` (only
    the rank holding the page writes the NaN; the merge carries it to
    both) and ``chip_failure`` of rank 1's half (simulated: the rank keeps
    merging): the ranks agree (the engine checks its streams across them)
    and equal the single-process ``locality_chips=2`` engine."""
    _, _, _, tlm, tparams = model()
    reqs = [(r.id, r.prompt.tolist(), r.max_new_tokens)
            for r in requests(tserve, 8)]
    path = tmp_path / "params.pt"
    torch.save((tparams, tlm.cfg, reqs), path)
    plan = "poison_page@2,chip_failure@4:chip=1"
    eng = tserve.ServeEngine(tlm, tparams, 4, 64, page_size=4, num_pages=24,
                             device="cpu", locality_chips=2,
                             fault_plan=tserve.FaultPlan.parse(plan),
                             watchdog_iters=16)
    for i, p, new in reqs:
        eng.submit(tserve.Request(i, np.asarray(p, np.int32),
                                  max_new_tokens=new))
    single = sorted([r.id, r.status, r.out_tokens, r.retries]
                    for r in eng.run_until_drained(max_iters=2000))
    faults = sorted(str(k) for k in eng.reg.counter(
        "serve_faults_injected_total").labels_values())
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(r), "2", str(port), str(path),
         plan], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=ROOT) for r in range(2)]
    try:
        outs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err
    for out, _ in outs:
        lines = dict(line.split(" ", 1) for line in out.splitlines()
                     if line.startswith(("OUT ", "FAULTS ")))
        assert json.loads(lines["OUT"]) == single
        assert json.loads(lines["FAULTS"]) == faults
    assert any(r[3] for r in single), "no stream was recovered"


# ------------------------------------------------------------ launcher ----

def _summary(text):
    """The launcher lines that carry no time: the outcome (up to the token
    count), tenancy, tenants, faults and the per-request lines."""
    keep = []
    for line in text.splitlines():
        if line.startswith("served "):
            keep.append(line.split(" in ")[0])
        elif line.startswith(("tenancy [", "  tenant ", "faults: ",
                              "  request ")):
            keep.append(line.split(", recovery p50")[0])
    return keep


def test_launcher_tenants_and_faults_match_jax_launcher(monkeypatch):
    """``--tenants chat=interactive,bulk=batch --quota bulk=8 --fault-plan
    nan_logits@3,poison_page@5 --watchdog-iters 8 --verify-cache``: the
    port's launcher on the JAX launcher's weights prints the JAX
    launcher's outcome, tenancy, fault and per-request lines.  Both read
    the pages through the gathered decode, the JAX launcher's default:
    its recovered stream re-takes the poisoned page, whose NaN rows past
    the position the gathered read lets through (K1 does not; see
    ``test_recycled_poisoned_page``)."""
    tparams = launcher_setup()[5]
    flags = ["--tenants", "chat=interactive,bulk=batch", "--quota", "bulk=8",
             "--fault-plan", "nan_logits@3,poison_page@5",
             "--watchdog-iters", "8", "--verify-cache"]
    monkeypatch.setattr(sys, "argv", ["serve"] + flags)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jlaunch.main()
    exp = _summary(buf.getvalue())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        eng = tlaunch.serve(tlaunch.parse_args(
            ["--device", "cpu", "--decode-impl", "gather"] + flags),
                            None, "cpu", params=tparams)
    got = _summary(buf.getvalue())
    assert got == exp, (got, exp)
    assert exp[0].startswith("served 16 requests (")
    assert any(line.startswith("faults: 2 injected") for line in got)
    assert eng.tenancy is not None and len(eng.fault_plan) == 2
