"""The port's serving health loop against the JAX engine's: ``ServeEngine``
with ``alerts=`` (an ``AlertManager`` over the engine's ``registry``),
``health_every`` and ``verify_cache=True`` runs ``serve_light_checks`` and
the alert rules at the same iterations as JAX's and reads the same gauges;
a hand-bumped dispatch counter ERRs ``dispatch_invariant`` and fires
``autopilot_err`` in both; the launcher prints "alerts fired:" only when one
fired; and the two Autopilot probes run on the CPU when asked for it.

Reduced qwen3-4b in fp32 on the JAX weights (``from_jax``), on the CPU."""
import math

import numpy as np
import pytest
import torch

from repro.core import alerts as jalerts
from repro.core.telemetry import MetricsRegistry as JMetricsRegistry
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.core import alerts as talerts
from repro_torch.core import health as thealth
from repro_torch.core.cluster import FailureKind, SimCluster
from repro_torch.core.telemetry import MetricsRegistry
from repro_torch.launch import serve as tlaunch
from repro_torch.serve import Request, ServeEngine
from repro_torch.serve.kvcache import CacheInvariantError
from test_torch_contiguous import _assert_streams_match, _workload, setup
from test_torch_tenancy import one_torch_thread  # noqa: F401

EVERY = 4


def _recording(alerts_module):
    """An ``AlertManager`` of ``alerts_module`` that keeps, at each of its
    evaluations, the registry's ``autopilot_*`` gauges."""
    class Recording(alerts_module.AlertManager):
        def __init__(self, reg):
            super().__init__(reg, sinks=[alerts_module.SlackSink()],
                             rules=alerts_module.DEFAULT_RULES
                             + alerts_module.SERVE_RULES)
            self.seen = []

        def evaluate(self):
            self.seen.append({name: dict(series) for name, series
                              in self.reg.snapshot().items()
                              if name.startswith("autopilot")})
            return super().evaluate()
    return Recording


def _engines(chunk: int):
    """The JAX engine and the port's over the same weights, each with its
    own recording alert manager, health checks every ``EVERY`` iterations
    and the allocator checked every iteration."""
    _, jlm, jparams, _, tlm, tparams = setup()
    kw = dict(max_batch=4, max_seq=32, page_size=4, num_pages=16,
              prefill_chunk=chunk, verify_cache=True, health_every=EVERY)
    jreg, treg = JMetricsRegistry(), MetricsRegistry()
    jeng = JServeEngine(jlm, jparams, registry=jreg,
                        alerts=_recording(jalerts)(jreg), **kw)
    teng = ServeEngine(tlm, tparams, device="cpu", registry=treg,
                       alerts=_recording(talerts)(treg), **kw)
    return jeng, teng, tlm, tparams


def _progress(eng):
    """The iteration of each live slot's last progress."""
    return {slot: eng._last_progress.get(slot)
            for slot, req in enumerate(eng.slot_req) if req is not None}


def _fired(eng):
    return [(a.rule, a.severity, a.message, a.labels)
            for a in eng.alerts.fired]


@pytest.mark.parametrize("chunk", [0, 4])
def test_health_loop_matches_jax_engine(chunk):
    """8 ragged requests through a tight 16-page pool, whole-prompt and in
    chunks of 4: equal streams (none by the tie rule), the checks at the
    same iterations with the same gauges at each, every serve check PASS,
    no alert.  Then one more request after the decode-dispatch counter is
    bumped by hand: ``dispatch_invariant`` ERRs and ``autopilot_err`` fires
    with the same message in both."""
    jeng, teng, tlm, tparams = _engines(chunk)
    work = _workload(tlm.cfg.vocab_size)
    for i, prompt, new in work:
        jeng.submit(JRequest(i, prompt, max_new_tokens=new))
        teng.submit(Request(i, prompt, max_new_tokens=new))
    # in lockstep: the progress clock of every live slot equal after each
    # iteration (admission, chunk landings and tokens advance it)
    for _ in range(500):
        live = jeng.step(), teng.step()
        assert live[0] == live[1]
        assert _progress(teng) == _progress(jeng)
        if not live[1] and not teng.queue:
            break
    assert not jeng.queue and all(r is None for r in jeng.slot_req)
    jout = {r.id: r.out_tokens for r in jeng.finished}
    tout = {r.id: r.out_tokens for r in teng.finished}
    ties = _assert_streams_match(tlm, tparams, {i: p for i, p, _ in work},
                                 tout, jout)
    print(f"chunk {chunk}: {ties} streams equal only by the tie rule")
    assert ties == 0
    assert teng._iter == jeng._iter
    checks = len(teng.alerts.seen)
    assert checks == len(jeng.alerts.seen) == math.ceil(teng._iter / EVERY)
    assert teng.alerts.seen == jeng.alerts.seen
    serve = {"dispatch_invariant", "streams_progressing", "cache_invariants"}
    for seen in teng.alerts.seen:
        assert {k.removeprefix("autopilot_serve_") for k in seen
                if k.startswith("autopilot_serve_")} == serve
        assert all(v == 1.0 for series in seen.values()
                   for v in series.values())
    assert _fired(teng) == _fired(jeng) == []
    assert teng._last_progress == {}
    # the control: one dispatch too many on the books
    for eng, req in ((jeng, JRequest), (teng, Request)):
        eng.reg.counter("serve_decode_dispatches_total").inc()
        eng.submit(req(99, work[0][1], max_new_tokens=6))
        eng.run_until_drained()
    assert teng.reg.gauge("autopilot_serve_dispatch_invariant").get() == 0.0
    assert _fired(teng) == _fired(jeng) == [(
        "autopilot_err", "warning",
        "health check serve_dispatch_invariant ERR on node serve",
        {"check": "serve_dispatch_invariant", "node": "serve"})]
    assert teng.alerts.seen == jeng.alerts.seen


def test_health_loop_off_by_default_and_stepless_checks():
    """Without ``alerts`` no check runs and no ``autopilot_*`` gauge
    appears; with a stalled live slot ``streams_progressing`` ERRs once the
    64-iteration window (no watchdog) has passed."""
    _, _, _, _, tlm, tparams = setup()
    eng = ServeEngine(tlm, tparams, max_batch=2, max_seq=32, page_size=4,
                      device="cpu")
    assert (eng.alerts, eng.health_every, eng.verify_cache,
            eng.watchdog_iters) == (None, 16, False, 0)
    eng.submit(Request(0, np.arange(5, dtype=np.int32), max_new_tokens=3))
    eng.run_until_drained()
    assert not any(k.startswith("autopilot")
                   for k in eng.reg.snapshot())
    eng.submit(Request(1, np.arange(6, dtype=np.int32), max_new_tokens=8))
    eng.step()
    assert thealth.serve_light_checks(eng)["streams_progressing"]
    eng._iter += 64                      # the slot made no progress since
    res = thealth.serve_light_checks(eng)
    assert res == {"dispatch_invariant": True, "streams_progressing": False}
    assert eng.reg.gauge("autopilot_node_ok").get(
        {"node": "serve", "check": "serve_streams_progressing"}) == 0.0


def test_verify_cache_checks_the_allocator_every_iteration():
    """``verify_cache=True`` runs ``kv.verify()`` after every iteration (no
    alerts wired, so no check runs), and a corrupted refcount stops the
    next iteration with ``CacheInvariantError``, as in the JAX engine."""
    _, _, _, _, tlm, tparams = setup()
    eng = ServeEngine(tlm, tparams, max_batch=2, max_seq=32, page_size=4,
                      device="cpu", verify_cache=True)
    calls = []
    verify = eng.kv.verify
    eng.kv.verify = lambda: (calls.append(eng._iter), verify())
    for i in range(3):
        eng.submit(Request(i, np.arange(5 + i, dtype=np.int32),
                           max_new_tokens=4))
    eng.run_until_drained()
    assert calls == list(range(eng._iter))
    eng.submit(Request(3, np.arange(7, dtype=np.int32), max_new_tokens=4))
    eng.step()
    eng.kv._ref[eng.kv._slot_pages[0][0]] += 1
    with pytest.raises(CacheInvariantError, match="refcounts drifted"):
        eng.step()


def _serve_args(extra=()):
    return tlaunch.parse_args(["--device", "cpu", "--reduced", "--requests",
                               "3", "--max-batch", "2", "--max-seq", "32",
                               "--new-tokens", "3", *extra])


def test_launcher_prints_alerts_only_when_one_fires(capsys, monkeypatch):
    tlaunch.serve(_serve_args(["--verify-cache"]), None, "cpu")
    out = capsys.readouterr().out
    assert "served 3 requests (3 completed)" in out
    assert "alerts fired:" not in out

    step = ServeEngine._step

    def one_dispatch_too_many(self):
        live = step(self)
        if self._iter == 0:               # before the first check
            self.reg.counter("serve_decode_dispatches_total").inc()
        return live

    monkeypatch.setattr(ServeEngine, "_step", one_dispatch_too_many)
    eng = tlaunch.serve(_serve_args(), None, "cpu")
    out = capsys.readouterr().out
    assert eng.alerts is not None and eng.health_every == 16
    assert out.endswith(
        "alerts fired:\n  :rotating_light: [WARNING] autopilot_err: health "
        "check serve_dispatch_invariant ERR on node serve\n")


# ---------------------------------------------------------------- probes ----

def test_probes_on_the_cpu_when_asked():
    """``measure_real=True`` on the CPU: both probes read positive, finite
    values, every check passes; a power brake and a PCIe downgrade read
    0.375x and 0.3x of those baselines and ERR."""
    for probe in (thealth._measure_gemm_gflops, thealth._measure_h2d_gbps):
        v = probe(device="cpu")
        assert math.isfinite(v) and v > 0
    reg = MetricsRegistry()
    cl = SimCluster(1, registry=reg)
    ap = thealth.Autopilot(cl, reg, measure_real=True, device="cpu")
    assert ap.device == torch.device("cpu")
    res = {r.name: r for r in ap.run_checks()}
    assert all(r.passed for r in res.values())
    base = {k: res[k].value for k in ("gpu_dgemm_gflops", "pcie_h2d_gbps")}
    assert all(math.isfinite(v) and v > 0 for v in base.values())
    mgr = talerts.AlertManager(reg, rules=talerts.DEFAULT_RULES
                               + talerts.SERVE_RULES)
    assert mgr.evaluate() == []
    cl.inject(0, FailureKind.POWER_BRAKE)
    cl.inject(0, FailureKind.PCIE_DEGRADE)
    res = {r.name: r for r in ap.run_checks()}
    assert res["gpu_dgemm_gflops"].value == base["gpu_dgemm_gflops"] * 0.375
    assert res["pcie_h2d_gbps"].value == base["pcie_h2d_gbps"] * 0.3
    assert not res["gpu_dgemm_gflops"].passed
    assert not res["pcie_h2d_gbps"].passed
    assert {a.labels["check"] for a in mgr.evaluate()
            if a.rule == "autopilot_err"} == {"gpu_dgemm_gflops",
                                              "pcie_h2d_gbps"}
