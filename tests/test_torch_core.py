"""The port's ``repro_torch.core`` against the JAX package's ``repro.core``:
the infrastructure simulators (failure model, gang scheduler, tenancy,
storage tiers, straggler detector, anomaly detector, alert rules, Autopilot
in simulation, the goodput simulation), the collective cost model, Young's
formulas and the metrics registry.

Each test runs one scenario through both packages and compares what comes
out exactly: both sides run the same float64 host arithmetic in the same
order, over the same numpy ``default_rng`` streams.  Enums are compared by
value (each package has its own).  Runs on the CPU, in a few seconds."""
import importlib
import math
from types import SimpleNamespace

import numpy as np
import pytest

import repro.core as jcore
import repro_torch.core as tcore

NAMES = ("aiops", "alerts", "clock", "cluster", "health", "netmodel",
         "runtime", "scheduler", "storage", "straggler", "telemetry",
         "tenancy", "youngs")


def _package(root: str) -> SimpleNamespace:
    return SimpleNamespace(**{n: importlib.import_module(f"{root}.core.{n}")
                              for n in NAMES})


J, T = _package("repro"), _package("repro_torch")
BOTH = (J, T)


def _both(scenario, *args):
    """The scenario's trace from each package; equal, and not empty."""
    want, got = (scenario(m, *args) for m in BOTH)
    assert got == want
    assert got
    return got


def _scaled(m, factor: float):
    return {k: r * factor for k, r in m.cluster.DEFAULT_RATES.items()}


# -------------------------------------------------------------- exports ----

def test_core_exports_every_name_of_jax():
    ns = {}
    exec("from repro_torch.core import *", ns)
    assert set(jcore.__all__) <= set(ns)
    assert sorted(tcore.__all__) == sorted(jcore.__all__)
    assert isinstance(tcore.GLOBAL_REGISTRY, tcore.MetricsRegistry)
    for m in BOTH:
        kinds = [(k.name, k.value) for k in m.cluster.FailureKind]
        assert kinds == [(k.name, k.value) for k in J.cluster.FailureKind]


# ------------------------------------------------------ MTBF and Young's ----

@pytest.mark.parametrize("rates", ["default", "table", "table x5"])
def test_job_mtbf_matches_jax(rates):
    """Only the crash kinds count toward a job's MTBF.  The port used to sum
    every rate it was given, 3.75x too many failures with the full table."""
    def scenario(m):
        r = {"default": None, "table": m.cluster.DEFAULT_RATES,
             "table x5": _scaled(m, 5.0)}[rates]
        mtbf = m.runtime.job_mtbf_seconds(96, rates=r)
        return [mtbf, m.youngs.young_interval(90.0, mtbf),
                m.youngs.checkpoint_every_n_steps(90.0, mtbf, 5.0)]
    mtbf = _both(scenario)[0]
    month = 30 * 24 * 3600.0
    per_node = {"default": 0.04, "table": 0.04, "table x5": 0.2}[rates]
    assert mtbf == pytest.approx(month / (per_node * 96), rel=1e-12)


@pytest.mark.parametrize("delta,mtbf,interval", [
    (90.0, 675_000.0, 3600.0), (90.0, 675_000.0, 11_022.7),
    (1.0, 3600.0, 1.0), (300.0, 86_400.0, 1e5)])
def test_lost_fraction_matches_jax(delta, mtbf, interval):
    def scenario(m):
        return [m.youngs.lost_fraction(delta, mtbf, interval),
                m.youngs.optimal_lost_fraction(delta, mtbf),
                m.youngs.young_interval(delta, mtbf)]
    lost, best, _ = _both(scenario)
    assert best == pytest.approx(math.sqrt(2 * delta / mtbf), rel=1e-12)
    assert lost >= best - 1e-15


# ----------------------------------------------------- cluster and clock ----

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sim_cluster_events_match_jax(seed):
    """A 16-node fleet at 2000x the paper's rates, advanced an hour at a
    time for two days; crashed nodes go to repair every 6 hours."""
    def scenario(m):
        reg = m.telemetry.MetricsRegistry()
        cl = m.cluster.SimCluster(16, seed=seed, rates=_scaled(m, 2000.0),
                                  registry=reg)
        trace = []
        for hour in range(48):
            cl.advance(3600.0)
            if hour % 6 == 5:
                for i in cl.crashed_in(list(range(16))):
                    if cl.nodes[i].state != m.cluster.NodeState.REPAIRING:
                        cl.start_repair(i)
            trace.append([(n.state.value, n.perf_factor, n.repair_done_at)
                          for n in cl.nodes])
            trace.append([cl.job_perf_factor(list(range(8))),
                          cl.degraded_in(list(range(16))),
                          [n.id for n in cl.healthy_nodes()]])
        events = [(e.t, e.node_id, e.kind.value) for e in cl.events]
        return [events, trace, reg.render()]
    events = _both(scenario)[0]
    assert len({k for _, _, k in events}) >= 3


def test_clocks_match_jax():
    def scenario(m):
        clock = m.clock.VirtualClock(start=5.0)
        seen = [clock.now()]
        for dt in (0.0, 1.5, 1e-3, 3600.0):
            clock.advance(dt)
            seen.append(clock.now())
        wall = m.clock.WallClock()
        t0 = wall.now()
        wall.advance(0.0)
        return [seen, wall.now() >= t0]
    _both(scenario)
    with pytest.raises(AssertionError):
        T.clock.VirtualClock().advance(-1.0)


# ------------------------------------------------------------- scheduler ----

def _job_states(sched):
    return sorted((j.id, j.state.value, list(j.nodes), j.n_nodes, j.restarts,
                   j.priority) for j in sched.jobs.values())


def test_gang_scheduler_states_match_jax():
    """Submit (one job waits on the buffer), a failure that requeues a
    rerunnable job and fails another, a degraded swap, an elastic resize,
    completions; the states after every operation."""
    def scenario(m):
        reg = m.telemetry.MetricsRegistry()
        cl = m.cluster.SimCluster(24, seed=3, registry=reg)
        fk = m.cluster.FailureKind
        s = m.scheduler.GangScheduler(cl, buffer_fraction=0.10, registry=reg)
        trace = []

        def snap(what):
            trace.append((what, _job_states(s), list(s.queue),
                          s.buffer_size(), s.buffer_target,
                          sorted(s.free_healthy())))

        s.submit(m.scheduler.Job("a", 12))
        s.submit(m.scheduler.Job("b", 6, rerunnable=False, priority=2))
        s.submit(m.scheduler.Job("c", 5))
        snap("submitted")
        victim = s.jobs["a"].nodes[2]
        cl.inject(victim, fk.HOST_CRASH)
        s.on_node_failure(victim)
        snap("a failed")
        cl.inject(s.jobs["b"].nodes[0], fk.CUDA_ERROR)
        s.on_node_failure(s.jobs["b"].nodes[0])
        snap("b failed")
        bad = [s.jobs["a"].nodes[0], s.jobs["a"].nodes[5]]
        for n in bad:
            cl.inject(n, fk.PCIE_DEGRADE)
        trace.append(s.replace_degraded("a", bad))
        snap("a swapped")
        trace.append(s.replace_degraded("a", s.jobs["a"].nodes[:9]))
        s.elastic_resize("a", 8)
        snap("a resized")
        s.complete("a")
        snap("a done")
        s.schedule()
        snap("rescheduled")
        trace.append(reg.render())
        return trace
    trace = _both(scenario)
    assert trace[-2][1][0][1] == "done"


# --------------------------------------------------------------- tenancy ----

def test_tenant_scheduler_matches_jax():
    def scenario(m):
        reg = m.telemetry.MetricsRegistry()
        cl = m.cluster.SimCluster(20, seed=0)
        ts = m.tenancy.TenantScheduler(
            m.scheduler.GangScheduler(cl, buffer_fraction=0.0), registry=reg)
        ts.create_namespace("train", 12, priority=5)
        ts.create_namespace("serve", 6)
        out = [ts.submit("train", m.scheduler.Job("j1", 10)),
               ts.submit("train", m.scheduler.Job("j2", 3)),
               ts.submit("serve", m.scheduler.Job("s1", 4, priority=1)),
               ts.usage_report()]
        ts.resize_namespace("train", 14)
        out.append(ts.submit("train", m.scheduler.Job("j3", 3)))
        ts.complete("j1")
        out += [ts.usage_report(), _job_states(ts.sched),
                [(n.name, n.quota_nodes, n.used_nodes, n.priority,
                  n.available) for n in ts.namespaces.values()]]
        for bad in (lambda: ts.create_namespace("x", 1),
                    lambda: ts.resize_namespace("serve", 3)):
            try:
                bad()
                out.append("accepted")
            except AssertionError as e:
                out.append(str(e))
        out.append([(c.name, c.priority, c.preemptible, c.prefill_budget)
                    for c in m.tenancy.DEFAULT_CLASSES.values()])
        out.append((m.tenancy.INTERACTIVE.name, m.tenancy.BATCH.name))
        out.append(reg.render())
        return out
    out = _both(scenario)
    assert out[:3] == [True, False, True]


# --------------------------------------------------------------- storage ----

@pytest.mark.parametrize("tier", ["scale", "nfs", "cos"])
def test_storage_op_times_match_jax(tier):
    """Dataset reads (misses, then hits on the cache tier) and checkpoint
    writes through one tier, with the tiers' seeded jitter; the AFM drain
    on its own clock; LRU eviction of clean entries in a small cache."""
    def scenario(m):
        reg = m.telemetry.MetricsRegistry()
        clock = m.clock.VirtualClock()
        st = m.storage.StorageStack(clock, registry=reg, seed=4)
        for i in range(6):
            st.cos.write(f"shard{i}", (i + 1) * 250_000_000)
        times = []
        for epoch in range(3):
            for i in range(6):
                times.append(st.dataset_read(f"shard{i}", tier))
            times.append(st.checkpoint_write(f"ckpt{epoch}", 3_000_000_000,
                                             tier))
        times += [st.scale.drain_async(), clock.now(),
                  st.scale.async_clock.now(), st.scale.used]
        small = m.storage.ScaleCache(st.cos, clock, capacity_bytes=1e9,
                                     registry=reg, seed=9)
        for i in (0, 1, 2, 0, 3):
            times.append(small.read(f"shard{i}"))
        small.write("dirty", 400_000_000)
        times += [list(small.lru), sorted(small.dirty), small.used,
                  small.drain_async(), clock.now()]
        spec = [(s.name, s.read_bw, s.write_bw, s.latency, s.jitter)
                for s in (m.storage.COS, m.storage.NFS, m.storage.SCALE)]
        return [times, spec, reg.render()]
    _both(scenario)


# ------------------------------------------------------------- straggler ----

@pytest.mark.parametrize("slow", [1.0, 1.2, 1.0 / 0.375])
def test_straggler_reports_match_jax(slow):
    def scenario(m):
        reg = m.telemetry.MetricsRegistry()
        cl = m.cluster.SimCluster(8, seed=0, registry=reg)
        det = m.straggler.StragglerDetector(reg, factor=1.25)
        reports = [det.check(cl, list(range(8)))]
        rng = np.random.default_rng(11)
        for _ in range(12):
            det.observe_step(5.0 + float(rng.normal(0, 0.05)))
        cl.inject(4, m.cluster.FailureKind.POWER_BRAKE)
        cl.inject(6, m.cluster.FailureKind.PORT_FAILURE)
        for _ in range(5):
            det.observe_step(5.0 * slow + float(rng.normal(0, 0.05)))
            reports.append(det.check(cl, list(range(8))))
        reports.append(det.check())
        return [(r.detected, r.slowdown, r.suspect_nodes, r.reason)
                for r in reports]
    reports = _both(scenario)
    assert any(r[0] for r in reports) == (slow > 1.25)


# -------------------------------------------------------------- netmodel ----

@pytest.mark.parametrize("proto", ["tcp", "roce", "gdr", "ici"])
def test_netmodel_curves_match_jax(proto):
    sizes = [2 ** k for k in range(10, 34, 2)]
    counts = [1, 2, 8, 64, 256, 1024]

    def scenario(m):
        nm = m.netmodel
        p = nm.PROTOCOLS[proto]
        return [(p.name, p.bus_bw, p.alpha),
                nm.scaling_curve(p, sizes, 1024),
                nm.gpu_count_curve(p, 8e6, counts),
                [nm.alg_bandwidth(s, 64, p) for s in sizes],
                [nm.allgather_time(s, n, p) for s in sizes for n in counts],
                [nm.allreduce_time(s, n, p) for s in sizes for n in counts],
                nm.job_step_network_seconds(4 * 3.8e9, 96, p)]
    _both(scenario)


# ----------------------------------------------------------------- aiops ----

def test_anomaly_detector_matches_jax():
    """A seeded series with a persistent excursion and a single spike; then
    a registry scan over gauges that drift."""
    rng = np.random.default_rng(21)
    series = 100.0 + rng.normal(0, 2.0, 120)
    series[60:66] += 40.0                  # persistent: must be flagged
    series[90] -= 50.0                     # single sample: must not be

    def scenario(m):
        det = m.aiops.AnomalyDetector(window=32, persistence=3)
        out = []
        for i, v in enumerate(series):
            a = det.observe("pcie_h2d_gbps", {"node": "3"}, float(v))
            if a is not None:
                out.append((i, a.metric, a.labels, a.value, a.zscore,
                            a.message))
        return [out, _anomaly_scan(m, m.telemetry.MetricsRegistry())]
    out, scan = _both(scenario)
    assert {i for i, *_ in out} <= set(range(60, 66)) and out
    assert {labels["node"] for _, _, labels, _, _ in scan} == {"1"}


def _anomaly_scan(m, reg):
    """Three nodes' perf-factor gauges, node 1's dropping at t = 16,
    scanned every tick; the anomalies found."""
    det = m.aiops.AnomalyDetector(min_history=4, persistence=2)
    found = []
    for t in range(24):
        for node in range(3):
            drift = 5.0 if (node == 1 and t >= 16) else 0.0
            reg.gauge("node_perf_factor").set(
                1.0 - 0.01 * ((t * 7 + node) % 3) - drift,
                {"node": str(node)})
        found += [(t, a.metric, a.labels, a.zscore, a.message)
                  for a in det.scan_registry(reg)]
    return found


# ---------------------------------------------------------------- alerts ----

def _alert_registry(m):
    """One registry that trips every rule of DEFAULT_RULES + SERVE_RULES
    once, and some series that must not trip them."""
    reg = m.telemetry.MetricsRegistry()
    reg.gauge("node_perf_factor").set(0.0, {"node": "3"})
    reg.gauge("node_perf_factor").set(0.375, {"node": "4"})
    reg.gauge("autopilot_node_ok").set(0.0, {"node": "4",
                                             "check": "gpu_dgemm_gflops"})
    reg.gauge("autopilot_node_ok").set(1.0, {"node": "5",
                                             "check": "pcie_h2d_gbps"})
    for i in range(12):
        reg.histogram("pcie_bw_sample").observe(9.0 + 0.1 * i, {"node": "7"})
        reg.histogram("pcie_bw_sample").observe(25.0, {"node": "8"})
    for i in range(16):
        reg.histogram("train_step_seconds").observe(5.0 if i < 15 else 14.0,
                                                    {"job": "train"})
    reg.counter("cuda_errors_total").inc(2, {"node": "2"})
    reg.counter("serve_dead_letter_total").inc(0)          # unlabelled: no
    reg.counter("serve_dead_letter_total").inc(3, {"reason": "retries"})
    reg.counter("serve_stream_retries_total").inc(9, {"reason": "nan"})
    reg.counter("serve_stream_retries_total").inc(2, {"reason": "stall"})
    return reg


def test_alert_manager_fires_the_same_alerts():
    def scenario(m):
        reg = _alert_registry(m)
        slack, log = m.alerts.SlackSink(), m.alerts.LogSink()
        mgr = m.alerts.AlertManager(
            reg, sinks=[slack, log],
            rules=m.alerts.DEFAULT_RULES + m.alerts.SERVE_RULES)
        first = mgr.evaluate()
        again = mgr.evaluate()                 # deduplicated
        reg.gauge("node_perf_factor").set(0.0, {"node": "9"})
        third = mgr.evaluate()
        return [[(a.rule, a.severity, a.message, a.labels)
                 for a in mgr.fired], len(first), len(again), len(third),
                slack.messages, [a.rule for a in log.records],
                [r.name for r in mgr.rules]]
    fired = _both(scenario)[0]
    # pcie_degraded and step_time_regression list a histogram's series
    # through labels_values(), which observe() never fills in either
    # package: they cannot fire (ROADMAP Queue 3)
    assert {a[0] for a in fired} == {
        "node_down", "autopilot_err", "gpu_cuda_error", "serve_dead_letter",
        "serve_retry_storm"}


# ------------------------------------------- Autopilot (simulation) -----

def test_autopilot_simulated_checks_match_jax():
    """Simulated probes (``measure_real=False``): each check reads its
    baseline scaled by the failures it is sensitive to; intrusive checks
    skip busy nodes.  No device is touched."""
    def scenario(m):
        reg = m.telemetry.MetricsRegistry()
        cl = m.cluster.SimCluster(8, seed=0, registry=reg)
        fk = m.cluster.FailureKind
        for node, kind in ((1, fk.POWER_BRAKE), (2, fk.PCIE_DEGRADE),
                           (2, fk.POWER_BRAKE), (3, fk.PORT_FAILURE),
                           (4, fk.ROW_REMAP), (5, fk.HOST_CRASH)):
            cl.inject(node, kind)
        ap = m.health.Autopilot(cl, reg)
        out = []
        for node_ids, busy in ((None, None), ([0, 1, 2, 4], [1, 4]),
                               ([5, 6], [])):
            res = ap.run_checks(node_ids=node_ids, busy=busy)
            out.append([(r.name, r.node_id, r.value, r.passed, r.unit)
                        for r in res])
            out.append(ap.err_nodes(res))
        mgr = m.alerts.AlertManager(reg)
        out.append([(a.rule, a.message) for a in mgr.evaluate()])
        out.append(reg.render())
        return out
    out = _both(scenario)
    assert out[1] == [1, 2, 3, 4, 5]
    assert T.health.Autopilot(T.cluster.SimCluster(1),
                              T.telemetry.MetricsRegistry()).device is None


# ------------------------------------------------ goodput simulation -----

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_simulate_job_matches_jax(seed):
    """An 8-node job on a 40-node fleet for 2,000 steps at 1000x the
    paper's rates, so that crashes restart it and degraded nodes are
    swapped: every report field, the failure counts, the registry and the
    dashboard equal JAX's."""
    def scenario(m):
        reg = m.telemetry.MetricsRegistry()
        rep = m.runtime.simulate_job(n_cluster_nodes=40, job_nodes=8,
                                     total_steps=2000, seed=seed,
                                     registry=reg, rates=_scaled(m, 1000.0))
        fields = {k: v for k, v in vars(rep).items()}
        return [fields, rep.lost_fraction, rep.summary(), reg.render(),
                m.aiops.render_dashboard(reg, "goodput")]
    fields = _both(scenario)[0]
    assert fields["restarts"] >= 1 and fields["node_swaps"] >= 1
    assert fields["steps_done"] == 2000
    assert sum(fields["failures"].values()) > 0


def test_registry_render_matches_jax():
    def scenario(m):
        reg = m.telemetry.MetricsRegistry()
        reg.counter("c", "a counter").inc(2, {"a": "x"})
        reg.counter("c").inc(3.5, {"a": "x"})
        reg.counter("c").inc(1)
        reg.gauge("g", "a gauge").set(1.5, {"node": "1", "check": "ping"})
        reg.gauge("g").inc(0.25)
        h = reg.histogram("h", buckets=(0.1, 1.0, float("inf")))
        for v in (0.05, 0.2, 0.3, 10.0):
            h.observe(v, {"tier": "scale"})
        return [reg.render(), h.count({"tier": "scale"}),
                h.sum({"tier": "scale"}), h.quantile(0.5, {"tier": "scale"}),
                h.recent(2, {"tier": "scale"}),
                sorted(reg.snapshot().items()),
                m.aiops.render_dashboard(reg)]
    _both(scenario)
