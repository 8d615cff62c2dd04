"""The fault-tolerant training runtime of the port (counterpart of the JAX
``repro.core.runtime``): cluster sim + scheduler + autopilot + alerting +
Young-interval checkpointing composed into a job lifecycle (§2.3 end to
end).  ``simulate_job`` validates the paper's headline claim (<10% of wall
time lost to failures) under the paper's own failure rates on a virtual
clock, touching no device; ``FTTrainLoop`` applies the same mechanics to a
real train step with real file checkpoints.

The port's train steps update the state in place, so a restart cannot go
back to a state object that training has since changed: the loop takes a
function that builds the initial state, and calls it again for a restart
that comes before the first checkpoint.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.core.alerts import AlertManager, SlackSink
from repro_torch.core.checkpoint import (latest_step, load_checkpoint,
                                         save_checkpoint)
from repro_torch.core.cluster import DEFAULT_RATES, FailureKind, SimCluster
from repro_torch.core.health import Autopilot
from repro_torch.core.scheduler import GangScheduler, Job, JobState
from repro_torch.core.straggler import StragglerDetector
from repro_torch.core.telemetry import MetricsRegistry
from repro_torch.core.youngs import young_interval

# failure kinds that stop the job outright
_CRASH_KINDS = (FailureKind.HOST_CRASH, FailureKind.CUDA_ERROR)


@dataclass
class GoodputReport:
    total_s: float = 0.0
    useful_s: float = 0.0
    checkpoint_s: float = 0.0
    recompute_s: float = 0.0
    detection_s: float = 0.0
    restart_s: float = 0.0
    degraded_s: float = 0.0       # extra time spent running slow
    queue_s: float = 0.0          # waiting for nodes
    steps_done: int = 0
    restarts: int = 0
    node_swaps: int = 0
    failures: Dict[str, int] = field(default_factory=dict)
    checkpoint_interval_steps: int = 0

    @property
    def lost_fraction(self) -> float:
        return 1.0 - self.useful_s / self.total_s if self.total_s else 0.0

    def summary(self) -> str:
        f = self
        return (f"total={f.total_s/3600:.1f}h useful={f.useful_s/3600:.1f}h "
                f"lost={f.lost_fraction*100:.1f}% "
                f"(ckpt={f.checkpoint_s/3600:.2f}h "
                f"recompute={f.recompute_s/3600:.2f}h "
                f"detect={f.detection_s/3600:.2f}h "
                f"restart={f.restart_s/3600:.2f}h "
                f"degraded={f.degraded_s/3600:.2f}h "
                f"queue={f.queue_s/3600:.2f}h) "
                f"restarts={f.restarts} swaps={f.node_swaps}")


def job_mtbf_seconds(n_nodes: int,
                     rates: Optional[Dict[FailureKind, float]] = None
                     ) -> float:
    """Mean seconds between job-stopping failures on ``n_nodes`` nodes:
    only the crash kinds of ``rates`` (default ``DEFAULT_RATES``) count;
    the degrading kinds slow a job down without stopping it."""
    rates = rates or DEFAULT_RATES
    crash_rate = sum(r for k, r in rates.items() if k in _CRASH_KINDS)
    return 1.0 / (crash_rate * n_nodes)


def simulate_job(n_cluster_nodes: int = 110, job_nodes: int = 96,
                 total_steps: int = 200_000, base_step_time: float = 5.0,
                 ckpt_write_seconds: float = 90.0,
                 detection_latency: float = 120.0,
                 restart_overhead: float = 600.0,
                 straggler_factor: float = 1.25,
                 buffer_fraction: float = 0.10,
                 seed: int = 0,
                 registry: Optional[MetricsRegistry] = None,
                 rates=None) -> GoodputReport:
    """Virtual-time simulation of one long training job under the paper's
    failure model.  Checkpoint interval = Young's formula."""
    reg = registry or MetricsRegistry()
    cluster = SimCluster(n_cluster_nodes, seed=seed, registry=reg,
                         rates=rates)
    sched = GangScheduler(cluster, buffer_fraction, reg)
    detector = StragglerDetector(reg, factor=straggler_factor)
    alerts = AlertManager(reg, sinks=[SlackSink()])
    autopilot = Autopilot(cluster, reg)

    mtbf = job_mtbf_seconds(job_nodes, rates)
    interval_s = young_interval(ckpt_write_seconds, mtbf)
    ckpt_every = max(1, round(interval_s / base_step_time))

    job = Job("train", job_nodes, rerunnable=True)
    sched.submit(job)

    rep = GoodputReport(checkpoint_interval_steps=ckpt_every)
    step = 0
    last_ckpt_step = 0
    check_every_steps = max(1, round(600.0 / base_step_time))  # 10-min checks

    while step < total_steps:
        if job.state != JobState.RUNNING:
            # wait for repairs / scheduling
            cluster.advance(60.0)
            rep.total_s += 60.0
            rep.queue_s += 60.0
            sched.schedule()
            continue

        perf = cluster.job_perf_factor(job.nodes)
        crashed = cluster.crashed_in(job.nodes)
        if crashed or perf == 0.0:
            # --- crash path: detect -> requeue -> restore -> recompute ------
            rep.total_s += detection_latency
            rep.detection_s += detection_latency
            cluster.advance(detection_latency)
            for n in (crashed or job.nodes[:1]):
                sched.on_node_failure(n)
            alerts.evaluate()
            rep.total_s += restart_overhead
            rep.restart_s += restart_overhead
            cluster.advance(restart_overhead)
            recompute_steps = step - last_ckpt_step
            rep.recompute_s += recompute_steps * base_step_time
            rep.total_s += recompute_steps * base_step_time
            cluster.advance(recompute_steps * base_step_time)
            step = last_ckpt_step + recompute_steps  # recompute is not useful
            rep.restarts += 1
            continue

        # --- run one step at the slowest node's speed -----------------------
        dt = base_step_time / perf
        cluster.advance(dt)
        rep.total_s += dt
        rep.useful_s += base_step_time
        rep.degraded_s += dt - base_step_time
        detector.observe_step(dt)
        step += 1
        rep.steps_done = step

        # --- periodic health checks + straggler mitigation ------------------
        # proactive posture (§2.3.2): autopilot localizes the bad node even
        # when the step-time baseline is already polluted by the slowdown
        if step % check_every_steps == 0:
            autopilot.run_checks(node_ids=job.nodes, busy=job.nodes)
            detector.check(cluster, job.nodes)   # exported for alerting
            degraded = cluster.degraded_in(job.nodes)
            if degraded:
                if sched.replace_degraded(job.id, degraded):
                    rep.node_swaps += len(degraded)
                    rep.total_s += restart_overhead
                    rep.restart_s += restart_overhead
                    cluster.advance(restart_overhead)
                    recompute_steps = step - last_ckpt_step
                    rep.recompute_s += recompute_steps * base_step_time
                    rep.total_s += recompute_steps * base_step_time
                    cluster.advance(recompute_steps * base_step_time)
            alerts.evaluate()

        # --- Young-interval checkpoint --------------------------------------
        if step - last_ckpt_step >= ckpt_every:
            rep.total_s += ckpt_write_seconds
            rep.checkpoint_s += ckpt_write_seconds
            cluster.advance(ckpt_write_seconds)
            last_ckpt_step = step

    rep.failures = {k.value: sum(1 for e in cluster.events if e.kind == k)
                    for k in FailureKind}
    return rep


class FTTrainLoop:
    """Wraps a train step with checkpoint/restart + failure injection.
    ``run`` survives injected failures by restoring the latest checkpoint;
    loss trajectories with and without failures agree (the data order is
    a function of the step).

    ``init_state()`` builds the starting state; it runs when there is no
    checkpoint to resume.  Metrics: ``train_step_seconds`` (host clock
    around a step and the read of its metrics, which waits for the device),
    ``job_restarts``, ``checkpoints_written``."""

    def __init__(self, train_step: Callable, init_state: Callable[[], Dict],
                 ckpt_dir: str, ckpt_every: int,
                 registry: Optional[MetricsRegistry] = None,
                 uploader: Optional[Callable] = None):
        self.train_step = train_step
        self.init_state = init_state
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.reg = registry or MetricsRegistry()
        self.uploader = uploader
        self.metrics_log: List[Dict] = []
        self.restarts = 0
        self._fired: set = set()

    def _restore_or_init(self, state=None):
        """The latest checkpoint, restored like ``state`` (or like a fresh
        initial state), or the initial state if there is none."""
        if latest_step(self.ckpt_dir) is None:
            return self.init_state(), 0
        return load_checkpoint(self.ckpt_dir,
                               template=state or self.init_state())

    def run(self, batches: Callable[[int], Dict], total_steps: int,
            fail_at: Optional[Callable[[int], bool]] = None):
        """``batches(step)`` yields the batch for a step.  ``fail_at(step)``
        True simulates a host crash at that step (once per step): progress
        since the last checkpoint is discarded and the loop restarts."""
        state, step = self._restore_or_init()
        while step < total_steps:
            if (fail_at is not None and fail_at(step)
                    and step not in self._fired):
                self._fired.add(step)
                self.restarts += 1
                self.reg.counter("job_restarts").inc()
                state, step = self._restore_or_init(state)
                continue
            t0 = time.perf_counter()
            state, metrics = self.train_step(state, batches(step))
            metrics = {k: float(v) for k, v in metrics.items()}
            self.reg.histogram("train_step_seconds").observe(
                time.perf_counter() - t0)
            self.metrics_log.append({"step": step, **metrics})
            step += 1
            if step % self.ckpt_every == 0:
                save_checkpoint(self.ckpt_dir, state, step,
                                uploader=self.uploader)
                self.reg.counter("checkpoints_written").inc()
        return state
