"""LSF/MCAD-style gang scheduler with a buffer pool (§2.3.1, §3.2.2).

Semantics reproduced from the paper:
  * gang allocation: a job runs only when its full node count is available;
  * ~10% of nodes kept as a hot buffer so failed jobs restart at full size
    immediately; the buffer is replenished as repairs complete;
  * rerunnable jobs are requeued on node failure (LSF ``rerunnable``),
    non-rerunnable jobs are lost;
  * failed nodes enter a repair queue (vendor RMA vs quick reboot times);
  * priority scheduling with optional preemption of lower-priority jobs.

A copy of the JAX package's ``core/scheduler.py``.
"""
from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.cluster import NodeState, SimCluster
from repro_torch.core.telemetry import MetricsRegistry


class JobState(enum.Enum):
    PENDING = "pending"
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"


@dataclass
class Job:
    id: str
    n_nodes: int
    rerunnable: bool = True
    priority: int = 0
    state: JobState = JobState.PENDING
    nodes: List[int] = field(default_factory=list)
    restarts: int = 0
    preemptions: int = 0


class GangScheduler:
    def __init__(self, cluster: SimCluster, buffer_fraction: float = 0.10,
                 registry: Optional[MetricsRegistry] = None):
        self.cluster = cluster
        self.buffer_fraction = buffer_fraction
        self.jobs: Dict[str, Job] = {}
        self.queue: List[str] = []
        self.reg = registry
        self._allocated: set = set()

    # ------------------------------------------------------------- public ----
    def submit(self, job: Job):
        assert job.id not in self.jobs
        self.jobs[job.id] = job
        self.queue.append(job.id)
        self.schedule()

    @property
    def buffer_target(self) -> int:
        return max(1, int(self.buffer_fraction * len(self.cluster.nodes)))

    def free_healthy(self) -> List[int]:
        return [n.id for n in self.cluster.healthy_nodes()
                if n.id not in self._allocated]

    def schedule(self):
        """FIFO within priority; keep the buffer for restarts: new PENDING
        jobs may not dip into the last ``buffer_target`` free nodes, but a
        RESTARTING job (restarts>0) may — that is what the buffer is for."""
        for jid in sorted(self.queue,
                          key=lambda j: (-self.jobs[j].priority,)):
            job = self.jobs[jid]
            free = self.free_healthy()
            usable = (len(free) if job.restarts > 0
                      else len(free) - self.buffer_target)
            if usable >= job.n_nodes:
                job.nodes = free[:job.n_nodes]
                self._allocated.update(job.nodes)
                job.state = JobState.RUNNING
                self.queue.remove(jid)
                if self.reg:
                    self.reg.counter("scheduler_job_starts").inc(
                        1, {"job": jid})

    def on_node_failure(self, node_id: int):
        """Failure detected: repair the node, requeue affected rerunnable
        jobs at restart priority."""
        self.cluster.start_repair(node_id)
        self._allocated.discard(node_id)
        for job in self.jobs.values():
            if job.state == JobState.RUNNING and node_id in job.nodes:
                self._release(job)
                if job.rerunnable:
                    job.state = JobState.PENDING
                    job.restarts += 1
                    self.queue.insert(0, job.id)
                else:
                    job.state = JobState.FAILED
                if self.reg:
                    self.reg.counter("scheduler_job_interrupts").inc(
                        1, {"job": job.id})
        self.schedule()

    def replace_degraded(self, job_id: str, bad_nodes: List[int]) -> bool:
        """Straggler mitigation: swap degraded nodes from the buffer pool
        without changing job size.  Returns True if fully replaced."""
        job = self.jobs[job_id]
        free = self.free_healthy()
        if len(free) < len(bad_nodes):
            return False
        for bad in bad_nodes:
            new = free.pop(0)
            job.nodes[job.nodes.index(bad)] = new
            self._allocated.discard(bad)
            self._allocated.add(new)
            self.cluster.start_repair(bad)
        job.restarts += 1
        if self.reg:
            self.reg.counter("scheduler_node_swaps").inc(
                len(bad_nodes), {"job": job_id})
        return True

    def complete(self, job_id: str):
        job = self.jobs[job_id]
        job.state = JobState.DONE
        self._release(job)
        self.schedule()

    def elastic_resize(self, job_id: str, n_nodes: int):
        """Elastic scaling: restart the job at a different gang size (the
        checkpoint reshard on restore makes this transparent)."""
        job = self.jobs[job_id]
        self._release(job)
        job.n_nodes = n_nodes
        job.state = JobState.PENDING
        job.restarts += 1
        if job.id not in self.queue:
            self.queue.insert(0, job.id)
        self.schedule()

    # ------------------------------------------------------------ helpers ----
    def _release(self, job: Job):
        for n in job.nodes:
            self._allocated.discard(n)
        job.nodes = []

    def buffer_size(self) -> int:
        return len(self.free_healthy())
