"""Multi-tenant resource management (§2.2): the OpenShift namespace/quota
layer over the gang scheduler — platform administrators provision quotas per
project, researchers submit within them, and capacity can be moved between
tenants (the paper's "resources are moved between clusters for training and
inference services based on business needs").

The **priority-class registry** lives here because both resource layers
share it: cluster-level namespaces (this module — nodes are the resource)
and the serving-level SLO scheduler (``serve/tenancy.py`` — KV pages are
the resource) map the same class names onto the same relative priorities,
so "interactive outranks batch" means one thing across the whole stack.

A copy of the JAX package's ``core/tenancy.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.core.scheduler import GangScheduler, Job, JobState
from repro_torch.core.telemetry import MetricsRegistry


@dataclass(frozen=True)
class PriorityClass:
    """One SLO class: a name, a strict priority (higher wins admission and
    is never preempted by lower), whether members may be preempted under
    resource pressure, and an optional per-iteration chunked-prefill token
    budget (serving only; ``None`` = bounded only by the engine's global
    budget)."""
    name: str
    priority: int
    preemptible: bool = True
    prefill_budget: Optional[int] = None


#: TTFT-sensitive traffic: admitted first, never preempted.
INTERACTIVE = PriorityClass("interactive", 100, preemptible=False)
#: Throughput traffic: yields pages/slots to interactive under pressure.
BATCH = PriorityClass("batch", 0, preemptible=True)

DEFAULT_CLASSES: Dict[str, PriorityClass] = {
    INTERACTIVE.name: INTERACTIVE, BATCH.name: BATCH}


@dataclass
class Namespace:
    name: str
    quota_nodes: int
    used_nodes: int = 0
    priority: int = 0

    @property
    def available(self) -> int:
        return self.quota_nodes - self.used_nodes


class TenantScheduler:
    """Quota-enforcing facade over GangScheduler."""

    def __init__(self, sched: GangScheduler,
                 registry: Optional[MetricsRegistry] = None):
        self.sched = sched
        self.namespaces: Dict[str, Namespace] = {}
        self.job_ns: Dict[str, str] = {}
        self.reg = registry

    def create_namespace(self, name: str, quota_nodes: int,
                         priority: int = 0) -> Namespace:
        total_quota = sum(n.quota_nodes for n in self.namespaces.values())
        assert total_quota + quota_nodes <= len(self.sched.cluster.nodes), \
            "quota overcommit"
        ns = Namespace(name, quota_nodes, priority=priority)
        self.namespaces[name] = ns
        if self.reg:
            self.reg.gauge("tenant_quota_nodes").set(quota_nodes,
                                                     {"namespace": name})
        return ns

    def resize_namespace(self, name: str, quota_nodes: int):
        """Move capacity between tenants (training <-> inference shifts)."""
        ns = self.namespaces[name]
        assert quota_nodes >= ns.used_nodes, "shrink below usage"
        others = sum(n.quota_nodes for n in self.namespaces.values()
                     if n.name != name)
        assert others + quota_nodes <= len(self.sched.cluster.nodes)
        ns.quota_nodes = quota_nodes
        if self.reg:
            self.reg.gauge("tenant_quota_nodes").set(quota_nodes,
                                                     {"namespace": name})

    def submit(self, namespace: str, job: Job) -> bool:
        ns = self.namespaces[namespace]
        if job.n_nodes > ns.available:
            if self.reg:
                self.reg.counter("tenant_quota_rejections").inc(
                    1, {"namespace": namespace})
            return False
        ns.used_nodes += job.n_nodes
        self.job_ns[job.id] = namespace
        job.priority = max(job.priority, ns.priority)
        self.sched.submit(job)
        if self.reg:
            self.reg.gauge("tenant_used_nodes").set(
                ns.used_nodes, {"namespace": namespace})
        return True

    def complete(self, job_id: str):
        ns = self.namespaces[self.job_ns.pop(job_id)]
        job = self.sched.jobs[job_id]
        ns.used_nodes -= job.n_nodes
        self.sched.complete(job_id)

    def usage_report(self) -> List[str]:
        return [f"{ns.name}: {ns.used_nodes}/{ns.quota_nodes} nodes "
                f"(prio {ns.priority})"
                for ns in self.namespaces.values()]
