"""Simulated fleet with the paper's failure taxonomy (Table 1).

Hazard rates and degradation factors are taken from the published numbers:
  * clear hardware failures (host crash): ~2%/host/month average, 5% worst
    case; HGX/NVLink repairs are slow (vendor), DIMM repairs quick.
  * subtle failures: power-brake throttling 400W -> 150W (compute derate to
    0.375 => ~2.7-3x step-time hit on the whole job), PCIe link degradation
    (most frequent; ~95% fixed by VM reboot), port failure (ECMP halves a
    node's bandwidth rather than crashing the job).
  * software failures: CUDA allocation errors, HBM row-remap pending (warn;
    reset recommended; can escalate to silent corruption / job crash).

A job's effective throughput is gated by its slowest node (§2.3.1).

A copy of the JAX package's ``core/cluster.py``: the same numpy
``default_rng`` stream, drawn in the same order, so equal seeds give equal
event lists.
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.telemetry import MetricsRegistry

MONTH = 30 * 24 * 3600.0


class FailureKind(enum.Enum):
    HOST_CRASH = "host_crash"            # HGX board / NVLink / DIMM
    POWER_BRAKE = "power_brake"          # PSU failure -> 150W throttle
    PCIE_DEGRADE = "pcie_degrade"        # link downgrade, reboot fixes
    PORT_FAILURE = "port_failure"        # one NIC port down, ECMP absorbs
    ROW_REMAP = "row_remap"              # HBM row remap pending (warning)
    CUDA_ERROR = "cuda_error"            # software failure, app crash


# per-second hazard rates (exponential), derived from the paper
DEFAULT_RATES = {
    FailureKind.HOST_CRASH: 0.02 / MONTH,
    FailureKind.POWER_BRAKE: 0.01 / MONTH,
    FailureKind.PCIE_DEGRADE: 0.06 / MONTH,   # "most frequently observed"
    FailureKind.PORT_FAILURE: 0.01 / MONTH,
    FailureKind.ROW_REMAP: 0.03 / MONTH,
    FailureKind.CUDA_ERROR: 0.02 / MONTH,
}

# multiplicative per-node compute factor while degraded
DEGRADE_FACTOR = {
    FailureKind.POWER_BRAKE: 150.0 / 400.0,   # ~2.7x slower
    FailureKind.PCIE_DEGRADE: 0.5,
    FailureKind.PORT_FAILURE: 0.8,
    FailureKind.ROW_REMAP: 1.0,               # no slowdown; crash risk only
}

# seconds to repair once detected (vendor RMA vs quick fixes)
REPAIR_TIME = {
    FailureKind.HOST_CRASH: 3 * 24 * 3600.0,   # board swap via vendor
    FailureKind.POWER_BRAKE: 8 * 3600.0,
    FailureKind.PCIE_DEGRADE: 900.0,           # VM reboot (>=95% fix rate)
    FailureKind.PORT_FAILURE: 4 * 3600.0,
    FailureKind.ROW_REMAP: 900.0,              # GPU reset
    FailureKind.CUDA_ERROR: 600.0,
}


class NodeState(enum.Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"
    CRASHED = "crashed"
    REPAIRING = "repairing"


@dataclass
class Node:
    id: int
    gpus: int = 8
    state: NodeState = NodeState.HEALTHY
    active_failures: List[FailureKind] = field(default_factory=list)
    repair_done_at: float = 0.0
    perf_factor: float = 1.0

    def apply(self, kind: FailureKind):
        if kind in (FailureKind.HOST_CRASH, FailureKind.CUDA_ERROR):
            self.state = NodeState.CRASHED
        else:
            self.state = NodeState.DEGRADED
        if kind not in self.active_failures:
            self.active_failures.append(kind)
        self._recompute()

    def _recompute(self):
        f = 1.0
        for k in self.active_failures:
            f *= DEGRADE_FACTOR.get(k, 1.0)
        self.perf_factor = 0.0 if self.state in (
            NodeState.CRASHED, NodeState.REPAIRING) else f

    def heal(self):
        self.active_failures.clear()
        self.state = NodeState.HEALTHY
        self.perf_factor = 1.0


@dataclass
class FailureEvent:
    t: float
    node_id: int
    kind: FailureKind


class SimCluster:
    """Fleet of nodes with stochastic failures on a virtual timeline."""

    def __init__(self, n_nodes: int, seed: int = 0,
                 rates: Optional[Dict[FailureKind, float]] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.nodes = [Node(i) for i in range(n_nodes)]
        self.rates = dict(rates or DEFAULT_RATES)
        self.rng = np.random.default_rng(seed)
        self.events: List[FailureEvent] = []
        self.reg = registry
        self.now = 0.0

    # ----------------------------------------------------------- dynamics ----
    def advance(self, dt: float):
        """Advance time; sample failures; finish repairs."""
        self.now += dt
        total_rate = sum(self.rates.values())
        for node in self.nodes:
            if node.state == NodeState.REPAIRING:
                if self.now >= node.repair_done_at:
                    node.heal()
                continue
            # exponential failure sampling per kind
            if self.rng.random() < -math.expm1(-total_rate * dt):
                kinds, probs = zip(*[(k, r / total_rate)
                                     for k, r in self.rates.items()])
                kind = kinds[self.rng.choice(len(kinds), p=probs)]
                self.inject(node.id, kind)

    def inject(self, node_id: int, kind: FailureKind):
        node = self.nodes[node_id]
        node.apply(kind)
        self.events.append(FailureEvent(self.now, node_id, kind))
        if self.reg:
            self.reg.counter("cluster_failures_total").inc(
                1, {"kind": kind.value})
            self.reg.gauge("node_perf_factor").set(
                node.perf_factor, {"node": str(node_id)})

    def start_repair(self, node_id: int):
        node = self.nodes[node_id]
        worst = max((REPAIR_TIME[k] for k in node.active_failures),
                    default=600.0)
        node.state = NodeState.REPAIRING
        node.repair_done_at = self.now + worst
        node._recompute()

    # ------------------------------------------------------------ queries ----
    def healthy_nodes(self) -> List[Node]:
        return [n for n in self.nodes if n.state == NodeState.HEALTHY]

    def job_perf_factor(self, node_ids: List[int]) -> float:
        """Job speed == slowest participating node (paper §2.3.1)."""
        factors = [self.nodes[i].perf_factor for i in node_ids]
        return min(factors) if factors else 0.0

    def crashed_in(self, node_ids: List[int]) -> List[int]:
        return [i for i in node_ids
                if self.nodes[i].state in (NodeState.CRASHED,
                                           NodeState.REPAIRING)]

    def degraded_in(self, node_ids: List[int], threshold: float = 0.95
                    ) -> List[int]:
        return [i for i in node_ids
                if 0 < self.nodes[i].perf_factor < threshold]
