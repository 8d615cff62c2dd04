"""Straggler detection & localization (§2.3.1): a single throttled node drags
the whole gang to its speed (the Granite-20B 768-GPU 3x incident).  Detection
is job-level (step-time regression vs trailing median); localization is
node-level (autopilot gauges: power-brake counters / per-node GEMM
throughput), mirroring the paper's nvidia-smi power-break counter approach.
A copy of the JAX package's ``core/straggler.py``."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from repro_torch.core.cluster import SimCluster
from repro_torch.core.telemetry import MetricsRegistry


@dataclass
class StragglerReport:
    detected: bool
    slowdown: float
    suspect_nodes: List[int]
    reason: str = ""


class StragglerDetector:
    def __init__(self, registry: MetricsRegistry, factor: float = 1.25,
                 window: int = 16, min_samples: int = 4):
        self.reg = registry
        self.factor = factor
        self.window = window
        self.min_samples = min_samples

    def observe_step(self, seconds: float, job: str = "default"):
        self.reg.histogram("train_step_seconds").observe(
            seconds, {"job": job})

    def check(self, cluster: Optional[SimCluster] = None,
              node_ids: Optional[List[int]] = None,
              job: str = "default") -> StragglerReport:
        hist = self.reg._metrics.get("train_step_seconds")
        if hist is None:
            return StragglerReport(False, 1.0, [])
        recent = hist.recent(self.window, {"job": job})
        if len(recent) < self.min_samples:
            return StragglerReport(False, 1.0, [])
        # long-term baseline (p25 of full history): a persistent slowdown must
        # not poison its own reference (the 3x incident ran for a while before
        # being diagnosed — the baseline has to remember healthy speed)
        base = hist.quantile(0.25, {"job": job})
        # median of the last few steps: persistent slowdowns trigger fast,
        # single hiccups don't (the paper averages 12 samples for the same
        # false-positive reason)
        tail = recent[-self.min_samples:]
        cur = sorted(tail)[len(tail) // 2]
        slowdown = cur / base if base > 0 else 1.0
        if slowdown < self.factor:
            return StragglerReport(False, slowdown, [])
        suspects: List[int] = []
        reason = "step-time regression"
        if cluster is not None and node_ids:
            suspects = cluster.degraded_in(node_ids)
            if suspects:
                kinds = {k.value for i in suspects
                         for k in cluster.nodes[i].active_failures}
                reason = f"degraded nodes {suspects}: {sorted(kinds)}"
        return StragglerReport(True, slowdown, suspects, reason)
