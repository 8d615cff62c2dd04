"""AIOps anomaly detection over cluster telemetry (§3.6 "using AIOps for
anomaly detection in cluster operational data" — the paper's stated future
direction, implemented here as a robust-statistics detector).

Per metric series: a rolling median/MAD baseline; a point is anomalous when
its robust z-score exceeds the threshold for `persistence` consecutive
samples (the paper's 12-sample-average philosophy: no single-sample alarms).
A copy of the JAX package's ``core/aiops.py``.
"""
from __future__ import annotations

from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.telemetry import MetricsRegistry


@dataclass
class Anomaly:
    metric: str
    labels: Dict[str, str]
    value: float
    zscore: float
    message: str


class AnomalyDetector:
    def __init__(self, window: int = 64, threshold: float = 4.0,
                 persistence: int = 3, min_history: int = 12):
        self.window = window
        self.threshold = threshold
        self.persistence = persistence
        self.min_history = min_history
        self._hist: Dict[Tuple, Deque[float]] = defaultdict(
            lambda: deque(maxlen=window))
        self._streak: Dict[Tuple, int] = defaultdict(int)

    def observe(self, metric: str, labels: Dict[str, str],
                value: float) -> Optional[Anomaly]:
        key = (metric, tuple(sorted(labels.items())))
        hist = self._hist[key]
        anomaly = None
        if len(hist) >= self.min_history:
            arr = np.asarray(hist)
            med = float(np.median(arr))
            mad = float(np.median(np.abs(arr - med))) or 1e-9
            z = 0.6745 * (value - med) / mad
            if abs(z) > self.threshold:
                self._streak[key] += 1
                if self._streak[key] >= self.persistence:
                    anomaly = Anomaly(
                        metric, labels, value, z,
                        f"{metric}{labels} robust-z={z:+.1f} "
                        f"({value:.3g} vs median {med:.3g}) for "
                        f"{self._streak[key]} consecutive samples")
            else:
                self._streak[key] = 0
        hist.append(value)
        return anomaly

    def scan_registry(self, reg: MetricsRegistry) -> List[Anomaly]:
        """Feed every gauge series' current value through the detector."""
        out = []
        for name, series in reg.snapshot().items():
            for ls, v in series.items():
                a = self.observe(name, dict(ls), v)
                if a:
                    out.append(a)
        return out


def render_dashboard(reg: MetricsRegistry, title: str = "cluster") -> str:
    """Text 'Grafana' panel (§3.4): per-node health, job throughput, storage
    and scheduler gauges in one terminal-friendly table."""
    snap = reg.snapshot()
    lines = [f"== {title} dashboard ==".upper()]

    def section(header: str, metric: str, fmt=lambda v: f"{v:.3g}"):
        series = snap.get(metric)
        if not series:
            return
        lines.append(f"-- {header}")
        for ls, v in sorted(series.items()):
            lbl = ",".join(f"{k}={v2}" for k, v2 in ls) or "(all)"
            lines.append(f"   {lbl:40s} {fmt(v)}")

    section("node performance factor", "node_perf_factor")
    section("autopilot checks (1=PASS)", "autopilot_node_ok",
            lambda v: "PASS" if v else "ERR")
    section("failures", "cluster_failures_total")
    section("scheduler", "scheduler_job_starts")
    section("node swaps", "scheduler_node_swaps")
    section("tenant quotas", "tenant_quota_nodes")
    section("tenant usage", "tenant_used_nodes")
    section("storage dirty bytes", "scale_dirty_bytes")
    section("checkpoints", "checkpoints_written")
    h = reg._metrics.get("train_step_seconds")
    if h is not None:
        lines.append("-- train step seconds (p50/p95)")
        for ls, _ in h.labels_values():
            labels = dict(ls)
            lines.append(f"   {labels or '(all)'}  "
                         f"{h.quantile(0.5, labels):.3f}/"
                         f"{h.quantile(0.95, labels):.3f}")
    return "\n".join(lines)
