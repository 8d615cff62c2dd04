"""Alert rules engine (§2.3.2): the paper's Activity-Tracker/LogDNA/
Alertmanager -> Slack pipeline, reproduced as rules over the metrics registry
with pluggable sinks.  Default rules mirror the paper's alert set:
node-down, NVSwitch fatal, CUDA error, PCIe degradation (12-sample trailing
average, eliminating false positives), power-brake active, row-remap pending,
and step-time regression.  A copy of the JAX package's ``core/alerts.py``."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.core.telemetry import MetricsRegistry


@dataclass
class Alert:
    rule: str
    severity: str
    message: str
    labels: Dict[str, str] = field(default_factory=dict)


@dataclass
class AlertRule:
    name: str
    severity: str
    # predicate over the registry; returns list of (labels, message)
    evaluate: Callable[[MetricsRegistry], List]


class SlackSink:
    """Collects messages like the paper's Slack webhook integration."""

    def __init__(self):
        self.messages: List[str] = []

    def send(self, alert: Alert):
        self.messages.append(
            f":rotating_light: [{alert.severity.upper()}] {alert.rule}: "
            f"{alert.message}")


class LogSink:
    def __init__(self):
        self.records: List[Alert] = []

    def send(self, alert: Alert):
        self.records.append(alert)


def _gauge_series(reg: MetricsRegistry, name: str):
    snap = reg.snapshot().get(name, {})
    return [(dict(ls), v) for ls, v in snap.items()]


def node_down_rule() -> AlertRule:
    def ev(reg):
        out = []
        for labels, v in _gauge_series(reg, "node_perf_factor"):
            if v == 0.0:
                out.append((labels,
                            f"node {labels.get('node')} is down "
                            "(VM stopped / host crash)"))
        return out
    return AlertRule("node_down", "critical", ev)


def autopilot_err_rule() -> AlertRule:
    def ev(reg):
        out = []
        for labels, v in _gauge_series(reg, "autopilot_node_ok"):
            if v == 0.0:
                out.append((labels,
                            f"health check {labels.get('check')} ERR on "
                            f"node {labels.get('node')}"))
        return out
    return AlertRule("autopilot_err", "warning", ev)


def pcie_degraded_rule(threshold_gbps: float = 12.0,
                       samples: int = 12) -> AlertRule:
    """Paper: average 12 hourly samples before alerting (no false positives)."""
    def ev(reg):
        out = []
        hist = reg._metrics.get("pcie_bw_sample")
        if hist is None:
            return out
        for ls, _ in hist.labels_values():
            labels = dict(ls)
            recent = hist.recent(samples, labels)
            if len(recent) >= samples and \
                    sum(recent) / len(recent) < threshold_gbps:
                out.append((labels,
                            f"PCIe bandwidth degraded on node "
                            f"{labels.get('node')}: "
                            f"{sum(recent)/len(recent):.1f} GB/s 12-sample avg"))
        return out
    return AlertRule("pcie_degraded", "warning", ev)


def step_time_regression_rule(factor: float = 1.3,
                              window: int = 16) -> AlertRule:
    """Job-level slowdown (e.g. the 3x power-brake incident on 768 GPUs)."""
    def ev(reg):
        hist = reg._metrics.get("train_step_seconds")
        if hist is None:
            return []
        out = []
        for ls, _ in hist.labels_values():
            labels = dict(ls)
            recent = hist.recent(window, labels)
            if len(recent) < window:
                continue
            base = sorted(recent)[len(recent) // 2]
            if recent[-1] > factor * base and base > 0:
                out.append((labels,
                            f"step time regression: {recent[-1]:.2f}s vs "
                            f"median {base:.2f}s (x{recent[-1]/base:.1f})"))
        return out
    return AlertRule("step_time_regression", "warning", ev)


def cuda_error_rule() -> AlertRule:
    def ev(reg):
        c = reg._metrics.get("cuda_errors_total")
        if c is None:
            return []
        return [(dict(ls), f"CUDA error on pod {dict(ls).get('node')}")
                for ls, v in c.labels_values() if v > 0]
    return AlertRule("gpu_cuda_error", "critical", ev)


def serve_dead_letter_rule() -> AlertRule:
    """A request terminally failed recovery (retries exhausted / capacity
    lost after a chip failure) — the serving analogue of an unrecoverable
    node error, so critical like ``gpu_cuda_error``."""
    def ev(reg):
        c = reg._metrics.get("serve_dead_letter_total")
        if c is None:
            return []
        return [(dict(ls),
                 f"{v:.0f} request(s) dead-lettered "
                 f"(reason: {dict(ls).get('reason', '?')})")
                for ls, v in c.labels_values() if v > 0 and ls]
    return AlertRule("serve_dead_letter", "critical", ev)


def serve_retry_storm_rule(threshold: int = 8) -> AlertRule:
    """Recoveries are normal in ones and twos; a pile-up under one reason
    label means a persistent fault the retry loop cannot clear."""
    def ev(reg):
        c = reg._metrics.get("serve_stream_retries_total")
        if c is None:
            return []
        return [(dict(ls),
                 f"{v:.0f} stream recoveries "
                 f"(reason: {dict(ls).get('reason', '?')}) — "
                 "persistent fault suspected")
                for ls, v in c.labels_values() if v >= threshold and ls]
    return AlertRule("serve_retry_storm", "warning", ev)


DEFAULT_RULES = (node_down_rule, autopilot_err_rule, pcie_degraded_rule,
                 step_time_regression_rule, cuda_error_rule)

#: the serving-path rule set: pass ``rules=DEFAULT_RULES + SERVE_RULES``
#: (or just ``SERVE_RULES``) to an AlertManager wired into a ServeEngine
SERVE_RULES = (serve_dead_letter_rule, serve_retry_storm_rule)


class AlertManager:
    def __init__(self, registry: MetricsRegistry, sinks=None, rules=None):
        self.reg = registry
        self.sinks = list(sinks) if sinks is not None else [SlackSink()]
        self.rules = [r() for r in (rules or DEFAULT_RULES)]
        self.fired: List[Alert] = []
        self._dedup = set()

    def evaluate(self) -> List[Alert]:
        new = []
        for rule in self.rules:
            for labels, msg in rule.evaluate(self.reg):
                key = (rule.name, tuple(sorted(labels.items())), msg)
                if key in self._dedup:
                    continue
                self._dedup.add(key)
                alert = Alert(rule.name, rule.severity, msg, labels)
                new.append(alert)
                for s in self.sinks:
                    s.send(alert)
        self.fired.extend(new)
        return new
