"""Prometheus-style metrics registry (counters / gauges / histograms) for the
port's serve engine.  A copy of the JAX package's ``core/telemetry.py``
registry (pure Python, thread-safe, with a text exposition renderer): the
port imports nothing of the JAX package, so it keeps its own."""
from __future__ import annotations

import bisect
import threading
from typing import Dict, Iterable, List, Optional, Tuple

LabelSet = Tuple[Tuple[str, str], ...]


def _labels(labels: Optional[Dict[str, str]]) -> LabelSet:
    return tuple(sorted((labels or {}).items()))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self._lock = threading.Lock()
        self._series: Dict[LabelSet, float] = {}

    def labels_values(self) -> List[Tuple[LabelSet, float]]:
        with self._lock:
            return list(self._series.items())


class Counter(_Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, labels: Optional[Dict] = None):
        assert value >= 0
        ls = _labels(labels)
        with self._lock:
            self._series[ls] = self._series.get(ls, 0.0) + value

    def get(self, labels: Optional[Dict] = None) -> float:
        return self._series.get(_labels(labels), 0.0)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, value: float, labels: Optional[Dict] = None):
        with self._lock:
            self._series[_labels(labels)] = float(value)

    def inc(self, value: float = 1.0, labels: Optional[Dict] = None):
        ls = _labels(labels)
        with self._lock:
            self._series[ls] = self._series.get(ls, 0.0) + value

    def get(self, labels: Optional[Dict] = None) -> float:
        return self._series.get(_labels(labels), 0.0)


class Histogram(_Metric):
    kind = "histogram"
    DEFAULT_BUCKETS = (.005, .01, .025, .05, .1, .25, .5, 1, 2.5, 5, 10,
                       25, 60, 120, 300, float("inf"))

    def __init__(self, name: str, help_: str = "", buckets: Iterable = ()):
        super().__init__(name, help_)
        self.buckets = tuple(buckets) or self.DEFAULT_BUCKETS
        self._counts: Dict[LabelSet, List[int]] = {}
        self._sums: Dict[LabelSet, float] = {}
        self._raw: Dict[LabelSet, List[float]] = {}

    def observe(self, value: float, labels: Optional[Dict] = None):
        ls = _labels(labels)
        with self._lock:
            counts = self._counts.setdefault(ls, [0] * len(self.buckets))
            idx = bisect.bisect_left(self.buckets, value)
            counts[min(idx, len(self.buckets) - 1)] += 1
            self._sums[ls] = self._sums.get(ls, 0.0) + value
            raw = self._raw.setdefault(ls, [])
            raw.append(value)
            if len(raw) > 4096:          # ring buffer for quantile queries
                del raw[:2048]

    def count(self, labels: Optional[Dict] = None) -> int:
        return sum(self._counts.get(_labels(labels), []))

    def sum(self, labels: Optional[Dict] = None) -> float:
        return self._sums.get(_labels(labels), 0.0)

    def quantile(self, q: float, labels: Optional[Dict] = None) -> float:
        raw = sorted(self._raw.get(_labels(labels), []))
        if not raw:
            return float("nan")
        return raw[min(int(q * len(raw)), len(raw) - 1)]

    def recent(self, n: int, labels: Optional[Dict] = None) -> List[float]:
        return self._raw.get(_labels(labels), [])[-n:]


class MetricsRegistry:
    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name: str, help_: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help_, **kw)
                self._metrics[name] = m
            assert isinstance(m, cls), (name, m.kind)
            return m

    def counter(self, name: str, help_: str = "") -> Counter:
        return self._get(Counter, name, help_)

    def gauge(self, name: str, help_: str = "") -> Gauge:
        return self._get(Gauge, name, help_)

    def histogram(self, name: str, help_: str = "",
                  buckets: Iterable = ()) -> Histogram:
        return self._get(Histogram, name, help_, buckets=buckets)

    def snapshot(self) -> Dict[str, Dict[LabelSet, float]]:
        return {name: dict(m.labels_values())
                for name, m in self._metrics.items()}

    def render(self) -> str:
        """Prometheus text exposition format."""
        lines = []
        for name, m in sorted(self._metrics.items()):
            lines.append(f"# HELP {name} {m.help}")
            lines.append(f"# TYPE {name} {m.kind}")
            for ls, v in m.labels_values():
                lbl = ",".join(f'{k}="{v2}"' for k, v2 in ls)
                lines.append(f"{name}{{{lbl}}} {v}" if lbl else f"{name} {v}")
        return "\n".join(lines) + "\n"

