"""Autopilot analogue (§2.2.1): periodic node health checks exported as
Prometheus-style gauges with PASS/ERR labels.

Two check tiers, as in the paper:
  * light checks run while workloads are present (device gemm throughput,
    host<->device bandwidth, connectivity ping)
  * intrusive checks (dcgm-level-3 analogue) run only on free nodes.

On the simulated fleet, measured values are the real local microbenchmark
scaled by the node's degradation factor, so the alert thresholds exercise the
same code path a real deployment would.

A copy of the JAX package's ``core/health.py`` whose two probes run on a
torch device: ``Autopilot(measure_real=True, device=...)`` times an fp32
matmul and a pinned host-to-device copy there (``device`` defaults to
``"cuda"`` and, as at every entry point of the port, raises where CUDA is
absent unless ``"cpu"`` is asked for).  With ``measure_real=False`` (the
default) no probe runs and no device is touched.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.core.cluster import FailureKind, SimCluster
from repro_torch.core.telemetry import MetricsRegistry


@dataclass
class CheckResult:
    name: str
    node_id: int
    value: float
    passed: bool
    unit: str = ""


def _resolve(device):
    """The probe's torch device (``resolve_device``: CUDA asked for where it
    is absent raises), imported here so that the simulators, which touch no
    device, do not load the model stack."""
    from repro_torch.models.common import resolve_device
    return resolve_device(device)


def _sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _measure_gemm_gflops(n: int = 256, iters: int = 2,
                         device="cuda") -> float:
    """Local DGEMM microbenchmark (the paper's DCGM DGEMM diag analogue):
    an fp32 n x n product chained ``iters`` times after one warm call, on
    the host clock up to a synchronize (TF32 as the process has it, off by
    default).  At n = 256 this times a few launches and a synchronize, not
    the card's fp32 peak; each later reading is judged against the same
    probe's baseline."""
    import torch
    dev = _resolve(device)
    a = torch.ones((n, n), dtype=torch.float32, device=dev)
    torch.matmul(a, a)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        a = torch.matmul(a, a)
    _sync(dev)
    dt = max(time.perf_counter() - t0, 1e-9)
    return 2 * n ** 3 * iters / dt / 1e9


def _measure_h2d_gbps(nbytes: int = 1 << 22, device="cuda") -> float:
    """Host->device transfer (PCIe bandwidth check analogue): ``nbytes``
    copied into a device buffer, timed after one warm copy.  On a card the
    host buffer is pinned: a pageable copy goes through a CUDA staging
    buffer and would time host memcpy, not the PCIe link the
    paper's check watches."""
    import torch
    dev = _resolve(device)
    host = torch.ones(nbytes, dtype=torch.uint8,
                      pin_memory=dev.type == "cuda")
    dst = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    dst.copy_(host, non_blocking=True)
    _sync(dev)
    t0 = time.perf_counter()
    dst.copy_(host, non_blocking=True)
    _sync(dev)
    return nbytes / max(time.perf_counter() - t0, 1e-9) / 1e9


class HealthCheck:
    name = "base"
    level = "light"          # light | intrusive
    unit = ""

    def threshold(self, baseline: float) -> float:
        return 0.5 * baseline

    def measure(self, device="cuda") -> float:
        raise NotImplementedError


class GemmCheck(HealthCheck):
    name = "gpu_dgemm_gflops"
    unit = "GF/s"

    def measure(self, device="cuda") -> float:
        return _measure_gemm_gflops(device=device)


class PcieBandwidthCheck(HealthCheck):
    name = "pcie_h2d_gbps"
    unit = "GB/s"

    def threshold(self, baseline: float) -> float:
        # paper: alert when 12h average drops below the link-generation floor
        return 0.6 * baseline

    def measure(self, device="cuda") -> float:
        return _measure_h2d_gbps(device=device)


class PingCheck(HealthCheck):
    name = "net_ping_ok"
    unit = "bool"

    def threshold(self, baseline: float) -> float:
        return 0.5

    def measure(self, device="cuda") -> float:
        return 1.0


class Dcgm3Check(HealthCheck):
    """Deep diagnostics: intrusive, only on free nodes (finds HBM corruption
    that light checks miss — paper §2.3.2)."""
    name = "dcgm_level3_ok"
    level = "intrusive"
    unit = "bool"

    def threshold(self, baseline: float) -> float:
        return 0.5

    def measure(self, device="cuda") -> float:
        return 1.0


DEFAULT_CHECKS = (GemmCheck(), PcieBandwidthCheck(), PingCheck(),
                  Dcgm3Check())

# which failure kinds each check is sensitive to (simulation coupling)
_SENSITIVITY: Dict[str, List[FailureKind]] = {
    "gpu_dgemm_gflops": [FailureKind.POWER_BRAKE],
    "pcie_h2d_gbps": [FailureKind.PCIE_DEGRADE],
    "net_ping_ok": [FailureKind.PORT_FAILURE, FailureKind.HOST_CRASH],
    "dcgm_level3_ok": [FailureKind.ROW_REMAP, FailureKind.CUDA_ERROR],
}


class Autopilot:
    def __init__(self, cluster: SimCluster, registry: MetricsRegistry,
                 checks=DEFAULT_CHECKS, measure_real: bool = False,
                 device="cuda"):
        self.cluster = cluster
        self.reg = registry
        self.checks = checks
        self.measure_real = measure_real
        # the probes' device, resolved only where they will run
        self.device = _resolve(device) if measure_real else None
        self._baselines: Dict[str, float] = {}

    def _baseline(self, check: HealthCheck) -> float:
        if check.name not in self._baselines:
            if self.measure_real and check.name in ("gpu_dgemm_gflops",
                                                    "pcie_h2d_gbps"):
                self._baselines[check.name] = check.measure(self.device)
            else:
                self._baselines[check.name] = {
                    "gpu_dgemm_gflops": 100.0, "pcie_h2d_gbps": 20.0,
                    "net_ping_ok": 1.0, "dcgm_level3_ok": 1.0,
                }[check.name]
        return self._baselines[check.name]

    def _simulated_value(self, check: HealthCheck, node) -> float:
        base = self._baseline(check)
        sens = _SENSITIVITY.get(check.name, [])
        hit = [k for k in node.active_failures if k in sens]
        if node.perf_factor == 0.0 and check.name == "net_ping_ok":
            return 0.0
        if not hit:
            return base
        if check.unit == "bool":
            return 0.0
        worst = min((0.375 if k == FailureKind.POWER_BRAKE else 0.3)
                    for k in hit)
        return base * worst

    def run_checks(self, node_ids: Optional[List[int]] = None,
                   busy: Optional[List[int]] = None) -> List[CheckResult]:
        """Light checks everywhere; intrusive only on free nodes."""
        busy = set(busy or [])
        results = []
        for node in self.cluster.nodes:
            if node_ids is not None and node.id not in node_ids:
                continue
            for check in self.checks:
                if check.level == "intrusive" and node.id in busy:
                    continue
                value = self._simulated_value(check, node)
                passed = value >= check.threshold(self._baseline(check))
                results.append(CheckResult(check.name, node.id, value, passed,
                                           check.unit))
                self.reg.gauge(f"autopilot_{check.name}").set(
                    value, {"node": str(node.id)})
                self.reg.gauge("autopilot_node_ok").set(
                    float(passed), {"node": str(node.id),
                                    "check": check.name})
        return results

    def err_nodes(self, results: List[CheckResult]) -> List[int]:
        return sorted({r.node_id for r in results if not r.passed})


def serve_light_checks(engine) -> Dict[str, bool]:
    """Light (non-intrusive) health checks over a live ``ServeEngine`` —
    the Autopilot idiom applied to the serving path, run in-loop every
    ``health_every`` iterations when an ``AlertManager`` is wired in.

    Exported as ``autopilot_serve_*`` gauges (1.0 = PASS, 0.0 = ERR) so the
    existing ``autopilot_err`` alert machinery and dashboards cover serving
    without new plumbing:

    * ``dispatch_invariant`` — exactly one fused decode+sample dispatch per
      decode iteration (the engine's core perf contract);
    * ``streams_progressing`` — no live slot has gone a full watchdog
      window (or 64 iterations when the watchdog is off) without emitting
      a token, landing a chunk, or being admitted;
    * ``cache_invariants`` — ``PagedCache.verify()`` holds (only measured
      in debug mode, ``verify_cache=True``, where its O(P + B·M) host walk
      is already being paid).

    Duck-typed on the engine (reg / slot_req / watchdog / kv attrs), so it
    needs no import of the serve package."""
    reg = engine.reg
    results: Dict[str, bool] = {}
    iters = reg.counter("serve_iterations_total").get()
    disp = reg.counter("serve_decode_dispatches_total").get()
    results["dispatch_invariant"] = disp == iters
    window = engine.watchdog_iters or 64
    results["streams_progressing"] = not any(
        req is not None
        and engine._iter - engine._last_progress.get(slot, engine._iter)
        >= window
        for slot, req in enumerate(engine.slot_req))
    if engine.verify_cache and hasattr(engine.kv, "verify"):
        try:
            engine.kv.verify()
            results["cache_invariants"] = True
        except AssertionError:        # CacheInvariantError subclasses it
            results["cache_invariants"] = False
    for name, passed in results.items():
        reg.gauge(f"autopilot_serve_{name}").set(float(passed))
        reg.gauge("autopilot_node_ok").set(
            float(passed), {"node": "serve", "check": f"serve_{name}"})
    return results
