"""α–β collective cost model calibrated to the paper's published NCCL
all_reduce measurements (Figs 3–4): TCP vs RoCE vs GPU-direct RDMA, plus the
TPU ICI point used for capacity planning in this framework.

Ring all-reduce of M bytes over n endpoints:
    t(M, n) = 2 (n-1) α  +  2 (n-1)/n · M / B
The paper plots *bus bandwidth* busbw = 2 (n-1)/n · M / t, saturating at B.

Calibration targets from the paper's text:
  * 8 MB @1024 GPUs:  GDR ≈ 2 GB/s algbw vs TCP ≈ 0.2 GB/s  (10x)
  * >=500 MB:         GDR 20-30 GB/s vs TCP ~6 GB/s          (3-5x)
These emerge from (B, α) = (30 GB/s, 4 µs) vs (6 GB/s, 40 µs); RoCE without
GDR sits between (20 GB/s, 8 µs — host-bounce bandwidth cap).

A copy of the JAX package's ``core/netmodel.py`` (pure Python).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class Protocol:
    name: str
    bus_bw: float      # bytes/s saturated bus bandwidth
    alpha: float       # per-hop latency, seconds


TCP = Protocol("tcp", 6.0e9, 40e-6)
ROCE = Protocol("roce", 20.0e9, 8e-6)
GDR = Protocol("gdr", 30.0e9, 4e-6)
ICI = Protocol("ici", 100.0e9, 1e-6)      # TPU v5e 2D-torus per-chip (2 links)

PROTOCOLS: Dict[str, Protocol] = {p.name: p for p in (TCP, ROCE, GDR, ICI)}


def allreduce_time(nbytes: float, n: int, proto: Protocol) -> float:
    if n <= 1:
        return 0.0
    return 2 * (n - 1) * proto.alpha + 2 * (n - 1) / n * nbytes / proto.bus_bw


def bus_bandwidth(nbytes: float, n: int, proto: Protocol) -> float:
    """What nccl-tests reports as busbw."""
    t = allreduce_time(nbytes, n, proto)
    return 2 * (n - 1) / n * nbytes / t if t > 0 else 0.0


def alg_bandwidth(nbytes: float, n: int, proto: Protocol) -> float:
    t = allreduce_time(nbytes, n, proto)
    return nbytes / t if t > 0 else 0.0


def allgather_time(nbytes_out: float, n: int, proto: Protocol) -> float:
    if n <= 1:
        return 0.0
    return (n - 1) * proto.alpha + (n - 1) / n * nbytes_out / proto.bus_bw


def scaling_curve(proto: Protocol, sizes, n: int):
    return [(m, bus_bandwidth(m, n, proto)) for m in sizes]


def gpu_count_curve(proto: Protocol, nbytes: float, counts):
    return [(n, bus_bandwidth(nbytes, n, proto)) for n in counts]


def job_step_network_seconds(grad_bytes: float, n_dp: int,
                             proto: Protocol) -> float:
    """One DP gradient synchronization per step."""
    return allreduce_time(grad_bytes, n_dp, proto)
