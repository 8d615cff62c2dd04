"""Three-term roofline of a dry-run record on NVIDIA H100 SXM cards (the
port's counterpart of the JAX ``repro.roofline.analysis``):

  compute    = bf16 FLOPs / 989e12 + fp32 FLOPs / 67e12           [s]
  memory     = bytes accessed / 3.35e12                           [s]
  collective = NVLink bytes / 450e9 + network bytes / 50e9        [s]

per rank, plus MODEL_FLOPS = 6·N_active·tokens (train) / 2·N_active·tokens
(forward) and the useful-compute ratio MODEL_FLOPS / counted FLOPs.

The rates are the H100 SXM5 datasheet's: 989 TFLOP/s dense BF16 on the
tensor cores, 67 TFLOP/s FP32 on the CUDA cores (TF32 off), 3.35 TB/s of
HBM3, and NVLink 4 at 900 GB/s per card, 450 GB/s each way, between the
eight cards of a node.  Across nodes each card has one 400 Gb/s NDR
InfiniBand port, 50 GB/s.  A collective's bytes go over the slowest link
its group crosses (``collectives.link_of``): ranks lie row-major, so a
group inside eight consecutive ranks stays on NVLink.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Dict

import torch

from repro_torch.roofline.kernels import HBM_BYTES_PER_S, PEAK_FLOPS as _PEAK

PEAK_FLOPS = _PEAK[torch.bfloat16]        # 989e12, bf16 dense, per card
PEAK_FLOPS_FP32 = _PEAK[torch.float32]    # 67e12, fp32, per card
HBM_BW = HBM_BYTES_PER_S                  # 3.35e12 bytes/s per card
NVLINK_BW = 450e9         # bytes/s per card each way, inside a node
NETWORK_BW = 50e9         # bytes/s per card across nodes (400 Gb/s NDR)


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float            # per rank, every dtype
    hlo_bytes: float            # per rank
    collective_bytes: float     # per rank, every link
    model_flops_global: float
    tokens_per_step: int
    fp32_flops: float = 0.0     # the part of hlo_flops at fp32's rate
    network_bytes: float = 0.0  # the part of collective_bytes across nodes

    @property
    def compute_s(self) -> float:
        return ((self.hlo_flops - self.fp32_flops) / PEAK_FLOPS
                + self.fp32_flops / PEAK_FLOPS_FP32)

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return ((self.collective_bytes - self.network_bytes) / NVLINK_BW
                + self.network_bytes / NETWORK_BW)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        per_dev_model = self.model_flops_global / max(self.chips, 1)
        return per_dev_model / max(self.hlo_flops, 1.0)

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization at the roofline bound (the score
        metric): model_flops / (chips × bf16 peak × bound_time)."""
        per_dev_model = self.model_flops_global / max(self.chips, 1)
        return per_dev_model / (PEAK_FLOPS * max(self.bound_s, 1e-30))

    def to_dict(self) -> Dict:
        d = asdict(self)
        d.update(compute_s=self.compute_s, memory_s=self.memory_s,
                 collective_s=self.collective_s, dominant=self.dominant,
                 useful_ratio=self.useful_ratio, mfu_bound=self.mfu_bound)
        return d


def from_record(rec: Dict) -> Roofline:
    ca = rec.get("cost_analysis", {})
    coll = rec.get("collectives", {})
    return Roofline(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        chips=rec["chips"],
        hlo_flops=ca.get("flops", 0.0),
        hlo_bytes=ca.get("bytes accessed", 0.0),
        collective_bytes=coll.get("total_bytes", 0.0),
        model_flops_global=rec.get("model_flops_global", 0.0),
        tokens_per_step=rec.get("tokens_per_step", 0),
        fp32_flops=ca.get("flops_by_dtype", {}).get("float32", 0.0),
        network_bytes=coll.get("by_link", {}).get("network", 0.0),
    )


def table_row(r: Roofline) -> str:
    return (f"| {r.arch} | {r.shape} | {r.mesh} | "
            f"{r.compute_s*1e3:.2f} | {r.memory_s*1e3:.2f} | "
            f"{r.collective_s*1e3:.2f} | {r.dominant} | "
            f"{r.useful_ratio:.2f} | {r.mfu_bound*100:.1f}% |")


TABLE_HEADER = ("| arch | shape | mesh | compute ms | memory ms | "
                "collective ms | bottleneck | useful | MFU@bound |\n"
                "|---|---|---|---|---|---|---|---|---|")
