"""The dry-run and roofline tables from the port's sweep records in
``experiments/dryrun_torch/`` (the port's counterpart of the JAX
``repro.roofline.report``, which reads the JAX dry-run's
``experiments/dryrun/``).

    python -m repro_torch.roofline.report
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional

from repro_torch.roofline.analysis import TABLE_HEADER, from_record, table_row

DRYRUN = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load_records(mesh: str = "pod16x16", tag: str = "",
                 root: Optional[Path] = None) -> List[Dict]:
    out = []
    for p in sorted(((root or DRYRUN) / mesh).glob("*.json")):
        r = json.loads(p.read_text())
        if tag and r.get("tag") != tag:
            continue
        if not tag and r.get("tag", "baseline") != "baseline":
            continue
        out.append(r)
    return out


def load_cell(arch: str, shape: str, mesh: str = "pod16x16",
              tag: str = "baseline",
              root: Optional[Path] = None) -> Optional[Dict]:
    suffix = "" if tag == "baseline" else f"__{tag}"
    p = (root or DRYRUN) / mesh / f"{arch}__{shape}{suffix}.json"
    if not p.exists():
        return None
    return json.loads(p.read_text())


def _key(r):
    return (r["arch"], SHAPE_ORDER.index(r["shape"])
            if r["shape"] in SHAPE_ORDER else 99)


def roofline_table(mesh: str = "pod16x16",
                   root: Optional[Path] = None) -> str:
    lines = [TABLE_HEADER]
    skips = []
    for r in sorted(load_records(mesh, root=root), key=_key):
        if r.get("skipped"):
            skips.append(f"- `{r['arch']} × {r['shape']}`: {r['skipped']}")
            continue
        if not r.get("ok"):
            lines.append(f"| {r['arch']} | {r['shape']} | {mesh} | "
                         f"FAILED: {r.get('error','?')} | | | | | |")
            continue
        lines.append(table_row(from_record(r)))
    out = "\n".join(lines)
    if skips:
        out += "\n\nSkipped cells:\n" + "\n".join(skips)
    return out


def dryrun_table(root: Optional[Path] = None) -> str:
    """Per cell: the dry-run's seconds, this rank's arguments and the
    step's peak over them, and the collective kinds, on both meshes."""
    lines = ["| arch | shape | mesh | dry-run s | args GB/rank | temp GB/rank "
             "| collective kinds |",
             "|---|---|---|---|---|---|---|"]
    for mesh in ("pod16x16", "pod2x16x16"):
        for r in sorted(load_records(mesh, root=root), key=_key):
            if r.get("skipped"):
                continue
            if not r.get("ok"):
                lines.append(f"| {r['arch']} | {r['shape']} | {mesh} | FAIL |"
                             f" | | {r.get('error','?')} |")
                continue
            ma = r.get("memory_analysis", {})
            kinds = sorted(r.get("collectives", {}).get("per_kind", {}))
            lines.append(
                f"| {r['arch']} | {r['shape']} | {mesh} "
                f"| {r.get('dryrun_s','-')} "
                f"| {ma.get('argument_size_in_bytes', 0)/1e9:.1f} "
                f"| {ma.get('temp_size_in_bytes', 0)/1e9:.1f} "
                f"| {','.join(kinds)} |")
    return "\n".join(lines)


def summary_stats(mesh: str = "pod16x16",
                  root: Optional[Path] = None) -> Dict:
    recs = [r for r in load_records(mesh, root=root) if r.get("ok")]
    rf = [from_record(r) for r in recs]
    return {
        "cells_ok": len(recs),
        "bottlenecks": {b: sum(1 for r in rf if r.dominant == b)
                        for b in ("compute", "memory", "collective")},
        "worst_mfu": min(rf, key=lambda r: r.mfu_bound).arch if rf else None,
        "most_collective": max(rf, key=lambda r: r.collective_s).arch
        if rf else None,
    }


if __name__ == "__main__":
    print("## Single-pod roofline (16x16 = 256 H100s), reckoned on meta "
          "tensors from H100 constants, not measured\n")
    print(roofline_table("pod16x16"))
    print("\n\n## Dry-run matrix\n")
    print(dryrun_table())
    print("\n", json.dumps(summary_stats(), indent=1))
