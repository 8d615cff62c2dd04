"""Per-rank collective bytes of a step, from the records of
``parallel.collectives.CollectiveCounter`` (the port's counterpart of the
JAX ``repro.roofline.hlo``, which reads them off XLA's partitioned HLO;
the port runs its collectives eagerly, so the counter sees each one).

Bytes on the wire per op (ring algorithms, ``hlo.py``'s rules):
  all-reduce          2 × size   (reduce-scatter + all-gather phases)
  all-gather          result size (each rank receives ~the full result)
  reduce-scatter      operand size (each rank sends ~its full operand)
  all-to-all          size       (each rank sends all but its own slice)
  collective-permute  size       (a pipeline hop: ``send``/``recv``)

A collective's time goes over the slowest link its group crosses
(``link_of``): ranks lie row-major, eight to a node, so a group inside
eight consecutive ranks stays on NVLink, and one that spans nodes crosses
the network.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, List

#: H100 SXM nodes hold eight cards
NODE_SIZE = 8


def wire_bytes(rec: Dict) -> int:
    """The bytes one rank moves for a counter record (see the module)."""
    kind = rec["kind"]
    if kind == "all-reduce":
        return 2 * rec["in_bytes"]
    if kind == "all-gather":
        return rec["out_bytes"]
    if kind == "reduce-scatter":
        return rec["in_bytes"]
    return max(rec["in_bytes"], rec["out_bytes"])


def link_of(ranks: Iterable[int]) -> str:
    """``"nvlink"`` when every rank of the group sits in one node,
    ``"network"`` when the group spans nodes."""
    return ("nvlink" if len({r // NODE_SIZE for r in ranks}) <= 1
            else "network")


def parse_collectives(records: List[Dict]) -> Dict[str, Dict]:
    """The counter's records -> per-kind {count, bytes}, ``total_bytes``,
    the bytes over each link (``by_link``) and the twelve ``largest_ops``
    as (kind, bytes, group size), the JAX ``parse_collectives``' dict."""
    stats = defaultdict(lambda: {"count": 0, "bytes": 0})
    by_link = {"nvlink": 0, "network": 0}
    ops = []
    for rec in records:
        b = wire_bytes(rec)
        stats[rec["kind"]]["count"] += 1
        stats[rec["kind"]]["bytes"] += b
        by_link[link_of(rec["ranks"])] += b
        ops.append((rec["kind"], b, rec["group_size"]))
    total = sum(v["bytes"] for v in stats.values())
    return {"per_kind": dict(stats), "total_bytes": int(total),
            "by_link": by_link,
            "largest_ops": sorted(ops, key=lambda t: -t[1])[:12]}


def count_op_flavors(op_names: Iterable[str]) -> Dict[str, int]:
    """How often each aten op ran (the JAX ``count_op_flavors``, which
    counts HLO ops): a structural profile of a step."""
    counts: Dict[str, int] = defaultdict(int)
    for name in op_names:
        counts[name] += 1
    return dict(counts)
