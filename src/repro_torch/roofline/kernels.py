"""The work of one launch of each of the port's kernels, K1-K7 and K4's
backward, from its operands' shapes and dtypes alone: the bytes it must
move (each input read once, each output written once) and the operations
it does, by the dtype whose peak rate they run at.  The least time a card
could take for that work is the larger of the bytes over the card's memory
rate and the operations over its peak rates (``Work.bound``); the rates
are those of an H100 SXM (the ``analysis`` module's datasheet).

Two users read these numbers: ``chip_smoke.py``'s bound column, and the
dry-run and the roofline, through ``WorkCounter``.  Each kernel wrapper
reports every launch it makes on the card, and every call its meta path
takes on meta tensors, to the active counter, so a counted step on the
card and the dry-run of that step add up the same kernels.  With no
counter active the report is one ``None`` check.

K1's work depends on how many rows its slots hold live, which only its
``positions`` tell: the bound column counts the rows a run's data needs
(``k1_bound``); a wrapper reports the whole table's extent (``b · m ·
page`` rows), since reading ``positions`` would synchronize the host with
the card and a meta tensor holds no value.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

#: HBM3 of an H100 SXM, bytes per second
HBM_BYTES_PER_S = 3.35e12
#: dense peak operations per second by the dtype they run in (bf16 on the
#: tensor cores; fp32 on the CUDA cores, TF32 off)
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


@dataclass(frozen=True)
class Work:
    """``nbytes`` moved, and ``flops`` as ((dtype, operations), ...) in
    the order their times add up."""
    nbytes: int
    flops: Tuple[Tuple[torch.dtype, int], ...]

    @property
    def total_flops(self) -> int:
        return sum(n for _, n in self.flops)

    def bound(self) -> Tuple[float, str]:
        """(least ms, ``"bytes"`` or ``"operations"``, whichever bounds)."""
        t_bytes = self.nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = sum(n / PEAK_FLOPS[_peak_dtype(dt)]
                    for dt, n in self.flops) * 1e3
        return ((t_bytes, "bytes") if t_bytes >= t_ops
                else (t_ops, "operations"))


def _peak_dtype(dt):
    """bf16 and fp16 run on the tensor cores, the rest at fp32's rate."""
    return torch.bfloat16 if dt in (torch.bfloat16, torch.float16) \
        else torch.float32


def _size(t) -> int:
    return t.numel() * t.element_size()


# ------------------------------------------------------------- per kernel --

def paged_decode(q, table, rows: int, quant: bool, partials: bool) -> Work:
    """K1 over ``rows`` live K/V rows: each K/V byte (int8: and its fp32
    scale) read once, q read once, the output (partials: the fp32 triple)
    written once, the table and positions read once; operations: QK and PV
    at q's dtype (bf16 q over native or int8 rows: the tensor cores, where
    the kernel converts int8 rows to bf16), and int8's dequantization at
    fp32.  q (B, KV, G, D); table (B, M)."""
    b, kv, g, d = q.shape
    row_b = kv * (d + 4) if quant else kv * d * q.element_size()
    out_b = b * kv * g * (d + 2) * 4 if partials else _size(q)
    nbytes = (2 * rows * row_b + _size(q) + out_b
              + 4 * (table.numel() + b))
    return Work(nbytes, ((q.dtype, 4 * kv * g * d * rows),
                         (torch.float32, 2 * rows * kv * d if quant else 0)))


def k1_bound(q, table, rows: int, quant: bool, partials: bool):
    """``paged_decode``'s bound: (ms, "bytes" or "operations", bytes)."""
    w = paged_decode(q, table, rows, quant, partials)
    return w.bound() + (w.nbytes,)


def flash_attention(q, k, causal: bool) -> Work:
    """K2 on the model layout, q (B, S, KV, G, D), k (B, S, KV, D): q, k,
    v read once, the output written once; QK and PV over the causal
    triangle (or the whole square), at q's dtype."""
    b, s, kv, g, d = q.shape
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    flops = 4 * b * kv * g * d * (s * (s + 1) // 2 if causal else s * s)
    return Work(nbytes, ((q.dtype, flops),))


def rmsnorm(x, d: int) -> Work:
    """K3 over x (N, d): x read and written once, the fp32 scale read once;
    four operations an element, in fp32."""
    n = x.numel() // d
    return Work(2 * x.numel() * x.element_size() + 4 * d,
                ((torch.float32, 4 * n * d),))


def softmax_xent_fwd(n: int, vp: int, itemsize: int) -> Work:
    """K4's forward over (N, Vp) logits: the logits and int32 labels read
    once, nll and lse (fp32) written once; four operations a logit, in
    fp32."""
    elems = n * vp
    return Work(elems * itemsize + n * 4 + 2 * n * 4,
                ((torch.float32, 4 * elems),))


def softmax_xent_bwd(n: int, vp: int, itemsize: int) -> Work:
    """K4's backward: the logits read and dlogits written once, labels,
    lse and the two upstream gradients read once; four operations a logit,
    in fp32."""
    elems = n * vp
    return Work(2 * elems * itemsize + 4 * n * 4,
                ((torch.float32, 4 * elems),))


def adamw(n: int, g_itemsize: int) -> Work:
    """K5 over n parameters: the gradient read, m, v and p read and written
    (fp32); fifteen operations an element, in fp32."""
    return Work(n * (g_itemsize + 24), ((torch.float32, 15 * n),))


def ssd_scan(x, da, b, c) -> Work:
    """K6 on x (.., P), da, b, c (.., N): every input read once, y (like x)
    written once; five operations per element of x per state, at x's
    dtype."""
    nbytes = sum(_size(t) for t in (x, da, b, c)) + _size(x)
    return Work(nbytes, ((x.dtype, 5 * x.numel() * b.shape[-1]),))


def wkv6_scan(r, k, v, lw, u) -> Work:
    """K7 on r, k, lw (.., K), v (.., V), u (H, K): every input read once,
    y (like v) written once; five operations per element of v per key,
    at r's dtype."""
    nbytes = sum(_size(t) for t in (r, k, v, lw, u)) + _size(v)
    return Work(nbytes, ((r.dtype, 5 * v.numel() * k.shape[-1]),))


# ----------------------------------------------------------- the counter --

_ACTIVE: Optional["WorkCounter"] = None


class WorkCounter:
    """Sums the work of every kernel launch (on the card) and meta-path
    call (on meta tensors) made while it is active, by kernel name (the
    names of ``kernels.ops.launch_counts``)."""

    def __init__(self):
        self.launches: Dict[str, int] = {}
        self.nbytes: Dict[str, int] = {}
        self.flops: Dict[str, Dict[str, int]] = {}

    def add(self, name: str, work: Work) -> None:
        self.launches[name] = self.launches.get(name, 0) + 1
        self.nbytes[name] = self.nbytes.get(name, 0) + work.nbytes
        by = self.flops.setdefault(name, {})
        for dt, n in work.flops:
            key = str(_peak_dtype(dt)).replace("torch.", "")
            by[key] = by.get(key, 0) + n

    @property
    def total_flops(self) -> int:
        return sum(sum(by.values()) for by in self.flops.values())

    @property
    def total_bytes(self) -> int:
        return sum(self.nbytes.values())

    def flops_by_dtype(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for by in self.flops.values():
            for k, n in by.items():
                out[k] = out.get(k, 0) + n
        return out

    def summary(self) -> Dict[str, Dict]:
        return {name: {"launches": self.launches[name],
                       "bytes": self.nbytes[name],
                       "flops": self.flops[name]}
                for name in sorted(self.launches)}

    def __enter__(self):
        global _ACTIVE
        self._prev, _ACTIVE = _ACTIVE, self
        return self

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = self._prev


def report(name: str, work_fn, *args) -> None:
    """Add ``work_fn(*args)`` under ``name`` to the active counter; nothing
    (and no work computed) when none is active."""
    if _ACTIVE is not None:
        _ACTIVE.add(name, work_fn(*args))
