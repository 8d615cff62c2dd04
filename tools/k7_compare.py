#!/usr/bin/env python3
"""Times K7, the RWKV6 WKV scan, in both its modes on one CUDA card, and
optionally an earlier version of its source beside it.

    python3 tools/k7_compare.py [--parent DIR] [--vs N ...] [NAME=OLD->NEW[||OLD->NEW...]]

The committed ``src/repro_torch/csrc/rwkv6_wkv.cu`` is built as usual
(``_build``) and called through ``wkv6_scan_model`` on the model layout
(B, S, H, K) at rwkv6-1.6b's eval shape (B=4, H=32, S=2048, K=V=64, chunk
32), bf16 and fp32; ``--vs`` also times the bf16 mode with the state split
into N-column slices instead of the plan's (16 or 32).  Each variant NAME
is a copy of the committed source with the given text substitutions (an OLD
that is not in the source is an error), built beside it into
``build/k7_compare/``.  With ``--parent``, ``DIR/src/repro_torch/csrc/
rwkv6_wkv.cu`` (an unpacked earlier commit, whose C entry takes the public
(B*H, S, K) layout, contiguous, and no strides or split) is built there too
and timed twice: its kernel alone on the folded tensors, and as its
``ops.rwkv6_wkv`` ran it, with the permute copies into that layout.  Each
version is checked against the plain version (``wkv6_scan_ref``: 2e-2
bf16, 1e-4 fp32) and for two bitwise-equal calls, then all are timed in
turns (CUDA-graph replay, CUDA events: versions in order, then back again)
beside the plain version and the bytes bound.  The card's name and power
limit are printed last.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import rwkv6_wkv as wkv  # noqa: E402

B, H, S, KD, CHUNK = 4, 32, 2048, 64, 32
PARENT_ARGS = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 \
    + [ctypes.c_void_p]


def build(variants, parent):
    """C launch entries of each variant and of the parent, compiled at
    once."""
    out = ROOT / "build" / "k7_compare"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "rwkv6_wkv.cu").read_text()
    for header in _build.CSRC.glob("*.cuh"):
        shutil.copy(header, out / header.name)
    sources = {}
    for name, subs in variants.items():
        text = src
        for sub in filter(None, subs.split("||")):
            old, new = sub.split("->")
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        sources[name] = out / f"{name}.cu"
        sources[name].write_text(text)
    if parent is not None:
        sources["parent"] = parent / "src" / "repro_torch" / "csrc" / \
            "rwkv6_wkv.cu"
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
         str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name, path in sources.items()}
    entries = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log}", flush=True)
            continue
        regs = sorted({line.split("Used")[1].split(",")[0].strip()
                       for line in log.splitlines() if "Used" in line})
        print(f"{name}: built, {regs}", flush=True)
        fn = ctypes.CDLL(str(out / f"{name}.so")).rwkv6_wkv_launch
        fn.restype = ctypes.c_int
        fn.argtypes = PARENT_ARGS if name == "parent" else \
            _build.ENTRIES["rwkv6_wkv_launch"][1]
        entries[name] = fn
    return entries


def parent_call(fn, r, k, v, lw, u):
    """The parent's launch on the public layout (B*H, S, D), contiguous."""
    out = torch.empty(B * H, S, v.shape[-1], dtype=v.dtype, device=v.device)
    rc = fn(wkv._DTYPES[r.dtype], r.data_ptr(), k.data_ptr(), v.data_ptr(),
            lw.data_ptr(), u.data_ptr(), out.data_ptr(), B * H, H, S, KD,
            v.shape[-1], CHUNK, torch.cuda.current_stream().cuda_stream)
    _build.check(rc, "parent K7")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--vs", type=int, action="append", default=[])
    ap.add_argument("variants", nargs="*", metavar="NAME=OLD->NEW")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k7_compare: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    entries = {}
    try:            # a version that does not build is reported and left out
        _build.build(["rwkv6_wkv"])
        for line in _build.compiler_log("rwkv6_wkv").splitlines():
            if any(w in line for w in ("Used", "spill", "Compiling entry")):
                print(f"  {line.strip()}")
        entries["base"] = _build.entry("rwkv6_wkv_launch")
    except RuntimeError as e:
        print(f"base: {e}", flush=True)
    variants = dict(v.split("=", 1) for v in args.variants)
    entries.update(build(variants, args.parent))
    built = len(entries) == 1 + len(variants) + (args.parent is not None)
    gen = torch.Generator().manual_seed(11)
    inputs = {dt: cs.k7_inputs(B, S, H, KD, dt, gen)
              for dt in (torch.bfloat16, torch.float32)}
    folded = {dt: [cs.fold(t).contiguous() for t in a[:4]]
              for dt, a in inputs.items()}
    refs = {dt: wkv.wkv6_scan_ref(*f, inputs[dt][4], chunk=CHUNK)
            for dt, f in folded.items()}

    calls = {}          # (label, dtype) -> fn
    for name, fn in entries.items():
        for dt, a in inputs.items():
            mode = "bf16" if dt == torch.bfloat16 else "fp32"
            if name == "parent":
                calls[("parent kernel, public layout", dt)] = \
                    (lambda fn, f, u: lambda: parent_call(fn, *f, u))(
                        fn, folded[dt], a[4])
                # as the parent's ops.rwkv6_wkv ran it: permute copies first
                calls[("parent ops (permute copies + kernel)", dt)] = \
                    (lambda fn, a: lambda: parent_call(
                        fn, *(cs.fold(t) for t in a[:4]), a[4]))(fn, a)
                continue
            vss = [None] + ([v for v in args.vs if v != wkv.vs_for(mode, KD)]
                            if name == "base" and mode == "bf16" else [])
            for vs in vss:
                def call(fn=fn, a=a, vs=vs):
                    out = torch.empty_like(a[2])
                    p = wkv.plan(*a, out, chunk=CHUNK)
                    if vs is not None:
                        p = dataclasses.replace(p, vs=vs)
                    _build._entries["rwkv6_wkv_launch"] = fn
                    wkv._launch(p, *a, out)
                    return out
                label = name + (f" vs={vs}" if vs else "")
                calls[(label, dt)] = call
    for (label, dt), fn in calls.items():
        got, again = fn(), fn()
        torch.cuda.synchronize()
        if got.dim() == 4:
            got, again = cs.fold(got), cs.fold(again)
        err = cs.max_err(got, refs[dt])
        same = torch.equal(got, again)
        print(f"{label} {str(dt)[6:]}: max_abs_err vs plain {err:.3e} (tol "
              f"{cs.TOL[dt]}), two calls bitwise equal {same}", flush=True)
    order = list(calls) + list(reversed(calls))
    times = {key: [] for key in calls}
    for key in order:
        times[key].append(cs.time_ms(calls[key], iters=20))
    for dt, a in inputs.items():
        plain_ms = cs.time_ms(lambda: wkv.wkv6_scan_ref(
            *folded[dt], a[4], chunk=CHUNK), iters=5)
        nbytes = cs._nbytes(*a) + cs._nbytes(a[2])
        bms, by = cs.bound(nbytes, 5 * a[2].numel() * KD, dt)
        print(f"{str(dt)[6:]} B={B} H={H} S={S} K=V={KD}: plain "
              f"{plain_ms:.4f} ms, bound {bms:.5f} ms ({by}; {nbytes} B)")
        for (label, d), ts in times.items():
            if d == dt:
                print(f"  {label}: " + " ".join(f"{t:.4f}" for t in ts)
                      + " ms", flush=True)
    print(cs.nvidia_smi_line())
    return 0 if built else 1


if __name__ == "__main__":
    sys.exit(main())
