#!/usr/bin/env python3
"""Times variants of K6's bf16 mode (the Mamba2 SSD scan) on one CUDA card.

    python3 tools/k6_variants.py [NAME=OLD->NEW[||OLD->NEW...] ...]

for example ``stages2='constexpr int kStages = 3;->constexpr int kStages =
2;'``.  The committed source is always built as "base"; each argument
names a copy of ``src/repro_torch/csrc/mamba2_ssd.cu`` with the given text
substitutions (an OLD that is not in the source is an error).  All are
built at once with the port's nvcc flags into ``build/k6_variants/``.
Each is checked against the plain version (``ssd_scan_ref``) at
zamba2-1.2b's eval shape (B=4, H=64, P=N=64, S=2048 and a ragged 2000,
bf16, gate 2e-2) with its ptxas register count and its blocks per SM from
the occupancy API, then all are timed on the model layout (CUDA-graph
replay, CUDA events) in the order given and back again.  It needs the
card and nvcc; the card's name and power limit are printed last.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import mamba2_ssd as ssd  # noqa: E402


def build(variants):
    out = ROOT / "build" / "k6_variants"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "mamba2_ssd.cu").read_text()
    (out / "common.cuh").write_text((_build.CSRC / "common.cuh").read_text())
    procs = {}
    for name, subs in variants.items():
        text = src
        for sub in filter(None, subs.split("||")):
            old, new = sub.split("->")
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        (out / f"{name}.cu").write_text(text)
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
               str(out / f"{name}.so"), str(out / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        regs = [line.split("Used")[1].strip() for line in log.splitlines()
                if "Used" in line]
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        fn = lib.mamba2_ssd_launch
        fn.argtypes = _build.ENTRIES["mamba2_ssd_launch"][1]
        fn.restype = ctypes.c_int
        occ = lib.mamba2_ssd_blocks_per_sm
        occ.argtypes, occ.restype = [], ctypes.c_int
        libs[name] = (fn, occ, regs[0] if regs else "?")
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("k6_variants: no CUDA device", file=sys.stderr)
        return 1
    libs = build({"base": "", **dict(a.split("=", 1) for a in sys.argv[1:])})
    gen = torch.Generator().manual_seed(10)
    b, h, p, n = 4, 64, 64, 64
    cases = {}
    for s in (2048, 2000):
        x, da, bm, cm = cs.k6_inputs(b, s, h, p, n, torch.bfloat16, gen)
        ref = ssd.ssd_scan_ref(x, da, bm, cm, chunk=256)
        y = torch.empty_like(x)
        xm, dam, out = ssd.bhsd_views(x, da, y, h)   # the model layout
        pl = ssd.plan(xm, dam, bm, cm, out)
        cases[s] = (xm, dam, bm, cm, out, y, ref,
                    (ctypes.c_longlong * 13)(*pl.strides()))

    def launcher(fn, s):
        xm, dam, bm, cm, out, _, _, strides = cases[s]

        def go():
            rc = fn(1, xm.data_ptr(), dam.data_ptr(), bm.data_ptr(),
                    cm.data_ptr(), out.data_ptr(), b, h, s, p, n, strides,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: cudaError_t {rc}")
        return go

    for name, (fn, occ, regs) in libs.items():
        errs = []
        for s, case in cases.items():
            launcher(fn, s)()
            torch.cuda.synchronize()
            errs.append(f"S={s} {cs.max_err(case[5], case[6]):.3e}")
        print(f"{name}: max_abs_err vs plain {', '.join(errs)} (gate 2e-2); "
              f"{regs}; {occ()} blocks per SM", flush=True)
    times = {name: [] for name in libs}
    for name in [*libs, *reversed(libs)]:
        times[name].append(cs.time_ms(launcher(libs[name][0], 2048),
                                      iters=20))
    for name, ms in times.items():
        print(f"{name}: {' '.join(f'{t:.4f}' for t in ms)} ms "
              f"(B={b} H={h} P={p} N={n} S=2048, model layout)")
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
