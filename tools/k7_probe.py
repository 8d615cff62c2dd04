#!/usr/bin/env python3
"""Checks K7, the RWKV6 WKV scan, at a sweep of shapes on one CUDA card.

    python3 tools/k7_probe.py

Both modes through ``wkv6_scan_model`` on the model layout against the
plain version (fp32 1e-4, bf16 2e-2) at a ragged S, one step, K = V = 8,
16, 64 and 128, V split unevenly over a row's blocks (48, 40) and
rwkv6-1.6b's eval width at S = 2000; bf16 also against the plain
emulation of its rounding points (the share of elements equal after
rounding, gate 0.999); then the plan's shared memory and blocks per SM
beside the C entries'.  The last line is ``PROBE OK 0`` or ``PROBE FAIL
n`` (n checks failed; exit code 1).
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import rwkv6_wkv as wkv  # noqa: E402

SHAPES = [(1, 64, 1, 16, 16, 16), (2, 100, 3, 64, 48, 32),
          (1, 1, 2, 64, 64, 32), (2, 300, 2, 128, 128, 32),
          (1, 70, 2, 8, 8, 32), (2, 130, 2, 128, 40, 16),
          (4, 2000, 32, 64, 64, 32)]


def main() -> int:
    if not torch.cuda.is_available():
        print("k7_probe: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(5)
    bad = 0
    for b, s, h, kd, vd, chunk in SHAPES:
        for dt in (torch.float32, torch.bfloat16):
            r, k, _, lw, u = cs.k7_inputs(b, s, h, kd, dt, gen)
            v = (0.15 * torch.randn(b, s, h, vd, generator=gen)).to(cs.DEV, dt)
            y = cs.fold(wkv.wkv6_scan_model(r, k, v, lw, u, chunk=chunk))
            public = [cs.fold(t) for t in (r, k, v, lw)]
            ref = wkv.wkv6_scan_ref(*public, u, chunk=chunk)
            torch.cuda.synchronize()
            err = cs.max_err(y, ref)
            msg = (f"b={b} s={s} h={h} K={kd} V={vd} chunk={chunk} "
                   f"{str(dt)[6:]}: max_abs_err {err:.3e}")
            if dt == torch.bfloat16:
                emu = wkv.wkv6_scan_mma_emu(*public, u)
                same = float((y == emu.to(dt)).float().mean())
                msg += (f", equal to the emulation in {same:.5f} of the "
                        f"elements, max |y - emulation| "
                        f"{cs.max_err(y, emu):.3e}")
                bad += same < 0.999
            bad += not err <= cs.TOL[dt]
            print(msg, flush=True)
    smem = _build.entry("rwkv6_wkv_smem_bytes")
    blocks = _build.entry("rwkv6_wkv_blocks_per_sm")
    for code, mode in ((0, "fp32"), (1, "bf16")):
        for kd, vs in ((64, 32), (64, 16), (128, 32), (128, 16)):
            if mode == "fp32" and vs == 16:
                continue
            got = (smem(code, kd, vs), blocks(code, kd, vs))
            want = (wkv.smem_bytes(mode, kd, vs),
                    wkv.blocks_per_sm(mode, kd, vs))
            print(f"{mode} K={kd} VS={vs}: shared memory and blocks per SM, "
                  f"C entries {got}, plan {want}")
            bad += got != want
    print(cs.nvidia_smi_line())
    print("PROBE", "FAIL" if bad else "OK", bad)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
