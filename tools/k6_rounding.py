#!/usr/bin/env python3
"""Holds K6's bf16 mode (the Mamba2 SSD scan) against emulations of its
rounding points, on one CUDA card.

    python3 tools/k6_rounding.py

At zamba2-1.2b's eval shape (B=4, H=64, P=N=64, S=2048 and a ragged 2000,
the smoke's inputs) it compares the kernel's bf16 y with fp32 emulations
that round a chosen set of the tile's intermediates to bf16: the set the
source names (G, the state S and X o w; the package's ``ssd_scan_mma_emu``),
that set with one point more (C o e^cs, the other operand the tensor cores
could take rounded) or one fewer, and none.  For each it prints the
emulation's largest distance from the all-fp32 plain version and the share
of the kernel's elements equal to the emulation rounded to bf16: only the
set the kernel really rounds should match nearly all of them.  It needs the
card; the card's name and power limit are printed last.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import mamba2_ssd as ssd  # noqa: E402

SOURCE = frozenset({"g", "s", "xw"})
VARIANTS = {"source (G, S, X o w)": SOURCE, "+ C o e^cs": SOURCE | {"ce"},
            "- G": SOURCE - {"g"}, "- S": SOURCE - {"s"},
            "- X o w": SOURCE - {"xw"}, "none": frozenset()}


def emulate(x, da, b, c, rounded):
    """``ssd_scan_mma_emu`` with the rounded intermediates chosen."""
    def r(v, name):
        return v.to(torch.bfloat16).float() if name in rounded else v

    bh, s, p = x.shape
    h, t = bh // b.shape[0], ssd.TILE
    pad = -s % t
    xf = F.pad(x.float(), (0, 0, 0, pad))
    daf = F.pad(da.float(), (0, pad))
    bf = F.pad(b.float(), (0, 0, 0, pad)).repeat_interleave(h, dim=0)
    cf = F.pad(c.float(), (0, 0, 0, pad)).repeat_interleave(h, dim=0)
    state = x.new_zeros((bh, p, b.shape[-1]), dtype=torch.float32)
    tri = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    ys = []
    for t0 in range(0, s + pad, t):
        xc, dac = xf[:, t0:t0 + t], daf[:, t0:t0 + t]
        bc, cc = bf[:, t0:t0 + t], cf[:, t0:t0 + t]
        cs_ = dac.cumsum(dim=1)
        g = torch.where(tri, cc @ bc.transpose(1, 2)
                        * torch.exp(cs_[:, :, None] - cs_[:, None, :]), 0.0)
        st = r(state, "s").transpose(1, 2)
        if "ce" in rounded:
            y = r(cc * torch.exp(cs_)[..., None], "ce") @ st
        else:
            y = cc @ st * torch.exp(cs_)[..., None]
        ys.append(y + r(g, "g") @ xc)
        xw = r(xc * torch.exp(cs_[:, -1:] - cs_)[..., None], "xw")
        state = (state * torch.exp(cs_[:, -1])[:, None, None]
                 + xw.transpose(1, 2) @ bc)
    return torch.cat(ys, dim=1)[:, :s]


def main() -> int:
    if not torch.cuda.is_available():
        print("k6_rounding: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(10)
    b, h, p, n = 4, 64, 64, 64
    for s in (2048, 2000):
        x, da, bm, cm = cs.k6_inputs(b, s, h, p, n, torch.bfloat16, gen)
        got = ssd.ssd_scan_bhsd(x, da, bm, cm)
        ref = ssd.ssd_scan_ref(x.float(), da, bm.float(), cm.float(),
                               chunk=256)
        assert torch.equal(emulate(x, da, bm, cm, SOURCE),
                           ssd.ssd_scan_mma_emu(x, da, bm, cm))
        for name, rounded in VARIANTS.items():
            e = emulate(x, da, bm, cm, rounded)
            same = float((got == e.to(torch.bfloat16)).float().mean())
            print(f"S={s} rounded {name:22s}: max |emulation - plain| "
                  f"{cs.max_err(e, ref):.3e}, kernel equal to it in bf16 in "
                  f"{same:.5f} of {got.numel()} elements, max |kernel - "
                  f"emulation| {cs.max_err(got, e):.3e}", flush=True)
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
