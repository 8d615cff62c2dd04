#!/usr/bin/env python3
"""Times K1, the paged flash-decode, in all its modes on one CUDA card, and
optionally an earlier version of its source beside it.

    python3 tools/k1_compare.py [--parent DIR] [NAME=OLD->NEW[||OLD->NEW...]]

The committed ``src/repro_torch/csrc/paged_decode.cu`` is built as usual
(``_build``) and called through the port's wrappers.  With ``--parent``,
``DIR/src/repro_torch/csrc/paged_decode.cu`` (an unpacked earlier commit,
whose C entry lacks the trailing split count) is built beside it into
``build/k1_compare/`` and called through the same wrappers; so is each
variant NAME, a copy of the committed source with the given text
substitutions (an OLD that is not in the source is an error).  Shapes:
qwen3-4b decode (B=8, KV=8, G=4, D=128, page 16, bf16 q) at the served
shape (M=32, positions ``chip_smoke.K1_SERVE_POS``, 974 live rows), at a
4,096-position context (M=256, every slot at 4095: 32,768 rows, ~134 MB
of K/V, beyond the 50 MB L2) and at a ragged long batch
(``K1_RAGGED_LONG_POS``); native and int8 pools, normalized and, on n=2
shards, partials.  Each version is checked against the plain version and
for two bitwise-equal calls, then the versions are timed in turns (base,
parent, parent, base: CUDA-graph replay, CUDA events) beside the bound,
the plain version and the yardstick of ``chip_smoke.k1_library``, each
measured once.  The card's name and power limit are printed last.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import paged_decode as pd  # noqa: E402
from repro_torch.kernels.quant import quantize_kv  # noqa: E402


def build(variants, parent):
    """C entries of the parent (wrapped to take, and drop, this tree's
    trailing split count) and of each variant, compiled at once."""
    out = ROOT / "build" / "k1_compare"
    out.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "paged_decode.cu").read_text()
    sources = {}
    if parent is not None:
        sources["parent"] = parent / "src" / "repro_torch" / "csrc" / \
            "paged_decode.cu"
    (out / "common.cuh").write_text((_build.CSRC / "common.cuh").read_text())
    for name, subs in variants.items():
        text = src
        for sub in filter(None, subs.split("||")):
            old, new = sub.split("->")
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        sources[name] = out / f"{name}.cu"
        sources[name].write_text(text)
    procs = {name: subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out / f"{name}.so"),
         str(path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name, path in sources.items()}
    entries = {}
    argtypes = _build.ENTRIES["paged_decode_launch"][1]
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"{name}: nvcc failed\n{log}")
        regs = sorted({line.split("Used")[1].split(",")[0].strip()
                       for line in log.splitlines() if "Used" in line})
        print(f"{name}: built, {regs}", flush=True)
        fn = ctypes.CDLL(str(out / f"{name}.so")).paged_decode_launch
        fn.restype = ctypes.c_int
        if name == "parent":
            fn.argtypes = argtypes[:22] + [ctypes.c_void_p]
            entries[name] = (lambda f: lambda *a: f(*a[:22], a[-1]))(fn)
        else:
            fn.argtypes = argtypes
            entries[name] = fn
    return entries


def cases():
    """(label, q, pools, table, pos, off) of every timed case, bf16 q."""
    gen = torch.Generator().manual_seed(11)
    out = []
    for shape, m, pos in (("serve", 32, cs.K1_SERVE_POS),
                          ("long", 256, cs.K1_LONG_POS),
                          ("ragged-long", 256, cs.K1_RAGGED_LONG_POS)):
        q, k, v, table, p = cs.k1_inputs(torch.bfloat16, gen, m, pos,
                                         nan_dead=False)
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        for fmt, pools in (("native", (k, v)), ("int8", (kq, vq, ks, vs))):
            out.append((f"{shape} {fmt}", q, pools, table, p, None))
            if shape != "ragged-long":
                for c in range(2):
                    shard = [cs._shard_of(t, 2, c)[0] for t in pools]
                    off = cs._shard_of(pools[0], 2, c)[1]
                    out.append((f"{shape} {fmt} partials n=2 shard {c}", q,
                                shard, table, p, off))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("variants", nargs="*", metavar="NAME=OLD->NEW")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_compare: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build(["paged_decode"])
    for line in _build.compiler_log("paged_decode").splitlines():
        if any(w in line for w in ("Used", "spill", "Compiling entry")):
            print(f"  {line.strip()}")
    versions = {"base": _build.entry("paged_decode_launch")}
    smem = _build.entry("paged_decode_smem_bytes")
    for m in (32, 256):
        for quant in (False, True):
            pl = pd.plan(8, 8, 4, 128, 16, m, torch.bfloat16, quant, False,
                         pd._n_sms(0))
            print(f"plan M={m} {'int8' if quant else 'bf16'}: {pl}; kernel "
                  f"smem {smem(1, int(quant), 4, 128, m)}", flush=True)
    versions.update(build(dict(v.split("=", 1) for v in args.variants),
                          args.parent))

    def use(name):
        _build._entries["paged_decode_launch"] = versions[name]

    todo = cases()
    for name in versions:
        use(name)
        for label, q, pools, table, pos, off in todo:
            got = cs.k1_call(pd, q, pools, table, pos, off)
            again = cs.k1_call(pd, q, pools, table, pos, off)
            ref = cs.k1_plain(pd, q, pools, table, pos, off)
            torch.cuda.synchronize()
            if off is None:
                err, same = cs.max_err(got, ref), torch.equal(got, again)
            else:
                err = cs._triple_err(got, ref)
                same = all(torch.equal(a, b) for a, b in zip(got, again))
            print(f"{name} {label}: error vs plain {err:.3e} "
                  f"({'triple rel' if off is not None else 'max abs'}), "
                  f"two calls bitwise equal {same}", flush=True)
    order = [*versions, *reversed(versions)] if len(versions) > 1 else \
        ["base", "base"]
    times = {label: {name: [] for name in versions} for label, *_ in todo}
    for name in order:
        use(name)
        for label, q, pools, table, pos, off in todo:
            times[label][name].append(cs.time_ms(
                lambda: cs.k1_call(pd, q, pools, table, pos, off)))
    use("base")
    for label, q, pools, table, pos, off in todo:
        lib, rows = cs.k1_library(q, pools, table, pos, off)
        bms, by, nbytes = cs.k1_bound(q, table, rows, len(pools) == 4,
                                      off is not None)
        lib_ms = cs.time_ms(lib, iters=10)
        plain_ms = cs.time_ms(lambda: cs.k1_plain(pd, q, pools, table, pos,
                                                  off), iters=10)
        ks = "; ".join(f"{name} " + " ".join(f"{t:.4f}" for t in ts)
                       for name, ts in times[label].items())
        print(f"{label} ({rows} live rows): kernel ms {ks}; plain "
              f"{plain_ms:.4f}, library {lib_ms:.4f}, bound {bms:.5f} ms "
              f"({by}; {nbytes} B)", flush=True)
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
