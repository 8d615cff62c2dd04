#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA card; it fails (exit
code 1, no result line) without one.  Phases, each of which fails the run:

1. card: name, power limit, torch and CUDA versions; TF32 off for every
   fp32 comparison (``torch.backends.cuda.matmul.allow_tf32 = False``);
2. build: the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a,
   one process per source) and the Triton RMSNorm and AdamW, with the
   ptxas register/shared/spill lines;
3. kernels against their plain versions on the card, bf16 and fp32, at the
   shapes the serve and train paths give them (fp32 1e-4, bf16 2e-2
   absolute; AdamW 1e-6; the softmax-xent backward elementwise, each
   element to 1e-5 (fp32) or 1e-2 (bf16) of its own size, since its
   elements span ten orders of magnitude; a row pitch that is not 16-byte
   aligned is refused), and their times (CUDA events) beside the plain
   version, one PyTorch call as a yardstick, and the bound from shapes
   (3.35 TB/s; 989 TFLOP/s bf16, 67 TFLOP/s fp32);
4. full-width qwen3-4b in fp32: one batched prefill and 16 decode steps
   through the kernels and through the plain path (dense prefill, gathered
   decode, plain RMSNorm); logits agree to a relative max error of 1e-3 and
   greedy tokens agree wherever the plain top-2 gap exceeds the error;
5. serve: full-width qwen3-4b in bf16 through ``ServeEngine`` (16 requests,
   prompts of 16-200 tokens, some sharing a prefix, 32 new tokens each,
   max_batch 8, max_seq 512, page 16); every request completes, one decode
   dispatch per iteration, and the kernel launch counts match the decode
   steps, prefill dispatches and norms of that run;
6. training parity: full-width qwen3-4b cut to 2 layers, fp32, two train
   steps through K4 and K5 and through their plain versions; loss,
   grad_norm and every parameter agree to a relative max error of 1e-3;
   then in bf16 compute (fp32 parameters, as the train path runs), the
   loss (1e-5) and every gradient leaf (relative max error 2e-2) through
   K4 against the plain loss;
7. training: full-width qwen3-4b cut to 12 layers (fp32 parameters, bf16
   compute), batch 8 x seq 256 from a synthetic corpus, through
   ``FTTrainLoop``; every loss is finite, the last is below the first, and
   K4 forward/backward and K5 launch exactly once per step and once per
   parameter tensor per step; tok/s, step ms, peak memory and MFU, then
   one profiled step: device time by kernel group and the idle share;
   then the same run from the same seed through the plain loss and plain
   AdamW, whose per-step losses the kernel run's match to 2e-2 relative.

It then prints a ``kernels`` JSON line, the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DEV = "cuda"


def log(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str) -> None:
    log(f"\n=== {name} ===")


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Device ms per call: ``iters`` calls captured in one CUDA graph and
    replayed, timed with CUDA events, so host launch cost is excluded."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):          # warm up off the capture stream
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * iters)


def eager_ms(fn, iters: int = 50) -> float:
    """Ms per call of ``iters`` back-to-back eager calls: device time or,
    where it is larger, the host's cost of launching them."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def elem_rel_err(a, b) -> float:
    """max |a - b| / |b| over the elements; where b is 0, a must be 0 too
    (else inf).  For softmax gradients, whose elements span ten orders of
    magnitude: one absolute tolerance would pass a kernel that got every
    small element wrong, so each element is held to its own size."""
    a, b = a.float(), b.float()
    diff = (a - b).abs()
    rel = torch.where(b == 0, torch.where(diff == 0, 0.0, float("inf")),
                      diff / b.abs())
    return float(rel.max())


# ------------------------------------------------------------- phase 3 ----

def k1_inputs(dtype, gen):
    """qwen3-4b decode shapes: B=8, KV=8, G=4, D=128, page 16, M=32.
    Ragged positions (0, page boundaries, a full table), one freed slot
    (all-zero row at position 0), and every dead page filled with NaN."""
    b, kv, g, d, page, m = 8, 8, 4, 128, 16, 32
    n_pages = b * m + 1
    positions = torch.tensor([0, 15, 16, 17, 130, 255, 511, 0],
                             dtype=torch.int32)
    perm = torch.randperm(n_pages - 1, generator=gen) + 1
    table = perm[: b * m].reshape(b, m).to(torch.int32)
    table[7] = 0                                     # freed slot
    k = torch.randn(n_pages, page, kv, d, generator=gen)
    v = torch.randn(n_pages, page, kv, d, generator=gen)
    for s in range(b - 1):
        dead = table[s, positions[s] // page + 1:].long()
        k[dead] = float("nan")
        v[dead] = float("nan")
    q = torch.randn(b, kv, g, d, generator=gen)
    return [t.to(DEV) for t in (q.to(dtype), k.to(dtype), v.to(dtype),
                                 table, positions)]


def check_k1(report):
    from repro_torch.kernels import paged_decode as pd
    gen = torch.Generator().manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, table, pos = k1_inputs(dtype, gen)
        out = pd.paged_flash_decode(q, k, v, table, pos)
        ref = pd.paged_decode_ref(q, k, v, table, pos)
        torch.cuda.synchronize()
        err = max_err(out, ref)
        finite = bool(torch.isfinite(out.float()).all())
        log(f"K1 paged_flash_decode {str(dtype)[6:]:8s} B=8 KV=8 G=4 D=128 "
            f"page=16 M=32: max_abs_err {err:.3e} (tol {TOL[dtype]}), "
            f"finite={finite}")
        assert finite and err <= TOL[dtype], "K1 disagrees with its plain"
    # timing at the serve shapes, bf16, no NaN pages
    b, kv, g, d, page, m = 8, 8, 4, 128, 16, 32
    q, k, v, table, pos = k1_inputs(torch.bfloat16, gen)
    k, v = torch.nan_to_num(k), torch.nan_to_num(v)
    pos = torch.tensor([40, 75, 110, 140, 170, 200, 231, 0], dtype=torch.int32,
                       device=DEV)
    out = pd.paged_flash_decode(q, k, v, table, pos)
    err = max_err(out, pd.paged_decode_ref(q, k, v, table, pos))
    ms = time_ms(lambda: pd.paged_flash_decode(q, k, v, table, pos))
    host_ms = eager_ms(lambda: pd.paged_flash_decode(q, k, v, table, pos))
    plain_ms = time_ms(lambda: pd.paged_decode_ref(q, k, v, table, pos))
    # yardstick: SDPA on the gathered (dead-page-redirected) view, its K/V
    # heads expanded to the G query heads beforehand, outside the timing
    live = torch.arange(m, device=DEV)[None] <= (pos.long() // page)[:, None]
    tbl = torch.where(live, table.long(), 0)

    def heads(pool):
        x = pool[tbl].reshape(b, m * page, kv, 1, d).expand(-1, -1, -1, g, -1)
        return x.reshape(b, m * page, kv * g, d).permute(0, 2, 1, 3) \
            .contiguous()

    kg, vg = heads(k), heads(v)
    qh = q.reshape(b, kv * g, 1, d)
    mask = (torch.arange(m * page, device=DEV)[None]
            <= pos.long()[:, None])[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(lambda: sdpa(qh, kg, vg, attn_mask=mask))
    rows = int((pos.long() + 1).sum())
    nbytes = (2 * rows * kv * d + 2 * q.numel()) * 2 + 4 * (table.numel() + b)
    bms, by = bound(nbytes, 4 * kv * g * d * rows, torch.bfloat16)
    log(f"K1 timing bf16, positions {pos.tolist()}: kernel {ms:.4f} ms "
        f"(eager back-to-back {host_ms:.4f} ms), "
        f"plain {plain_ms:.4f} ms, SDPA on gathered view {lib_ms:.4f} ms, "
        f"bound {bms:.5f} ms ({by})")
    report["paged_flash_decode"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=lib_ms)


def check_k2(report):
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator().manual_seed(2)
    kv, g, d = 8, 4, 128
    for dtype in (torch.float32, torch.bfloat16):
        for s in (16, 32, 64, 128, 256, 512, 200):
            for causal in (True, False):
                n = 2
                q = torch.randn(n * kv * g, s, d, generator=gen)
                k = torch.randn(n * kv, s, d, generator=gen)
                v = torch.randn(n * kv, s, d, generator=gen)
                q, k, v = (t.to(DEV, dtype) for t in (q, k, v))
                out = fa.flash_attention_bhsd(q, k, v, causal=causal)
                ref = fa.flash_attention_ref(q, k, v, causal=causal)
                torch.cuda.synchronize()
                err = max_err(out, ref)
                ok = bool(torch.isfinite(out.float()).all()) \
                    and err <= TOL[dtype]
                log(f"K2 flash_attention {str(dtype)[6:]:8s} S={s:3d} "
                    f"causal={causal!s:5s}: max_abs_err {err:.3e}")
                assert ok, "K2 disagrees with its plain version"
    # timing at the largest serve prefill bucket: 8 prompts of bucket 256
    n, s = 8, 256
    q = torch.randn(n * kv * g, s, d, generator=gen).to(DEV, torch.bfloat16)
    k = torch.randn(n * kv, s, d, generator=gen).to(DEV, torch.bfloat16)
    v = torch.randn(n * kv, s, d, generator=gen).to(DEV, torch.bfloat16)
    err = max_err(fa.flash_attention_bhsd(q, k, v),
                  fa.flash_attention_ref(q, k, v))
    ms = time_ms(lambda: fa.flash_attention_bhsd(q, k, v))
    host_ms = eager_ms(lambda: fa.flash_attention_bhsd(q, k, v))
    plain_ms = time_ms(lambda: fa.flash_attention_ref(q, k, v))
    qh = q.reshape(n, kv * g, s, d)
    kh, vh = k.reshape(n, kv, s, d), v.reshape(n, kv, s, d)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = time_ms(lambda: sdpa(qh, kh, vh, is_causal=True,
                                  enable_gqa=True))
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())
    flops = 4 * n * kv * g * d * (s * (s + 1) // 2)
    bms, by = bound(nbytes, flops, torch.bfloat16)
    log(f"K2 timing bf16 causal n=8 H=32 KV=8 S=256 D=128: kernel {ms:.4f} "
        f"ms (eager back-to-back {host_ms:.4f} ms), plain {plain_ms:.4f} "
        f"ms, SDPA {lib_ms:.4f} ms, bound {bms:.5f} ms ({by})")
    report["flash_attention_bhsd"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=lib_ms)


def check_k3(report):
    from repro_torch.kernels import rmsnorm as rn
    gen = torch.Generator().manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        # ln1/ln2/final rows (decode and prefill) and q/k-norm head rows
        for n, d in ((8, 2560), (2048, 2560), (256, 128), (65536, 128)):
            x = (2 * torch.randn(n, d, generator=gen)).to(DEV, dtype)
            sc = (1 + 0.2 * torch.randn(d, generator=gen)).to(DEV)
            err = max_err(rn.rmsnorm_rows(x, sc, eps=1e-5),
                          rn.rmsnorm_ref(x, sc, eps=1e-5))
            log(f"K3 rmsnorm {str(dtype)[6:]:8s} N={n:5d} d={d:4d}: "
                f"max_abs_err {err:.3e}")
            assert err <= TOL[dtype], "K3 disagrees with its plain version"
    n, d = 2048, 2560
    x = (2 * torch.randn(n, d, generator=gen)).to(DEV, torch.bfloat16)
    sc = (1 + 0.2 * torch.randn(d, generator=gen)).to(DEV)
    err = max_err(rn.rmsnorm_rows(x, sc), rn.rmsnorm_ref(x, sc))
    ms = time_ms(lambda: rn.rmsnorm_rows(x, sc))
    host_ms = eager_ms(lambda: rn.rmsnorm_rows(x, sc))
    plain_ms = time_ms(lambda: rn.rmsnorm_ref(x, sc))
    sc16 = sc.to(torch.bfloat16)
    lib_ms = time_ms(lambda: torch.nn.functional.rms_norm(x, (d,), sc16,
                                                          1e-5))
    bms, by = bound(2 * x.numel() * 2 + 4 * d, 4 * n * d, torch.float32)
    log(f"K3 timing bf16 N=2048 d=2560: kernel {ms:.4f} ms (eager "
        f"back-to-back {host_ms:.4f} ms), plain "
        f"{plain_ms:.4f} ms, F.rms_norm {lib_ms:.4f} ms, bound {bms:.5f} ms "
        f"({by})")
    report["rmsnorm_rows"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, library_ms=lib_ms)


K4_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}   # elementwise rel


def check_k4(report):
    from repro_torch.kernels import softmax_xent as sx
    gen = torch.Generator().manual_seed(6)

    def check(x, y, g_nll, g_lse, vocab, what):
        """Forward (nll, lse to 1e-4 absolute; fp32 math on either dtype)
        and backward (each element to K4_BWD_TOL of its own size, the
        padded tail exactly 0) against the plain versions."""
        dtype = x.dtype
        nll, lse = sx.softmax_xent_fwd(x, y, vocab)
        rnll, rlse = sx.softmax_xent_ref(x, y, vocab)
        d = sx.softmax_xent_bwd(x, y, lse, g_nll, g_lse, vocab)
        rd = sx.softmax_xent_bwd_ref(x, y, lse, g_nll, g_lse, vocab)
        torch.cuda.synchronize()
        e_f = max(max_err(nll, rnll), max_err(lse, rlse))
        e_b, r_b = max_err(d, rd), elem_rel_err(d, rd)
        tail = float(d[:, vocab:].float().abs().sum())
        log(f"K4 softmax_xent {str(dtype)[6:]:8s} {what}: fwd max_abs_err "
            f"{e_f:.3e} (tol {TOL[torch.float32]}); bwd elementwise rel err "
            f"{r_b:.3e} (tol {K4_BWD_TOL[dtype]}), max_abs_err {e_b:.3e} "
            f"(|dlogits| in [{float(rd[:, :vocab].float().abs().min()):.2e}, "
            f"{float(rd.float().abs().max()):.2e}]), padded-tail grad {tail}")
        assert e_f <= TOL[torch.float32], "K4 fwd disagrees with plain"
        assert r_b <= K4_BWD_TOL[dtype] and tail == 0.0, \
            "K4 bwd disagrees with plain"
        return e_f, e_b, lse

    # the train path's rows (8 x 256 tokens, qwen3 vocab) and a padded
    # vocab, with O(1) upstream gradients so both the softmax term and the
    # label term of the backward are of a size that the check can see
    for dtype in (torch.float32, torch.bfloat16):
        for n, vp, vocab in ((2048, 151936, 151936), (64, 151936, 151000)):
            x = (2 * torch.randn(n, vp, generator=gen)).to(DEV, dtype)
            y = torch.randint(0, vocab, (n,), generator=gen).to(DEV)
            g_nll = torch.rand(n, generator=gen).to(DEV)
            g_lse = torch.rand(n, generator=gen).to(DEV)
            check(x, y, g_nll, g_lse, vocab, f"N={n:4d} Vp={vp} vocab={vocab}")
            del x
    # rows that do not start on 16-byte boundaries are refused, not read
    x = torch.zeros(4, 1001, device=DEV, dtype=torch.bfloat16)
    y = torch.zeros(4, device=DEV, dtype=torch.int32)
    for fn, args in ((sx.softmax_xent_fwd, (x, y, 999)),
                     (sx.softmax_xent_bwd, (x, y, y.float(), y.float(),
                                            y.float(), 999))):
        try:
            fn(*args)
        except ValueError as e:
            assert "16-byte" in str(e), e
        else:
            raise AssertionError(f"{fn.__name__} took a 1001-column pitch")
    log("K4 refuses a 1001-column bf16 pitch (not 16-byte aligned)")
    # timing at the train path's shape, bf16 logits, the train path's
    # upstream gradients (mean loss with z-loss 1e-4)
    n, vp = 2048, 151936
    x = (2 * torch.randn(n, vp, generator=gen)).to(DEV, torch.bfloat16)
    y = torch.randint(0, vp, (n,), generator=gen).to(DEV, torch.int32)
    g_nll = torch.full((n,), 1.0 / n, device=DEV)
    _, rlse = sx.softmax_xent_ref(x, y, vp)
    g_lse = 2e-4 * rlse / n
    err_f, err_b, lse = check(x, y, g_nll, g_lse, vp,
                              f"timed inputs N={n} Vp={vp}")
    ce = torch.nn.functional.cross_entropy
    fwd = dict(
        ms=time_ms(lambda: sx.softmax_xent_fwd(x, y, vp)),
        host_ms=eager_ms(lambda: sx.softmax_xent_fwd(x, y, vp)),
        plain_ms=time_ms(lambda: sx.softmax_xent_ref(x, y, vp)),
        library_ms=time_ms(lambda: ce(x.float(), y.long(),
                                      reduction="none")))
    bwd = dict(
        ms=time_ms(lambda: sx.softmax_xent_bwd(x, y, lse, g_nll, g_lse, vp)),
        host_ms=eager_ms(lambda: sx.softmax_xent_bwd(x, y, lse, g_nll, g_lse,
                                                     vp)),
        plain_ms=time_ms(lambda: sx.softmax_xent_bwd_ref(x, y, lse, g_nll,
                                                         g_lse, vp)))
    xf = x.float().requires_grad_()
    out = ce(xf, y.long(), reduction="none")
    bwd["library_ms"] = eager_ms(lambda: torch.autograd.grad(
        out, xf, g_nll, retain_graph=True), iters=20)
    del xf, out
    elems = n * vp
    fwd["bound_ms"], fwd["bound_by"] = bound(elems * 2 + n * 4 + 2 * n * 4,
                                             4 * elems, torch.float32)
    bwd["bound_ms"], bwd["bound_by"] = bound(2 * elems * 2 + 4 * n * 4,
                                             4 * elems, torch.float32)
    for name, r, err, lib in (("forward", fwd, err_f, "F.cross_entropy"),
                              ("backward", bwd, err_b,
                               "autograd of F.cross_entropy, eager")):
        log(f"K4 {name} timing bf16 N={n} Vp={vp}: kernel {r['ms']:.4f} ms "
            f"(eager back-to-back {r['host_ms']:.4f} ms), plain "
            f"{r['plain_ms']:.4f} ms, {lib} on fp32 {r['library_ms']:.4f} "
            f"ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
        r["max_abs_err"] = err
    report["softmax_xent_fwd"] = fwd
    report["softmax_xent_bwd"] = bwd


def check_k5(report):
    from repro_torch.kernels import adamw_update as aw
    gen = torch.Generator().manual_seed(7)
    hyper = dict(lr=3e-4, beta1=0.9, beta2=0.95, eps=1e-8, weight_decay=0.1,
                 bias_corr1=1 - 0.9 ** 3, bias_corr2=1 - 0.95 ** 3)
    scale = torch.tensor(0.5, device=DEV)

    def inputs(n, gdtype):
        g = torch.randn(n, generator=gen).to(DEV, gdtype)
        m = (0.1 * torch.randn(n, generator=gen)).to(DEV)
        v = (0.1 * torch.rand(n, generator=gen)).to(DEV)
        p = (0.02 * torch.randn(n, generator=gen)).to(DEV)
        return g, m, v, p

    # the tied embedding's size (151936 x 2560), a ragged size and the
    # smallest leaves (qk norms)
    emb = 151936 * 2560
    for gdtype in (torch.float32, torch.bfloat16):
        for n in (emb, 3 * 4096 + 7, 128):
            g, m, v, p = inputs(n, gdtype)
            km, kv, kp = m.clone(), v.clone(), p.clone()
            aw.adamw_fused(g, km, kv, kp, scale, **hyper)
            aw.adamw_ref(g, m, v, p, scale, **hyper)
            torch.cuda.synchronize()
            err = max(max_err(km, m), max_err(kv, v), max_err(kp, p))
            log(f"K5 adamw grad {str(gdtype)[6:]:8s} n={n:9d}: max_abs_err "
                f"{err:.3e} (tol 1e-6)")
            assert err <= 1e-6, "K5 disagrees with its plain version"
            if n == emb and gdtype == torch.float32:
                err_main = err                 # the timed case's inputs
            del g, m, v, p, km, kv, kp
    # timing at the embedding's size with fp32 gradients (the train path's)
    g, m, v, p = inputs(emb, torch.float32)
    ms = time_ms(lambda: aw.adamw_fused(g, m, v, p, scale, **hyper), iters=10)
    host_ms = eager_ms(lambda: aw.adamw_fused(g, m, v, p, scale, **hyper),
                       iters=10)
    plain_ms = time_ms(lambda: aw.adamw_ref(g, m, v, p, scale, **hyper),
                       iters=10)
    steps = [torch.tensor(3.0, device=DEV)]
    lib_ms = time_ms(lambda: torch._fused_adamw_(
        [p], [g], [m], [v], [], steps, lr=hyper["lr"], beta1=0.9, beta2=0.95,
        weight_decay=0.1, eps=1e-8, amsgrad=False, maximize=False,
        grad_scale=None, found_inf=None), iters=10)
    bms, by = bound(emb * 28, 15 * emb, torch.float32)
    log(f"K5 timing fp32 grads, n={emb} (tied embedding): kernel {ms:.4f} ms "
        f"(eager back-to-back {host_ms:.4f} ms), plain {plain_ms:.4f} ms, "
        f"torch._fused_adamw_ {lib_ms:.4f} ms, bound {bms:.5f} ms ({by})")
    report["adamw_fused"] = dict(
        max_abs_err=err_main, ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        library_ms=lib_ms)


# ------------------------------------------------------------- phase 4 ----

def model_check():
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import ForwardOpts, LM
    from repro_torch.serve.kvcache import PagedCache
    cfg = dataclasses.replace(get_config("qwen3-4b"), dtype="float32")
    lm = LM(cfg)
    t0 = time.perf_counter()
    params = lm.init(11, device=DEV)
    torch.cuda.synchronize()
    log(f"fp32 params: {sum(t.numel() for t in _leaves(params))/1e9:.3f} B "
        f"in {time.perf_counter()-t0:.1f}s")
    rng = np.random.default_rng(4)
    lens = [70, 97, 115, 128]                       # one bucket of 128
    n, bucket, steps = len(lens), 128, 16
    tokens = np.zeros((n, bucket), np.int64)
    for j, plen in enumerate(lens):
        tokens[j, :plen] = rng.integers(0, cfg.vocab_size, plen)
    paths = {"kernel": (ForwardOpts("flash", "kernel"), "kernel", "kernel"),
             "plain": (ForwardOpts("dense", "plain"), "gather", "plain")}
    caches, logits = {}, {}
    tok_dev = torch.as_tensor(tokens, device=DEV)
    last = torch.as_tensor(np.array(lens) - 1, device=DEV)
    for name, (opts, _, _) in paths.items():
        kv = PagedCache(cfg, n, 256, page_size=16, device=DEV,
                        dtype=torch.float32)
        dest = np.zeros((n, bucket), np.int32)
        for j, plen in enumerate(lens):
            assert kv.alloc(j, plen + steps) == 0
            dest[j] = kv.prefill_dest(j, bucket, plen)
        lg, cache = lm.forward(params, tok_dev, opts, collect_cache=True)
        kv.staged_write_prefill(cache["layers"],
                                torch.as_tensor(dest, device=DEV))
        caches[name] = kv
        logits[name] = [lg[torch.arange(n, device=DEV), last]]
        del lg, cache
    pos = np.array(lens, np.int32)
    nxt = logits["plain"][0].argmax(-1)
    for t in range(steps):
        for name, (_, decode_impl, norm_impl) in paths.items():
            lg, _ = lm.decode_step(params, nxt[:, None],
                                   caches[name].decode_view(),
                                   torch.as_tensor(pos + t, device=DEV),
                                   decode_impl=decode_impl,
                                   norm_impl=norm_impl)
            logits[name].append(lg[:, -1])
        nxt = logits["plain"][-1].argmax(-1)
    worst_rel, agree, checked = 0.0, 0, 0
    for a, b in zip(logits["kernel"], logits["plain"]):
        a, b = a[:, :cfg.vocab_size].float(), b[:, :cfg.vocab_size].float()
        assert a.shape == (n, cfg.vocab_size) and bool(torch.isfinite(a).all())
        rel = float((a - b).abs().max() / b.abs().max())
        worst_rel = max(worst_rel, rel)
        top2 = b.topk(2, dim=-1).values
        gap = top2[:, 0] - top2[:, 1]
        err_row = (a - b).abs().max(dim=-1).values
        decided = gap > err_row
        same = a.argmax(-1) == b.argmax(-1)
        assert bool((same | ~decided).all()), "greedy tokens disagree"
        agree += int(same.sum())
        checked += n
    log(f"fp32 kernel vs plain path: prefill + {steps} decode steps, logits "
        f"rel max err {worst_rel:.3e} (limit 1e-3), greedy agree "
        f"{agree}/{checked}")
    assert worst_rel <= 1e-3, "kernel path logits disagree with plain path"


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    else:
        for v in tree.values():
            yield from _leaves(v)


# ------------------------------------------------------------- phase 5 ----

def serve(report):
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.serve import Request, ServeEngine
    cfg = get_config("qwen3-4b")
    lm = LM(cfg)
    params = lm.init(7, device=DEV)
    rng = np.random.default_rng(5)
    shared = rng.integers(0, cfg.vocab_size, 64)

    def requests():
        out = []
        for i in range(16):
            plen = int(rng.integers(16, 201))
            prompt = rng.integers(0, cfg.vocab_size, plen)
            if i % 4 == 0:                    # 4 prompts share a prefix
                prompt = np.concatenate([shared, prompt[:max(plen - 64, 8)]])
            out.append(Request(i, prompt.astype(np.int32),
                               max_new_tokens=32))
        return out

    def engine():
        return ServeEngine(lm, params, max_batch=8, max_seq=512,
                           page_size=16, device=DEV)

    warm = engine()                           # cuBLAS and allocator warm-up
    for r in requests()[:2]:
        warm.submit(r)
    warm.run_until_drained()
    del warm
    eng = engine()
    decode_ms, prefill_ms = [], []

    def timed(fn, sink):
        def run(*a):
            t0 = time.perf_counter()
            out = fn(*a)
            torch.cuda.synchronize()
            sink.append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    eng._fused = timed(eng._fused, decode_ms)
    eng._prefill_group = timed(eng._prefill_group, prefill_ms)
    reqs = requests()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for r in reqs:
        eng.submit(r)
    done = eng.run_until_drained()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    reg = eng.reg
    iters = reg.counter("serve_iterations_total").get()
    decodes = reg.counter("serve_decode_dispatches_total").get()
    prefills = reg.counter("serve_prefill_dispatches_total").get()
    tokens = sum(len(r.out_tokens) for r in done)
    assert len(done) == 16 and all(r.status == "completed" and
                                   len(r.out_tokens) == 32 for r in done)
    assert all(0 <= t < cfg.vocab_size for r in done for t in r.out_tokens)
    assert decodes == iters, (decodes, iters)
    L = cfg.num_layers
    norms = L * (2 + 2 * cfg.qk_norm) + 1
    want = {name: 0 for name in launches}
    want.update(paged_flash_decode=decodes * L,
                flash_attention_bhsd=prefills * L,
                rmsnorm_rows=(decodes + prefills) * norms)
    log(f"launch counts {launches}, expected {want}")
    assert launches == want, "the main path did not run every kernel"
    ttft = reg.histogram("serve_ttft_seconds").quantile(0.5) * 1e3
    log(f"served 16 requests, {tokens} tokens in {wall:.3f}s: "
        f"{tokens / wall:.1f} tok/s, TTFT p50 {ttft:.1f} ms, "
        f"{iters:.0f} iterations, {prefills:.0f} prefill dispatches, mean "
        f"decode step {np.mean(decode_ms):.2f} ms, mean prefill dispatch "
        f"{np.mean(prefill_ms):.2f} ms, pages shared "
        f"{reg.gauge('serve_kv_pages_shared').get():.0f} at last admission, "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"[{nvidia_smi_line()}]")
    for name in ("paged_flash_decode", "flash_attention_bhsd",
                 "rmsnorm_rows"):
        report[name]["launches"] = launches[name]


# ------------------------------------------------------------- phase 6 ----

def rel_err(a, b) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def train_parity():
    import dataclasses
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.models import ForwardOpts, LM
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.optimizer import tree_leaves
    cfg = dataclasses.replace(get_config("qwen3-4b"), num_layers=2,
                              dtype="float32")
    lm = LM(cfg)
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=1, total_steps=10)
    rng = np.random.default_rng(8)
    batch = {k: rng.integers(0, cfg.vocab_size, (2, 128)).astype(np.int32)
             for k in ("tokens", "labels")}
    states, metrics = {}, {}
    for path in ("kernel", "plain"):
        opts = ForwardOpts(attn_impl="blockwise", norm_impl="plain",
                           q_chunk=128, kv_chunk=128, xent_impl=path)
        state = init_train_state(lm, 5, tcfg, device=DEV)
        step = make_train_step(lm, tcfg, opts, adamw_impl=path)
        metrics[path] = []
        for _ in range(2):
            state, m = step(state, batch)
            metrics[path].append({k: float(m[k])
                                  for k in ("loss", "grad_norm")})
        states[path] = state
    worst = 0.0
    for mk, mp in zip(metrics["kernel"], metrics["plain"]):
        for k in mk:
            worst = max(worst, abs(mk[k] - mp[k]) / abs(mp[k]))
    worst_m = worst
    for tree in ("params", "opt"):
        for a, b in zip(tree_leaves(states["kernel"][tree]),
                        tree_leaves(states["plain"][tree])):
            worst = max(worst, rel_err(a, b))
    log(f"fp32 2-layer full-width train, 2 steps, kernel path (K4, K5) vs "
        f"plain: losses {[m['loss'] for m in metrics['kernel']]} vs "
        f"{[m['loss'] for m in metrics['plain']]}, grad_norm "
        f"{[m['grad_norm'] for m in metrics['kernel']]}; loss/grad_norm rel "
        f"err {worst_m:.3e}, worst rel max err over loss, grad_norm, params, "
        f"m, v {worst:.3e} (limit 1e-3)")
    assert worst <= 1e-3, "kernel-path training disagrees with plain path"
    del states, state
    free()
    train_grads_bf16()


def train_grads_bf16():
    """The train path's own precision: fp32 parameters, bf16 compute.  The
    loss and every gradient leaf through K4 (bf16 logits in, bf16 dlogits
    out) against the plain loss that autograd differentiates, on the same
    parameters and batch; relative max error per leaf within the bf16
    tolerance 2e-2 (the dlogits of the two paths round to bf16 apart by at
    most one unit in some elements, and the bf16 matmuls that follow round
    again)."""
    import dataclasses
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.models import ForwardOpts, LM
    from repro_torch.core.checkpoint import _flatten_with_paths
    from repro_torch.train.optimizer import tree_leaves
    cfg = dataclasses.replace(get_config("qwen3-4b"), num_layers=2)
    assert cfg.dtype == "bfloat16" and cfg.param_dtype == "float32"
    lm = LM(cfg)
    z_loss = TrainConfig().z_loss
    rng = np.random.default_rng(9)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (8, 256)),
                                device=DEV, dtype=torch.int32)
             for k in ("tokens", "labels")}
    params = lm.init(5, device=DEV, dtype=torch.float32)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    losses, grads = {}, {}
    for path in ("kernel", "plain"):
        opts = ForwardOpts(attn_impl="blockwise", norm_impl="plain",
                           q_chunk=256, kv_chunk=256, xent_impl=path)
        loss, _ = lm.loss(params, batch, opts, z_loss=z_loss)
        grads[path] = torch.autograd.grad(loss, leaves)
        losses[path] = float(loss.detach())
    assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all())
               for g in grads["kernel"])
    loss_rel = abs(losses["kernel"] - losses["plain"]) / abs(losses["plain"])
    names = [name for name, _ in _flatten_with_paths(params)]
    worst, name = max((rel_err(a, b), n) for a, b, n in
                      zip(grads["kernel"], grads["plain"], names))
    log(f"bf16-compute 2-layer full-width loss and gradients, batch 8 x 256, "
        f"K4 vs plain loss: loss {losses['kernel']:.6f} vs "
        f"{losses['plain']:.6f} (rel {loss_rel:.3e}), worst rel max err over "
        f"{len(leaves)} gradient leaves {worst:.3e} ({name}; limit 2e-2)")
    assert loss_rel <= 1e-5, "bf16 kernel-path loss disagrees with plain"
    assert worst <= 2e-2, "bf16 kernel-path gradients disagree with plain"


# ------------------------------------------------------------- phase 7 ----

def train_run(report, steps: int = 10):
    import dataclasses
    import tempfile
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.core import FTTrainLoop
    from repro_torch.data import (DeterministicLoader, LoaderConfig,
                                  TokenDataset, synthetic_corpus,
                                  write_token_shards)
    from repro_torch.kernels import ops
    from repro_torch.models import ForwardOpts, LM
    from repro_torch.telemetry import MetricsRegistry
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.train.optimizer import tree_leaves
    cfg = dataclasses.replace(get_config("qwen3-4b"), num_layers=12)
    lm = LM(cfg)
    b, s, microbatches = 8, 256, 1
    tcfg = TrainConfig(learning_rate=3e-4, warmup_steps=2, total_steps=steps)
    opts = ForwardOpts(attn_impl="blockwise", norm_impl="plain", q_chunk=s,
                       kv_chunk=s)
    (ROOT / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        toks = synthetic_corpus(max(2_000_000, b * s * 20), cfg.vocab_size,
                                seed=0)
        write_token_shards(f"{tmp}/data", toks)
        loader = DeterministicLoader(TokenDataset(f"{tmp}/data"),
                                     LoaderConfig(b, s))
        batch = loader.batch_at(0)                 # one fixed batch
        reg = MetricsRegistry()
        # checkpoints every steps + 1: none of 25 GB is written here
        loop = FTTrainLoop(make_train_step(lm, tcfg, opts, microbatches),
                           lambda: init_train_state(lm, 0, tcfg, device=DEV),
                           f"{tmp}/ckpt", ckpt_every=steps + 1, registry=reg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated() / 2**30
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        final = loop.run(lambda step: batch, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    leaves = tree_leaves(final["params"])
    n_params = sum(t.numel() for t in leaves)
    want = {name: 0 for name in launches}
    want.update(softmax_xent_fwd=steps * microbatches,
                softmax_xent_bwd=steps * microbatches,
                adamw_fused=steps * len(leaves))
    loop_log = loop.metrics_log
    losses = [m["loss"] for m in loop_log]
    step_s = reg.histogram("train_step_seconds").recent(steps)
    steady = float(np.mean(step_s[2:]))
    flops = cfg.flops_per_token(s, "train") * b * s
    log(f"train losses {[round(x, 4) for x in losses]}, grad_norm "
        f"{[round(m['grad_norm'], 3) for m in loop.metrics_log]}")
    log(f"launch counts {launches}, expected {want}")
    assert len(losses) == steps and all(np.isfinite(losses)), "loss not finite"
    assert losses[-1] < losses[0], "loss did not fall on a fixed batch"
    assert launches == want, "the train path did not run K4 and K5 as counted"
    log(f"trained full-width qwen3-4b cut to {cfg.num_layers} layers "
        f"({n_params / 1e9:.3f} B fp32 parameters, bf16 compute), batch {b} "
        f"x seq {s}, {steps} steps in {wall:.3f}s: first step "
        f"{step_s[0] * 1e3:.1f} ms, mean step {steady * 1e3:.2f} ms over "
        f"steps 2..{steps - 1} ({b * s / steady:.1f} tok/s), peak memory "
        f"{peak:.2f} GiB ({before:.2f} GiB allocated before the run), MFU "
        f"{flops / steady / 989e12 * 100:.2f}% of 989 TFLOP/s "
        f"({flops / 1e12:.2f} TFLOP per step) [{nvidia_smi_line()}]")
    for name in ("softmax_xent_fwd", "softmax_xent_bwd", "adamw_fused"):
        report[name]["launches"] = launches[name]
    profile_step(loop.train_step, final, batch)
    del final, loop
    free()
    # the same run through the plain loss and plain AdamW, from the same
    # seed: does the kernel path's loss trajectory belong to the model?
    plain_step = make_train_step(
        lm, tcfg, dataclasses.replace(opts, xent_impl="plain"), microbatches,
        adamw_impl="plain")
    state = init_train_state(lm, 0, tcfg, device=DEV)
    plain = []
    for _ in range(steps):
        state, m = plain_step(state, batch)
        plain.append({k: float(m[k]) for k in ("loss", "grad_norm")})
    del state
    rel = {k: [abs(a[k] - b[k]) / abs(b[k])
               for a, b in zip(loop_log, plain)]
           for k in ("loss", "grad_norm")}
    log(f"plain-path replay (plain loss, plain AdamW, same seed and batch): "
        f"losses {[round(m['loss'], 4) for m in plain]}, grad_norm "
        f"{[round(m['grad_norm'], 3) for m in plain]}; kernel vs plain "
        f"worst rel err loss {max(rel['loss']):.3e} (limit 2e-2), grad_norm "
        f"{max(rel['grad_norm']):.3e}")
    assert max(rel["loss"]) <= 2e-2, \
        "the kernel path's loss trajectory leaves the plain path's"


KERNEL_GROUPS = (("K4 softmax_xent", ("softmax_xent",)),
                 ("K5 adamw", ("adamw_kernel",)),
                 ("matmul", ("gemm", "sm90_", "cutlass", "cublas", "xmma",
                             "nvjet")),
                 ("indexing", ("index", "scatter", "gather", "embedding")),
                 ("reductions", ("reduce", "Reduce")),
                 ("elementwise and copies", ("elementwise", "Elementwise",
                                             "copy", "Copy", "CatArray",
                                             "fill")))


def profile_step(train_step, state, batch) -> None:
    """Where the time of one more train step goes: device time by kernel
    group (torch.profiler, CUPTI), the device's busy and idle share of the
    step's wall time, and the largest kernels.  It runs after the counted
    run, on its final state; its launches are not counted."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, metrics = train_step(state, batch)
        float(metrics["loss"])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel rows only: an operator's row repeats its kernels' time
    rows = [(ev.key, ev.self_device_time_total / 1e3, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.self_device_time_total > 0]
    busy = sum(ms for _, ms, _ in rows)
    if not busy:
        log(f"profiled train step: wall {wall_ms:.2f} ms; the profiler "
            "recorded no device time (device breakdown not measured)")
        return
    log(f"profiled train step: wall {wall_ms:.2f} ms, device busy "
        f"{busy:.2f} ms, device idle share {1 - busy / wall_ms:.3f}")
    groups = {}
    for key, ms, _ in rows:
        group = next((g for g, subs in KERNEL_GROUPS
                      if any(x in key for x in subs)), "other")
        groups[group] = groups.get(group, 0.0) + ms
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"  {group:24s} {ms:9.3f} ms  {ms / busy * 100:5.1f}% of busy")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:10]:
        log(f"  {ms:9.3f} ms  x{count:<5d} {key[:100]}")


# ----------------------------------------------------------------- main ----

def free() -> None:
    """Drop what a finished phase left, so the next one has the card."""
    gc.collect()
    torch.cuda.empty_cache()


def triton_adamw_build() -> None:
    """Compile K5 for fp32 and bf16 gradients by launching it once on a
    small tensor (outside any counted path), and print what the compiler
    reports of it (registers, spills, shared memory), where this Triton
    version exposes it."""
    from repro_torch.kernels import adamw_update as aw
    triton, kernel = aw._kernel()
    for gdtype in (torch.float32, torch.bfloat16):
        z = torch.zeros(aw.BLOCK, device=DEV)
        compiled = kernel[(1,)](z.to(gdtype), z.clone(), z.clone(), z.clone(),
                                torch.ones((), device=DEV), aw.BLOCK,
                                1e-3, 0.9, 0.95, 1e-8, 0.1, 0.1, 0.05,
                                BLOCK=aw.BLOCK, num_warps=8)
        torch.cuda.synchronize()
        info = {k: getattr(compiled, k, None)
                for k in ("n_regs", "n_spills")}
        shared = getattr(getattr(compiled, "metadata", None), "shared", None)
        log(f"  adamw_kernel grad {str(gdtype)[6:]}: registers "
            f"{info['n_regs']}, spills {info['n_spills']}, shared {shared}")

def main() -> int:
    phase("1 card")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"nvidia-smi: {smi}")
    log(f"device: {kind}, count {torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}; TF32 off for matmul and cuDNN")

    phase("2 build")
    from repro_torch.kernels import _build, rmsnorm
    t0 = time.perf_counter()
    logs = _build.build()
    log(f"nvcc: {sorted(logs) or 'cached'} in {time.perf_counter()-t0:.1f}s")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "smem",
                                       "Compiling entry")):
                log(f"  {name}: {line.strip()}")
    t0 = time.perf_counter()
    for dtype in (torch.float32, torch.bfloat16):
        for d in (2560, 128):
            x = torch.ones(4, d, device=DEV, dtype=dtype)
            rmsnorm.rmsnorm_rows(x, torch.ones(d, device=DEV))
    torch.cuda.synchronize()
    log(f"triton rmsnorm compiled in {time.perf_counter()-t0:.1f}s")
    t0 = time.perf_counter()
    triton_adamw_build()
    log(f"triton adamw compiled in {time.perf_counter()-t0:.1f}s")

    phase("3 kernels against their plain versions")
    report = {}
    check_k1(report)
    check_k2(report)
    check_k3(report)
    check_k4(report)
    check_k5(report)
    free()

    phase("4 full-width qwen3-4b fp32: kernel path vs plain path")
    model_check()
    free()

    phase("5 serve full-width qwen3-4b bf16")
    serve(report)
    free()

    phase("6 training parity: 2-layer full-width qwen3-4b fp32, K4/K5 vs "
          "plain")
    train_parity()
    free()

    phase("7 train full-width qwen3-4b, 12 layers, bf16 compute")
    train_run(report)

    csrc = "src/repro_torch/csrc/"
    meta = {"paged_flash_decode": ("cuda", csrc + "paged_decode.cu",
                                   "src/repro/kernels/paged_decode.py:142"),
            "flash_attention_bhsd": ("cuda", csrc + "flash_attention.cu",
                                     "src/repro/kernels/"
                                     "flash_attention.py:60"),
            "rmsnorm_rows": ("triton", "src/repro_torch/kernels/rmsnorm.py",
                             "src/repro/kernels/rmsnorm.py:19"),
            "softmax_xent_fwd": ("cuda", csrc + "softmax_xent.cu",
                                 "src/repro/kernels/softmax_xent.py:32"),
            # the TPU kernel has no backward: JAX differentiates the loss
            "softmax_xent_bwd": ("cuda", csrc + "softmax_xent.cu",
                                 "src/repro/kernels/softmax_xent.py:32"),
            "adamw_fused": ("triton", "src/repro_torch/kernels/"
                            "adamw_update.py",
                            "src/repro/kernels/adamw_update.py:34")}
    kernels = []
    for name, (route, source, replaces) in meta.items():
        r = report[name]
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, "launches": r["launches"],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"],
                        "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
