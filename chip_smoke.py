#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Runs from the root of a checkout and needs one CUDA card; it fails (exit
code 1, no result line) without one.  Phases, each of which fails the run:

1. card: name, power limit, torch and CUDA versions; TF32 off for every
   fp32 comparison (``torch.backends.cuda.matmul.allow_tf32 = False``);
2. build: the CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a)
   and the Triton RMSNorm, with the ptxas register/shared/spill lines;
3. kernels against their plain versions on the card, bf16 and fp32, at the
   shapes the serve path gives them (fp32 1e-4, bf16 2e-2 absolute), and
   their times (CUDA events) beside the plain version, one PyTorch call as
   a yardstick, and the bound from shapes (3.35 TB/s; 989 TFLOP/s bf16,
   67 TFLOP/s fp32);
4. full-width qwen3-4b in fp32: one batched prefill and 16 decode steps
   through the kernels and through the plain path (dense prefill, gathered
   decode, plain RMSNorm); logits agree to a relative max error of 1e-3 and
   greedy tokens agree wherever the plain top-2 gap exceeds the error;
5. serve: full-width qwen3-4b in bf16 through ``ServeEngine`` (16 requests,
   prompts of 16-200 tokens, some sharing a prefix, 32 new tokens each,
   max_batch 8, max_seq 512, page 16); every request completes, one decode
   dispatch per iteration, and the kernel launch counts match the decode
   steps, prefill dispatches and norms of that run.

It then prints a ``kernels`` JSON line, the card's name and power limit,
and, last, ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

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
    want = {"paged_flash_decode": decodes * L,
            "flash_attention_bhsd": prefills * L,
            "rmsnorm_rows": (decodes + prefills) * norms}
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
    for name, count in launches.items():
        report[name]["launches"] = count


# ----------------------------------------------------------------- main ----

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

    phase("3 kernels against their plain versions")
    report = {}
    check_k1(report)
    check_k2(report)
    check_k3(report)

    phase("4 full-width qwen3-4b fp32: kernel path vs plain path")
    model_check()
    torch.cuda.empty_cache()

    phase("5 serve full-width qwen3-4b bf16")
    serve(report)

    meta = {"paged_flash_decode": ("cuda", "src/repro_torch/csrc/"
                                   "paged_decode.cu",
                                   "src/repro/kernels/paged_decode.py:142"),
            "flash_attention_bhsd": ("cuda", "src/repro_torch/csrc/"
                                     "flash_attention.cu",
                                     "src/repro/kernels/flash_attention.py:60"),
            "rmsnorm_rows": ("triton", "src/repro_torch/kernels/rmsnorm.py",
                             "src/repro/kernels/rmsnorm.py:19")}
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
