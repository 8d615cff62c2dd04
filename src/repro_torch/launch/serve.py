"""Batched serving entry point of the port: the continuous-batching engine
over the paged (or ``--cache-backend contiguous``) KV cache, on the card
unless ``--device cpu``.  On one card the engine replays one CUDA graph of
the fused decode step per iteration.

    python -m repro_torch.launch.serve --no-reduced          # full width
    python -m repro_torch.launch.serve --no-reduced --kv-dtype int8
    python -m repro_torch.launch.serve --no-reduced --cache-backend contiguous
    python -m repro_torch.launch.serve --no-reduced --prefill-chunk 64 \
        --prefill-budget 128
    python -m repro_torch.launch.serve --device cpu --reduced
    python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.serve --device cpu --reduced --mesh 2

It prints the same summary lines as ``repro.launch.serve``, and, as it
does, the alerts that fired: the engine runs the serve light checks and the
alert rules every 16 iterations (``--verify-cache`` adds the allocator's
invariant checks after every iteration).  ``--reduced``
(the default) serves the reduced config in fp32; ``--no-reduced`` serves the
full-width config in its own dtype, with random weights from seed 0.  The
requests are the JAX launcher's (``draw_requests``); ``serve`` takes a
parameter tree, so the same run can serve other weights
(``repro_torch.models.params.from_jax``).

``--mesh N`` splits the KV pool over N ranks (the 1-D form of the JAX
``--mesh N``), one process per rank under ``torch.distributed.run``, which
sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``.  The backend is ``nccl`` with one card per rank where
there are N cards, else ``gloo`` (the CPU, or ranks sharing one card).
Rank 0 prints the summary.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from datetime import timedelta
from typing import List

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import archs, get_config
from repro_torch.core.alerts import (DEFAULT_RULES, SERVE_RULES, AlertManager,
                                     LogSink, SlackSink)
from repro_torch.core.telemetry import MetricsRegistry
from repro_torch.models import LM
from repro_torch.models.common import resolve_device
from repro_torch.parallel import PoolGroup
from repro_torch.serve import Request, SamplingParams, ServeEngine


def parse_mesh(spec: str) -> int:
    """``--mesh``: ``N`` ranks for a 1-D pool split (``0``: one process, no
    split).  The JAX launcher's 2-D forms (``DxM``, ``D,M``,
    ``dp=D,model=M``) are not ported."""
    spec = spec.strip().lower()
    if any(sep in spec for sep in ("x", ",", "=")):
        raise NotImplementedError(
            f"--mesh {spec}: 2-D batch x pages meshes (dp_axis) are not "
            "ported; ROADMAP Queue 1 item 14 lists them as open")
    return int(spec)


def join_pool_group(n: int, device: str):
    """Join the ``torch.distributed`` group that ``torch.distributed.run``
    describes in the environment; returns (PoolGroup, this rank's device).
    ``nccl`` with one card per rank when there are ``n`` cards, else
    ``gloo``, every rank on card 0 (or the CPU)."""
    env = os.environ
    if not all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                  "MASTER_PORT")):
        raise SystemExit(f"--mesh {n} runs one process per rank: launch it "
                         f"with python -m torch.distributed.run "
                         f"--nproc-per-node {n} -m repro_torch.launch.serve")
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    if world != n:
        raise SystemExit(f"--mesh {n} but WORLD_SIZE is {world}")
    dev = resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda" and torch.cuda.device_count() >= n:
        backend = "nccl"
        dev = torch.device("cuda", int(env.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
        rank=rank, world_size=world, timeout=timedelta(minutes=10))
    return PoolGroup.of(), dev


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=archs("dense"))
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="reduced fp32 config (default) or, with "
                         "--no-reduced, the full-width config")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the run fails if CUDA is asked for "
                         "and absent")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 => greedy")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--cache-backend", default="paged",
                    choices=["paged", "contiguous"],
                    help="'paged' (page pool, prefix sharing, admission "
                         "control) or 'contiguous' (max_seq dense rows a "
                         "slot); --kv-dtype int8 and --mesh need paged")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=None,
                    help="physical page pool size (default: dense-equivalent"
                         " capacity); smaller pools defer admissions")
    ap.add_argument("--no-prefix-sharing", action="store_true")
    ap.add_argument("--kv-dtype", default="native",
                    choices=["native", "int8"],
                    help="page-pool storage format: 'native' (the model "
                         "dtype) or 'int8' (int8 rows with per-row fp32 "
                         "scales, quantized on write, dequantized on read)")
    ap.add_argument("--decode-impl", default="kernel",
                    choices=["kernel", "gather"],
                    help="paged decode read path: 'kernel' (K1, walks the "
                         "page table) or 'gather' (dense gathered view)")
    ap.add_argument("--prefill-chunk", type=int, default=0, metavar="C",
                    help="chunked prefill: admitted prompts land in C-token "
                         "chunks interleaved with the decode steps, claiming "
                         "pages chunk by chunk; 0 = whole-prompt prefill.  "
                         "Needs --cache-backend paged")
    ap.add_argument("--prefill-budget", type=int, default=0, metavar="T",
                    help="max prefill tokens per engine iteration (>= one "
                         "chunk; default: one chunk), the bound on how long "
                         "a decode iteration waits on prefill")
    ap.add_argument("--mesh", default="0", metavar="N",
                    help="split the KV pool over N ranks (run under "
                         "python -m torch.distributed.run --nproc-per-node "
                         "N): each rank pins P/N pages and merges the "
                         "ranks' decode partials; 0 = one process")
    ap.add_argument("--verify-cache", action="store_true",
                    help="debug mode: run the PagedCache.verify() "
                         "invariant sanitizer (refcounts, free lists, page "
                         "tables) after every engine iteration")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    n = parse_mesh(args.mesh)
    pool_group, device = None, args.device
    if n:
        pool_group, device = join_pool_group(n, args.device)
    try:
        serve(args, pool_group, device)
    finally:
        if pool_group is not None:
            dist.destroy_process_group()


def draw_requests(args, vocab_size: int) -> List[Request]:
    """The JAX launcher's workload: ``default_rng(0)``, prompts of 4-11
    tokens, request i sampled with ``seed=i``."""
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        prompt = rng.integers(0, vocab_size,
                              rng.integers(4, 12)).astype(np.int32)
        reqs.append(Request(i, prompt, max_new_tokens=args.new_tokens,
                            sampling=SamplingParams(
                                temperature=args.temperature,
                                top_k=args.top_k, top_p=args.top_p,
                                seed=i)))
    return reqs


def serve(args, pool_group, device, params=None):
    """Serve ``draw_requests`` and print the summary (rank 0); ``params``
    defaults to random weights from seed 0.  Returns the engine."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    lm = LM(cfg)
    if params is None:
        params = lm.init(0, device=device)
    # the health loop: serve light checks and the alert rules every 16
    # iterations, as the JAX launcher wires them
    reg = MetricsRegistry()
    slack = SlackSink()
    alerts = AlertManager(reg, sinks=[slack, LogSink()],
                          rules=DEFAULT_RULES + SERVE_RULES)
    eng = ServeEngine(lm, params, args.max_batch, args.max_seq,
                      page_size=args.page_size, num_pages=args.num_pages,
                      prefix_sharing=not args.no_prefix_sharing,
                      device=device, kv_dtype=args.kv_dtype,
                      decode_impl=args.decode_impl, pool_group=pool_group,
                      cache_backend=args.cache_backend,
                      prefill_chunk=args.prefill_chunk,
                      prefill_budget=args.prefill_budget, registry=reg,
                      verify_cache=args.verify_cache, alerts=alerts)
    t0 = time.perf_counter()
    for req in draw_requests(args, cfg.vocab_size):
        eng.submit(req)
    done = eng.run_until_drained()
    wall = time.perf_counter() - t0
    if pool_group is not None and pool_group.rank != 0:
        return eng
    total_tokens = sum(len(r.out_tokens) for r in done)
    iters = reg.counter("serve_iterations_total").get()
    decode = reg.counter("serve_decode_dispatches_total").get()
    prefill = reg.counter("serve_prefill_dispatches_total").get()
    print(f"served {len(done)} requests ({len(done)} completed), "
          f"{total_tokens} tokens in {wall:.1f}s "
          f"({total_tokens/wall:.1f} tok/s)")
    print(f"device calls: {decode:.0f} fused decode+sample "
          f"({decode/max(iters, 1):.2f}/iteration) + {prefill:.0f} prefill")
    ttft = reg.histogram("serve_ttft_seconds")
    print(f"TTFT p50 {ttft.quantile(0.5)*1e3:.0f}ms "
          f"p95 {ttft.quantile(0.95)*1e3:.0f}ms")
    print(f"latency p50 "
          f"{reg.histogram('serve_latency_seconds').quantile(0.5):.2f}s")
    st = eng.kv.memory_stats()
    deferred = reg.counter("serve_admission_deferred_total").get()
    pf_h = reg.histogram("serve_prefill_batch_size")
    sharded = ""
    if pool_group is not None:
        sharded = (f", sharded over {st.mesh_chips} ranks "
                   f"({st.bytes_per_chip/1e6:.2f} MB/rank + "
                   f"{st.bytes_sink_per_chip/1e6:.2f} MB sink page)")
    paged = st.backend == "paged"
    print(f"kv cache [{st.backend}]: {st.bytes_total/1e6:.2f} MB pinned"
          + (f", {st.pages_total} pages of {st.page_size}" if paged else "")
          + f"{sharded}; admissions deferred={deferred:.0f}; prefill batch "
          f"p50={pf_h.quantile(0.5):.0f}")
    if paged:
        transient = reg.gauge("serve_decode_transient_bytes").get()
        print(f"decode impl [{eng.decode_impl}]: per-step KV read "
              f"transient {transient/1e3:.1f} kB/layer")
    if st.kv_dtype == "int8":
        saved = reg.gauge("serve_kv_quant_bytes_saved").get()
        dense = str(eng.kv.dtype).removeprefix("torch.")
        per_rank = (f" ({st.bytes_scales_per_chip/1e3:.1f} kB/rank)"
                    if pool_group is not None else "")
        print(f"kv quant [int8]: {st.bytes_scales/1e3:.1f} kB scales"
              f"{per_rank}, "
              f"{saved/1e6:.2f} MB saved vs {dense} pages "
              f"({(st.bytes_total + saved)/max(st.bytes_total, 1):.2f}x "
              f"positions per byte)")
    if args.prefill_chunk:
        chunks = reg.counter("serve_prefill_chunks_total").get()
        stalls = reg.counter("serve_prefill_chunk_stalls_total").get()
        stall_it = reg.counter("serve_decode_stall_iters").get()
        skipped = reg.counter("serve_prefill_chunks_skipped_total").get()
        print(f"chunked prefill [{args.prefill_chunk} tok/chunk, budget "
              f"{eng.budget}]: {chunks:.0f} chunks, {stalls:.0f} page-grant "
              f"stalls, decode stall iters={stall_it:.0f}")
        print(f"  {skipped:.0f} fully-shared chunks skipped their forward")
    if slack.messages:
        print("alerts fired:")
        for m in slack.messages:
            print(f"  {m}")
    return eng


if __name__ == "__main__":
    main()
