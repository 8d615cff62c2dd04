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
    python -m repro_torch.launch.serve --device cpu --reduced \
        --tenants chat=interactive,bulk=batch --quota bulk=8 \
        --fault-plan nan_logits@3,poison_page@5 --watchdog-iters 8
    python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.serve --device cpu --reduced --mesh 2
    python -m torch.distributed.run --nproc-per-node 4 \
        -m repro_torch.launch.serve --device cpu --reduced --mesh 2x2
    python -m repro_torch.launch.serve --device cpu --reduced --page-size 4 \
        --host-pages 64 --prefix-store --prefill-chunk 8
    python -m repro_torch.launch.serve --device cpu --reduced \
        --arch internvl2-2b
    python -m repro_torch.launch.serve --device cpu --reduced \
        --arch moonshot-v1-16b-a3b

It prints the same summary lines as ``repro.launch.serve``, and, as it
does, the alerts that fired: the engine runs the serve light checks and the
alert rules every 16 iterations (``--verify-cache`` adds the allocator's
invariant checks after every iteration).  ``--tenants``/``--quota``/
``--no-priority`` serve the requests round-robin over the tenants,
``--fault-plan``/``--watchdog-iters``/``--max-retries`` inject faults and
recover from them; a request out of retries is dead-lettered, and the
summary lists every request that did not simply complete.  ``--reduced``
(the default) serves the reduced config in fp32; ``--no-reduced`` serves the
full-width config in its own dtype, with random weights from seed 0.  The
requests are the JAX launcher's (``draw_requests``), which give a vlm
config (``--arch internvl2-2b``) no image, so its image rows are zeros, as
in JAX (``--max-seq`` must then exceed its 256 image rows at full width);
``--arch`` takes the dense, vlm and moe configs (the engine's
families; a moe config refuses ``--prefill-chunk``, as JAX's does).
``serve`` takes a
parameter tree, so the same run can serve other weights
(``repro_torch.models.params.from_jax``).

``--host-pages N`` puts an N-page host-RAM tier behind the pool: a shared
prefix page spills to pinned host memory when its last sharer frees it,
and a later admission that hits it copies it back instead of recomputing
it.  ``--prefix-store`` serves the workload once through a warm-up engine
and then again through a new engine on the same store, so the reported
pass admits against a warm tier; the summary adds a host-tier line.

``--mesh N`` splits the KV pool over N ranks (the 1-D form of the JAX
``--mesh N``); ``--mesh DxM`` (also ``D,M`` and ``dp=D,model=M``) runs a
2-D batch x pages mesh of D·M ranks: rank r sits at (r // M, r % M), the
pool is split over the M ranks of its row and replicated across the D rows,
whose replicas split each attention's batch rows.  One process per rank
under ``torch.distributed.run``, which sets ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``.  The backend is
``nccl`` with one card per rank where there are that many cards, else
``gloo`` (the CPU, or ranks sharing one card).  Rank 0 prints the summary.
With the host tier, every rank keeps its own copy of the store (host RAM
is the ranks' count times the tier).
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
from repro_torch.serve import (FaultPlan, PrefixStore, Request,
                               SamplingParams, ServeEngine, TenancyConfig)


def parse_mesh(spec: str):
    """``--mesh`` as the JAX launcher parses it: ``N`` -> (0, N), a 1-D
    split over N ranks; ``DxM``, ``D,M`` or ``dp=D,model=M`` -> (D, M), a
    2-D batch x pages mesh; ``0`` -> (0, 0), one process."""
    spec = spec.strip().lower()
    if "=" in spec:
        kv = dict(part.split("=", 1) for part in spec.split(","))
        unknown = set(kv) - {"dp", "model"}
        if unknown:
            raise SystemExit(f"--mesh: unknown axes {sorted(unknown)} "
                             "(expected dp=D,model=M)")
        return int(kv.get("dp", 1)), int(kv["model"])
    for sep in ("x", ","):
        if sep in spec:
            d, m = spec.split(sep, 1)
            return int(d), int(m)
    return 0, int(spec)


def join_pool_group(dp: int, m: int, device: str):
    """Join the ``torch.distributed`` group that ``torch.distributed.run``
    describes in the environment; returns (PoolGroup, dp group or ``None``,
    this rank's device).  A 2-D mesh (``dp`` > 0) of dp·m ranks puts rank r
    at (r // m, r % m): its model group (same row) splits the pool, its dp
    group (same column) the batch rows.  ``nccl`` with one card per rank
    when there are that many cards, else ``gloo``, every rank on card 0
    (or the CPU)."""
    env = os.environ
    n = dp * m if dp else m
    spec = f"{dp}x{m}" if dp else f"{m}"
    if not all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                  "MASTER_PORT")):
        raise SystemExit(f"--mesh {spec} runs one process per rank: launch "
                         f"it with python -m torch.distributed.run "
                         f"--nproc-per-node {n} -m repro_torch.launch.serve")
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    if world != n:
        raise SystemExit(f"--mesh {spec} but WORLD_SIZE is {world}")
    dev = resolve_device(device)
    backend = "gloo"
    if dev.type == "cuda" and torch.cuda.device_count() >= n:
        backend = "nccl"
        dev = torch.device("cuda", int(env.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
        rank=rank, world_size=world, timeout=timedelta(minutes=10))
    if not dp:
        return PoolGroup.of(), None, dev
    # every rank creates every group, in the same order
    rows = [dist.new_group([d * m + j for j in range(m)]) for d in range(dp)]
    cols = [dist.new_group([d * m + j for d in range(dp)]) for j in range(m)]
    return (PoolGroup(rows[rank // m], rank % m, m),
            PoolGroup(cols[rank % m], rank // m, dp), dev)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b",
                    choices=archs("dense", "vlm", "moe"))
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
    ap.add_argument("--mesh", default="0", metavar="N|DxM",
                    help="split the KV pool over N ranks (run under "
                         "python -m torch.distributed.run --nproc-per-node "
                         "N): each rank pins P/N pages and merges the "
                         "ranks' decode partials.  'DxM' / 'D,M' / "
                         "'dp=D,model=M': a 2-D batch x pages mesh of D*M "
                         "ranks, the pool split over M and replicated "
                         "across D replicas, which split each attention's "
                         "batch rows; 0 = one process")
    ap.add_argument("--tenants", default="", metavar="N=CLS,...",
                    help="multi-tenant serving: comma-separated name=class "
                         "tenants (classes: interactive, admitted first and "
                         "never preempted, and batch, the default); the "
                         "requests round-robin over the tenants.  Empty: "
                         "one FIFO tenant")
    ap.add_argument("--quota", default="", metavar="N=PAGES,...",
                    help="per-tenant KV page quotas (name=pages,...): a "
                         "tenant at its cap has its admissions skipped until "
                         "its slots free pages.  Needs --tenants and the "
                         "paged backend")
    ap.add_argument("--priority", dest="priority", action="store_true",
                    default=True,
                    help="preempt the lowest-priority running decode when a "
                         "higher class cannot admit (its pages evicted, the "
                         "request re-queued for a recompute-on-resume "
                         "prefill; default on)")
    ap.add_argument("--no-priority", dest="priority", action="store_false",
                    help="no preemption: quotas and priority-ordered "
                         "admission only")
    ap.add_argument("--fault-plan", default="", metavar="PLAN",
                    help="fault injection: comma-separated "
                         "kind@iteration[:slot=N][:chip=N][:page=N][:dur=N] "
                         "events (kinds: nan_logits, poison_page, "
                         "chip_failure, stall_chunk, dispatch_error), e.g. "
                         "'nan_logits@5,chip_failure@12:chip=1'; faulted "
                         "streams resume through a recompute-on-resume "
                         "prefill")
    ap.add_argument("--watchdog-iters", type=int, default=0, metavar="N",
                    help="recover any live slot that emits no token and "
                         "lands no chunk for N iterations (0: off)")
    ap.add_argument("--max-retries", type=int, default=3,
                    help="recoveries a stream may take before it is "
                         "dead-lettered (the error on the request, its "
                         "neighbours untouched)")
    ap.add_argument("--host-pages", type=int, default=0, metavar="N",
                    help="host-RAM page tier: a shared prefix page spills "
                         "to one of N pinned host page buffers when its "
                         "last device reference drops, and an admission "
                         "that hits the stored prefix copies the pages back "
                         "instead of recomputing them (with --prefill-chunk "
                         "the chunks they cover skip their forward).  Needs "
                         "the paged backend and prefix sharing; 0 = off")
    ap.add_argument("--prefix-store", action="store_true",
                    help="persistent prefix store: serve the workload "
                         "through a warm-up engine first, then through a "
                         "new engine on the same store, so the reported "
                         "pass admits against a warm host tier.  Needs "
                         "--host-pages")
    ap.add_argument("--verify-cache", action="store_true",
                    help="debug mode: run the PagedCache.verify() "
                         "invariant sanitizer (refcounts, free lists, page "
                         "tables, quotas) after every engine iteration")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.prefix_store and not args.host_pages:
        raise SystemExit("--prefix-store persists the host tier across "
                         "engines; size it with --host-pages N")
    dp, m = parse_mesh(args.mesh)
    pool_group, dp_group, device = None, None, args.device
    if m:
        pool_group, dp_group, device = join_pool_group(dp, m, args.device)
    try:
        serve(args, pool_group, device, dp_group=dp_group)
    finally:
        if pool_group is not None:
            dist.destroy_process_group()


def draw_requests(args, vocab_size: int,
                  tenants: List[str] = ()) -> List[Request]:
    """The JAX launcher's workload: ``default_rng(0)``, prompts of 4-11
    tokens, request i sampled with ``seed=i`` and, given ``tenants``, of
    tenant ``tenants[i % len(tenants)]``."""
    rng = np.random.default_rng(0)
    reqs = []
    for i in range(args.requests):
        prompt = rng.integers(0, vocab_size,
                              rng.integers(4, 12)).astype(np.int32)
        reqs.append(Request(i, prompt, max_new_tokens=args.new_tokens,
                            tenant=(tenants[i % len(tenants)] if tenants
                                    else "default"),
                            sampling=SamplingParams(
                                temperature=args.temperature,
                                top_k=args.top_k, top_p=args.top_p,
                                seed=i)))
    return reqs


def serve(args, pool_group, device, params=None, dp_group=None):
    """Serve ``draw_requests`` and print the summary (rank 0); ``params``
    defaults to random weights from seed 0.  With ``--prefix-store`` a
    warm-up engine serves the requests first on the same store.  Returns
    the engine."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    lm = LM(cfg)
    tenancy = None
    if args.tenants:
        tenancy = TenancyConfig.parse(args.tenants, args.quota,
                                      preemption=args.priority)
    elif args.quota:
        raise SystemExit("--quota requires --tenants")
    fault_plan = FaultPlan.parse(args.fault_plan) if args.fault_plan else None
    if params is None:
        params = lm.init(0, device=device)
    # the health loop: serve light checks and the alert rules every 16
    # iterations, as the JAX launcher wires them
    reg = MetricsRegistry()
    slack = SlackSink()
    alerts = AlertManager(reg, sinks=[slack, LogSink()],
                          rules=DEFAULT_RULES + SERVE_RULES)
    store = PrefixStore(args.host_pages) if args.host_pages else None

    def build_engine(registry, with_alerts=True):
        return ServeEngine(lm, params, args.max_batch, args.max_seq,
                           page_size=args.page_size, num_pages=args.num_pages,
                           prefix_sharing=not args.no_prefix_sharing,
                           device=device, kv_dtype=args.kv_dtype,
                           decode_impl=args.decode_impl,
                           pool_group=pool_group, dp_group=dp_group,
                           cache_backend=args.cache_backend,
                           prefill_chunk=args.prefill_chunk,
                           prefill_budget=args.prefill_budget,
                           registry=registry, tenancy=tenancy,
                           fault_plan=fault_plan,
                           watchdog_iters=args.watchdog_iters,
                           max_retries=args.max_retries,
                           verify_cache=args.verify_cache,
                           alerts=alerts if with_alerts else None,
                           prefix_store=store)

    tenant_names = sorted(tenancy.tenants) if tenancy else []
    rank0 = pool_group is None or (
        pool_group.rank == 0 and (dp_group is None or dp_group.rank == 0))
    if args.prefix_store:
        # the warm-up engine: same workload, its own registry, the SAME
        # store, whose pages outlive it
        warm = build_engine(MetricsRegistry(), with_alerts=False)
        t0 = time.perf_counter()
        for req in draw_requests(args, cfg.vocab_size, tenant_names):
            warm.submit(req)
        warm.run_until_drained(on_stuck="status")
        cold_ttft = warm.reg.histogram(
            "serve_ttft_seconds").quantile(0.5) * 1e3
        if rank0:
            print(f"warmup pass: {time.perf_counter()-t0:.1f}s, TTFT p50 "
                  f"{cold_ttft:.0f}ms, {store.pages_in_use()} prefix pages "
                  f"now host-resident; rebuilding engine on the warm store")
        del warm
    eng = build_engine(reg)
    t0 = time.perf_counter()
    for req in draw_requests(args, cfg.vocab_size, tenant_names):
        eng.submit(req)
    done = eng.run_until_drained(on_stuck="status")
    wall = time.perf_counter() - t0
    # every rank settles its offloads (a collective over a split pool)
    st = eng.kv.memory_stats()
    if not rank0:
        return eng
    total_tokens = sum(len(r.out_tokens) for r in done)
    iters = reg.counter("serve_iterations_total").get()
    decode = reg.counter("serve_decode_dispatches_total").get()
    prefill = reg.counter("serve_prefill_dispatches_total").get()
    by_status = {}
    for r in done:
        by_status[r.status] = by_status.get(r.status, 0) + 1
    outcome = ", ".join(f"{n} {s}" for s, n in sorted(by_status.items()))
    print(f"served {len(done)} requests ({outcome}), "
          f"{total_tokens} tokens in {wall:.1f}s "
          f"({total_tokens/wall:.1f} tok/s)")
    print(f"device calls: {decode:.0f} fused decode+sample "
          f"({decode/max(iters, 1):.2f}/iteration) + {prefill:.0f} prefill")
    ttft = reg.histogram("serve_ttft_seconds")
    print(f"TTFT p50 {ttft.quantile(0.5)*1e3:.0f}ms "
          f"p95 {ttft.quantile(0.95)*1e3:.0f}ms")
    print(f"latency p50 "
          f"{reg.histogram('serve_latency_seconds').quantile(0.5):.2f}s")
    deferred = reg.counter("serve_admission_deferred_total").get()
    pf_h = reg.histogram("serve_prefill_batch_size")
    sharded = ""
    if pool_group is not None:
        sharded = (f", sharded over {st.mesh_chips} ranks "
                   f"({st.bytes_per_chip/1e6:.2f} MB/rank + "
                   f"{st.bytes_sink_per_chip/1e6:.2f} MB sink page)")
        if dp_group is not None:
            sharded += f", replicated over {dp_group.size} dp replicas"
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
    if args.host_pages:
        hits = reg.counter("serve_prefix_store_hits_total").get()
        misses = reg.counter("serve_prefix_store_misses_total").get()
        off_b = reg.counter("serve_host_offload_bytes_total").get()
        pre_b = reg.counter("serve_host_prefetch_bytes_total").get()
        print(f"host tier [{args.host_pages} pages"
              + (", persistent store" if args.prefix_store else "")
              + f"]: {st.host_pages_in_use} resident "
              f"({st.host_bytes/1e6:.2f} MB host RAM), "
              f"{hits:.0f} page hits / {misses:.0f} misses, "
              f"{off_b/1e6:.2f} MB offloaded, {pre_b/1e6:.2f} MB "
              f"prefetched")
    if args.prefill_chunk:
        chunks = reg.counter("serve_prefill_chunks_total").get()
        stalls = reg.counter("serve_prefill_chunk_stalls_total").get()
        stall_it = reg.counter("serve_decode_stall_iters").get()
        skipped = reg.counter("serve_prefill_chunks_skipped_total").get()
        print(f"chunked prefill [{args.prefill_chunk} tok/chunk, budget "
              f"{eng.budget}]: {chunks:.0f} chunks, {stalls:.0f} page-grant "
              f"stalls, decode stall iters={stall_it:.0f}")
        print(f"  {skipped:.0f} fully-shared chunks skipped their forward")
    if tenancy is not None:
        preempt = reg.counter("serve_preemptions_total").get()
        qdeny = reg.counter("serve_quota_denied_total").get()
        print(f"tenancy [{len(tenancy.tenants)} tenants, preemption "
              f"{'on' if tenancy.preemption else 'off'}]: "
              f"{preempt:.0f} preemptions, {qdeny:.0f} quota denies")
        for name in tenant_names:
            spec = tenancy.spec(name)
            pages = reg.gauge("serve_tenant_pages_in_use").get(
                {"tenant": name})
            quota = (f"/{spec.page_quota}" if spec.page_quota is not None
                     else "")
            print(f"  tenant {name} [{spec.cls}]: pages {pages:.0f}{quota}")
        h = reg.histogram("serve_class_ttft_seconds")
        for cls in sorted({t.cls for t in tenancy.tenants.values()}):
            if h.count({"class": cls}):
                print(f"  class {cls}: TTFT p50 "
                      f"{h.quantile(0.5, {'class': cls})*1e3:.0f}ms p99 "
                      f"{h.quantile(0.99, {'class': cls})*1e3:.0f}ms")
    injected = sum(v for _, v in reg.counter(
        "serve_faults_injected_total").labels_values())
    recovered = sum(v for _, v in reg.counter(
        "serve_stream_retries_total").labels_values())
    dead = sum(v for _, v in reg.counter(
        "serve_dead_letter_total").labels_values())
    if args.fault_plan or args.watchdog_iters or injected or recovered:
        rec_h = reg.histogram("serve_recovery_iters")
        rec_p50 = (f", recovery p50 {rec_h.quantile(0.5):.0f} iters"
                   if rec_h.count() else "")
        print(f"faults: {injected:.0f} injected, {recovered:.0f} stream "
              f"retries, {dead:.0f} dead-lettered{rec_p50}")
    for r in sorted(done, key=lambda r: r.id):
        if r.status != "completed" or r.retries or r.preemptions:
            print(f"  request {r.id} [{r.status}]: {len(r.out_tokens)} "
                  f"tokens, {r.retries} retries, {r.preemptions} preemptions"
                  + (f" — {r.error}" if r.error else ""))
    if slack.messages:
        print("alerts fired:")
        for m in slack.messages:
            print(f"  {m}")
    return eng


if __name__ == "__main__":
    main()
