"""Batched serving entry point of the port: the continuous-batching engine
over the paged KV cache, on the card unless ``--device cpu``.

    python -m repro_torch.launch.serve --no-reduced          # full width
    python -m repro_torch.launch.serve --device cpu --reduced

It prints the same summary lines as ``repro.launch.serve``.  ``--reduced``
(the default) serves the reduced config in fp32; ``--no-reduced`` serves the
full-width config in its own dtype, with random weights from seed 0.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.configs import CONFIGS, get_config
from repro_torch.models import LM
from repro_torch.serve import Request, SamplingParams, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=sorted(CONFIGS))
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
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=None,
                    help="physical page pool size (default: dense-equivalent"
                         " capacity); smaller pools defer admissions")
    ap.add_argument("--no-prefix-sharing", action="store_true")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    lm = LM(cfg)
    params = lm.init(0, device=args.device)
    eng = ServeEngine(lm, params, args.max_batch, args.max_seq,
                      page_size=args.page_size, num_pages=args.num_pages,
                      prefix_sharing=not args.no_prefix_sharing,
                      device=args.device)
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              rng.integers(4, 12)).astype(np.int32)
        eng.submit(Request(i, prompt, max_new_tokens=args.new_tokens,
                           sampling=SamplingParams(
                               temperature=args.temperature,
                               top_k=args.top_k, top_p=args.top_p, seed=i)))
    done = eng.run_until_drained()
    wall = time.perf_counter() - t0
    reg = eng.reg
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
    print(f"kv cache [{st.backend}]: {st.bytes_total/1e6:.2f} MB pinned, "
          f"{st.pages_total} pages of {st.page_size}; admissions "
          f"deferred={deferred:.0f}; prefill batch p50="
          f"{pf_h.quantile(0.5):.0f}")
    transient = reg.gauge("serve_decode_transient_bytes").get()
    print(f"decode impl [kernel]: per-step KV read "
          f"transient {transient/1e3:.1f} kB/layer")


if __name__ == "__main__":
    main()
