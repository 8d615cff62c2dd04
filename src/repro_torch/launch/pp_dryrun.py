"""Pipeline-parallel multi-pod dry-run (the paper's PP dimension; the
counterpart of the JAX ``repro.launch.pp_dryrun``): the layers pipelined
over the mesh's ``pod`` axis (GPipe, point-to-point hops between stages,
``parallel.pipeline``), the batch rows of every microbatch split over the
rules' batch axes inside each stage, and the embedding and the vocab
projection run whole on every rank (``build_pp_forward``).

The command line runs rank 0's forward once on meta tensors over a fake
group of 512 ranks, a (pod=2, data=256) mesh, and records its cost as the
dry-run does (``launch.dryrun.measure``), the pipeline's hops counted as
``collective-permute``, with the serve-side KV projection of the leftover
memory:

    python -m repro_torch.launch.pp_dryrun --arch granite-20b-code
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import torch

from repro_torch.models import transformer as tfm
from repro_torch.parallel import collectives as coll
from repro_torch.parallel.pipeline import pipeline_forward
from repro_torch.parallel.sharding import batch_axes


def build_pp_forward(lm, cfg, mesh, rules, opts, n_microbatches: int):
    """Returns ``fwd(params, tokens) -> logits`` on this rank of ``mesh``
    (axes ``pod`` and the rules' batch axes).  ``params["layers"]`` holds
    this stage's contiguous slice of the stacked layers (num_layers /
    pod of them); the other leaves are whole.  ``tokens`` (B, S) is the
    global batch on every rank; every rank returns the whole (B, S, Vp)
    logits.  Each layer body runs under the checkpoint, as JAX's."""
    del lm
    n_stages = mesh.shape["pod"]
    if cfg.num_layers % n_stages:
        raise ValueError(f"{cfg.num_layers} layers do not split over "
                         f"{n_stages} stages")
    axes = tuple(a for a in batch_axes(mesh, rules) if a != "pod")
    dp = mesh.group(axes) if axes else None
    n_dp = mesh.axis_size(axes) if axes else 1

    def layer_fn(lp, h):
        h, _, _ = tfm._attn_layer(lp, cfg, h, opts, collect=False)
        return h

    body = tfm._remat(layer_fn, "full")

    def stage_fn(stage_params, x):
        h = x
        for i in range(_depth(stage_params)):
            h = body(tfm.layer_params({"layers": stage_params}, i), h)
        return h

    pipe = pipeline_forward(stage_fn, n_stages, "pod", mesh)

    def fwd(params, tokens):
        h = tfm.embed_inputs(params, cfg, tokens)
        b = h.shape[0]
        mb = b // n_microbatches
        if b % n_microbatches or mb % n_dp:
            raise ValueError(f"batch {b} does not split into "
                             f"{n_microbatches} microbatches over {n_dp} "
                             "data ranks")
        x_mb = h.reshape(n_microbatches, mb, *h.shape[1:])
        rows = mb // n_dp
        me = mesh.index(axes) if axes else 0
        out = pipe(params["layers"], x_mb[:, me * rows:(me + 1) * rows])
        out = coll.gather_from(out, 1, dp)
        return tfm.unembed(params, cfg, out.reshape(b, *h.shape[1:]),
                           opts.norm_impl)

    return fwd


def _depth(tree) -> int:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def _stage_params(params, stage: int, n_stages: int):
    """``params`` with the layers cut to ``stage``'s contiguous slice."""
    per = _depth(params["layers"]) // n_stages
    return dict(params, layers=tfm.layer_params(
        params, slice(stage * per, (stage + 1) * per)))


def serve_kv_projection(cfg, dtype=torch.bfloat16):
    """What the leftover device memory buys a serving replica of ``cfg``
    (the JAX record's ``serve_kv_projection``): dense rows against pages,
    and the per-step transients of the paged read and write paths, from
    ``serve.kvcache``'s byte functions alone (nothing is allocated).
    ``None`` for families without an attention cache to page."""
    if cfg.family not in ("dense", "vlm", "moe"):
        return None
    from repro_torch.serve.kvcache import (contiguous_kv_bytes,
                                           decode_transient_bytes,
                                           page_kv_bytes,
                                           prefill_transient_bytes)
    kv_b, kv_s, kv_page = 64, 8192, 16
    kv_m = kv_s // kv_page
    return {
        "batch": kv_b, "max_seq": kv_s, "page_size": kv_page,
        "contiguous_bytes": contiguous_kv_bytes(cfg, kv_b, kv_s, dtype),
        "bytes_per_page": page_kv_bytes(cfg, kv_page, dtype),
        "pages_in_dense_equiv": kv_b * kv_m,
        # one layer's transient of the paged read: the gathered view
        # against K1's page tiles
        "decode_transient_gather_bytes": decode_transient_bytes(
            cfg, kv_b, kv_m, kv_page, dtype, "gather"),
        "decode_transient_kernel_bytes": decode_transient_bytes(
            cfg, kv_b, kv_m, kv_page, dtype, "kernel"),
        # the sharded prefill write's staged block (a group of 4 chunks of
        # 512) against a replicated pool-sized temporary
        "prefill_transient_sharded_bytes": prefill_transient_bytes(
            cfg, 4, 512, dtype),
        "prefill_transient_replicated_pool_bytes":
            kv_b * kv_m * page_kv_bytes(cfg, kv_page, dtype),
    }


def main():
    from repro_torch.configs import get_config
    from pathlib import Path
    from repro_torch.launch.dryrun import OUT_DIR, init_fake_group, measure
    from repro_torch.models import LM, ForwardOpts
    from repro_torch.parallel.mesh import make_mesh
    from repro_torch.parallel.sharding import default_rules

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-20b-code")
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--out-dir", default=str(OUT_DIR),
                    help="where the record goes (default "
                    "experiments/dryrun_torch)")
    args = ap.parse_args()

    cfg = dataclasses.replace(get_config(args.arch), param_dtype="bfloat16")
    lm = LM(cfg)
    init_fake_group(512)
    mesh = make_mesh((2, 256), ("pod", "data"))   # PP across pods, DP inside
    rules = default_rules(mesh.axis_names)
    rules["batch"] = ("data",)       # pod axis is the pipeline, not DP
    opts = ForwardOpts(attn_impl="blockwise", q_chunk=1024, kv_chunk=1024,
                       remat="none")
    params = _stage_params(lm.abstract_params(), mesh.coords["pod"],
                           mesh.shape["pod"])
    b, s = 1024, 1024   # mb=256 divides data=256
    tokens = torch.empty((b, s), dtype=torch.int32, device="meta")
    fwd = build_pp_forward(lm, cfg, mesh, rules, opts, args.microbatches)
    t0 = time.time()
    with torch.no_grad():
        cost = measure(lambda: fwd(params, tokens), (params, tokens))
    dt = time.time() - t0
    coll_stats = cost["collectives"]
    kv_proj = serve_kv_projection(cfg)
    rec = {
        "arch": args.arch, "shape": f"pp_fwd_b{b}_s{s}",
        "mesh": "pod2x16x16_PP", "tag": "pp", "chips": 512, "ok": True,
        "dryrun_s": round(dt, 1),
        "collectives": coll_stats,
        "cost_analysis": cost["cost_analysis"],
        "memory_analysis": {k: cost["memory_analysis"][k] for k in
                            ("argument_size_in_bytes", "temp_size_in_bytes")},
        "serve_kv_projection": kv_proj,
    }
    out = Path(args.out_dir) / "pod2x16x16" / f"{args.arch}__pp_fwd.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rec, indent=1, default=str))
    cp = coll_stats["per_kind"].get("collective-permute",
                                    {"bytes": 0, "count": 0})
    print(f"[OK] PP dry-run {args.arch}: dryrun={dt:.1f}s "
          f"collective-permute hops={cp['count']} "
          f"({cp['bytes']/1e9:.2f} GB/dev) "
          f"total coll={coll_stats['total_bytes']/1e9:.2f} GB/dev")
    if kv_proj is not None:
        print(f"     serve KV projection (b{kv_proj['batch']} "
              f"s{kv_proj['max_seq']}): dense "
              f"{kv_proj['contiguous_bytes']/1e9:.2f} GB = "
              f"{kv_proj['pages_in_dense_equiv']} pages of "
              f"{kv_proj['page_size']} "
              f"({kv_proj['bytes_per_page']/1e6:.2f} MB/page)")
        print(f"     paged decode transient/step/layer: gather "
              f"{kv_proj['decode_transient_gather_bytes']/1e6:.1f} MB vs "
              f"kernel {kv_proj['decode_transient_kernel_bytes']/1e3:.1f} kB "
              f"(x{kv_proj['decode_transient_gather_bytes'] / max(kv_proj['decode_transient_kernel_bytes'], 1):.0f})")


if __name__ == "__main__":
    main()
