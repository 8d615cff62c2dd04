"""Multi-pod dry-run of the port: every (arch × shape × mesh) cell's real
step, run once on meta tensors as rank 0 of the production mesh, over a
fake process group of 256 (``pod16x16``) or 512 (``pod2x16x16``) ranks.
No tensor is allocated on any device.  Each cell's record holds this
rank's FLOPs and bytes accessed (aten ops plus the hand-written kernels'
work, ``roofline.kernels``), its collectives (``roofline.collectives``),
its memory (this rank's arguments and the step's peak of live bytes) and
its aten op counts, in ``experiments/dryrun_torch/<mesh>/``.

The counterpart of the JAX ``repro.launch.dryrun``, which lowers and
compiles each cell with XLA and reads the compiled module's analyses.
XLA's cost analysis counts a scanned layer body once, so the JAX module
calibrates with two unrolled compiles (``_extrapolate``); the port runs
every layer eagerly and counts each op as it runs, so its counts are
exact at full depth and nothing is extrapolated.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-405b --shape train_4k --multi-pod
  python -m repro_torch.launch.dryrun --all              # every applicable cell
  python -m repro_torch.launch.dryrun --all --mesh both  # single- and multi-pod

The fake group (``init_fake_group``) is torch's private
``torch.testing._internal.distributed.fake_pg``; it takes the default
process group, so a dry-run runs in a process of its own.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import time
import traceback
import weakref
from pathlib import Path
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import (ASSIGNED_ARCHS, SHAPES, TrainConfig,
                                 applicable, get_config, get_shape)
from repro_torch.models import LM, ForwardOpts, input_specs
from repro_torch.parallel.collectives import CollectiveCounter
from repro_torch.parallel.mesh import make_production_mesh
from repro_torch.parallel.sharding import (batch_rows, default_rules,
                                           logical_to_sharding, shard_tree,
                                           sharding_context)
from repro_torch.roofline import kernels as kernel_work
from repro_torch.roofline.collectives import (count_op_flavors,
                                              parse_collectives)
from repro_torch.train import (TRAIN_OPTS, abstract_train_state,
                               make_train_step, shard_train_state)

OUT_DIR = (Path(__file__).resolve().parents[3] / "experiments"
           / "dryrun_torch")


def init_fake_group(world_size: int, rank: int = 0) -> None:
    """Make the default process group a fake one of ``world_size`` ranks,
    this process ``rank`` (torch's private test backend: collectives return
    at once, with their outputs' shapes).  The one place this module touches
    that private API."""
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) == (world_size, rank):
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def _mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def _forward_opts(cfg, shape, overrides=None) -> ForwardOpts:
    """JAX's dry-run opts: blockwise attention, its chunk rule, selective
    remat.  A train cell keeps the train step's plain norms and mixers
    (K3, K6 and K7 have no backward) and K4; prefill and decode cells the
    port's kernels (K3, K6, K7)."""
    qc = kv = 1024 if shape.seq_len >= 4096 else min(shape.seq_len, 512)
    base = TRAIN_OPTS if shape.kind == "train" else ForwardOpts()
    return dataclasses.replace(base, attn_impl="blockwise", q_chunk=qc,
                               kv_chunk=kv, remat="selective",
                               **(overrides or {}))


# ------------------------------------------------------------- measuring --

aten = torch.ops.aten
_FREE = {aten.empty.memory_format, aten.empty_strided.default,
         aten.empty_like.default, aten.new_empty.default,
         aten.new_empty_strided.default, aten.lift_fresh.default}
#: in-place ops that write their destination without reading it
_WRITE_ONLY = {aten.copy_, aten.fill_, aten.zero_}
#: indexed writes: of their destination only the rows named are written
_INDEXED_WRITES = {aten.index_put_, aten._index_put_impl_}


@functools.lru_cache(maxsize=None)
def _is_view(func) -> bool:
    """Whether every output of ``func`` aliases an input, read-only."""
    returns = func._schema.returns
    return bool(returns) and all(
        r.alias_info is not None and not r.alias_info.is_write
        for r in returns)


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _indexed_bytes(dst, indices) -> int:
    """The bytes of ``dst[indices]``: the elements an indexed write puts
    (a boolean mask counts every element it covers, since a meta mask
    holds no value)."""
    picked, kept, dim = 1, 1, 0
    ints = []
    for i in indices:
        if i is None:
            kept *= dst.shape[dim]
            dim += 1
        elif i.dtype == torch.bool:
            picked *= i.numel()
            dim += i.dim()
        else:
            ints.append(i.shape)
            dim += 1
    for d in dst.shape[dim:]:
        kept *= d
    if ints:
        picked *= math.prod(torch.broadcast_shapes(*ints))
    return picked * kept * dst.element_size()


def _op_bytes(func, args, kwargs, out) -> int:
    """The bytes one eager op moves: every tensor it reads, once, and every
    tensor it writes, once.  A destination the op writes in place is read
    too, except by a write-only op (a copy or a fill, and an ``out=``
    argument); an indexed write moves only the rows it names (and reads
    them when it accumulates); an output that is a written argument is not
    counted again."""
    schema = func._schema
    vals = [args[i] if i < len(args) else kwargs.get(a.name, a.default_value)
            for i, a in enumerate(schema.arguments)]
    n = 0
    for a, v in zip(schema.arguments, vals):
        size = sum(_nbytes(t) for t in _tensors(v))
        if a.alias_info is None or not a.alias_info.is_write:
            n += size
        elif func.overloadpacket in _INDEXED_WRITES:
            # (self, indices, values, accumulate, ...)
            n += _indexed_bytes(v, vals[1]) * (2 if vals[3] else 1)
        elif func.overloadpacket in _WRITE_ONLY or a.kwarg_only:
            n += size
        else:
            n += 2 * size
    outs = out if isinstance(out, (list, tuple)) else (out,)
    for r, o in zip(schema.returns, outs):
        if r.alias_info is None or not r.alias_info.is_write:
            n += sum(_nbytes(t) for t in _tensors(o))
    return n


class StepCost(TorchDispatchMode):
    """The cost of the aten ops that run while it is active: their FLOPs
    by the dtype of their first tensor input (``flop_registry``, the
    counts of ``FlopCounterMode``), their bytes (``_op_bytes``; views,
    metadata and allocation ops move none; collectives are
    ``CollectiveCounter``'s), their names, and the peak of the bytes of the
    storages they create that are alive at once (a storage shared by views
    counts once; ``arguments`` are the step's inputs, which are not
    counted there)."""

    def __init__(self, arguments=()):
        super().__init__()
        self.flops_by_dtype: Dict[str, int] = {}
        self.bytes = 0
        self.ops = []
        self.live = self.peak = 0
        self._known = {}
        for t in _tensors(arguments):
            self._known[t.untyped_storage()._cdata] = None

    def _freed(self, key, n):
        self._known.pop(key, None)
        self.live -= n

    def _track(self, out):
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._known:
                continue
            n = st.nbytes()
            self._known[key] = weakref.finalize(st, self._freed, key, n)
            self.live += n
            self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace in ("_c10d_functional", "c10d"):
            return out
        self.ops.append(str(func.overloadpacket))
        if func not in _FREE and not _is_view(func):
            self.bytes += _op_bytes(func, args, kwargs, out)
        fc = flop_registry.get(func.overloadpacket)
        if fc is not None:
            first = next(_tensors(args), None)
            dt = str(first.dtype).replace("torch.", "") if first is not None \
                else "float32"
            dt = "bfloat16" if dt in ("bfloat16", "float16") else "float32"
            self.flops_by_dtype[dt] = (self.flops_by_dtype.get(dt, 0)
                                       + fc(*args, **kwargs, out_val=out))
        self._track(out)
        return out

    def __exit__(self, *exc):
        for fin in self._known.values():
            if fin is not None:
                fin.detach()
        return super().__exit__(*exc)


def measure(fn, arguments) -> Dict:
    """Run ``fn()`` once under the counters; returns the record's
    ``cost_analysis``, ``collectives``, ``memory_analysis``, ``op_counts``
    and ``kernels`` (each hand-written kernel's launches, bytes and
    FLOPs)."""
    args_bytes = sum(st.nbytes() for st in {
        t.untyped_storage()._cdata: t.untyped_storage()
        for t in _tensors(arguments)}.values())
    cc = CollectiveCounter()
    with kernel_work.WorkCounter() as kw, cc, StepCost(arguments) as cost:
        fn()
        peak = cost.peak
    aten_flops = sum(cost.flops_by_dtype.values())
    by_dtype = dict(cost.flops_by_dtype)
    for dt, n in kw.flops_by_dtype().items():
        by_dtype[dt] = by_dtype.get(dt, 0) + n
    flavors = count_op_flavors(cost.ops)
    return {
        "cost_analysis": {
            "flops": float(aten_flops + kw.total_flops),
            "bytes accessed": float(cost.bytes + kw.total_bytes),
            "aten_flops": float(aten_flops),
            "kernel_flops": float(kw.total_flops),
            "flops_by_dtype": {k: float(v) for k, v in by_dtype.items()}},
        "kernels": kw.summary(),
        "collectives": parse_collectives(cc.records),
        "collective_calls": dict(cc.calls),
        "memory_analysis": {"argument_size_in_bytes": args_bytes,
                            "peak_size_in_bytes": args_bytes + peak,
                            "temp_size_in_bytes": peak},
        "op_counts": {k: v for k, v in sorted(
            flavors.items(), key=lambda kv: -kv[1])[:20]},
    }


def dryrun_step(lm: LM, kind: str, batch, mesh, rules, opts: ForwardOpts,
                tcfg: Optional[TrainConfig] = None, microbatches: int = 1,
                params=None) -> Dict:
    """The cost of one ``kind`` step (train, prefill or decode) of ``lm``
    on this rank of ``mesh`` under ``rules``, run on meta tensors:
    ``make_train_step`` on the shards of ``abstract_train_state`` (its step
    a host int 0, as ``init_train_state`` keeps it); ``LM.prefill`` or
    ``LM.decode_step`` on the shards of ``params`` (default
    ``lm.abstract_params()``).  ``batch`` is the global batch of
    ``input_specs`` (decode: its tokens, raw cache and ``cache_index``,
    every sequence at that position), or any batch of meta tensors.  A
    mesh of one position runs the single-rank step, outside any sharding
    context.  Returns ``measure``'s dict."""
    one = mesh is None or mesh.size == 1
    ctx = contextlib.nullcontext() if one else sharding_context(mesh, rules)

    def shards(tree):
        return tree if one else shard_tree(tree, logical_to_sharding(
            lm.param_logical_axes(), tree, mesh, rules), mesh)

    if kind == "train":
        state = abstract_train_state(lm)
        if not one:
            state = shard_train_state(state, lm, mesh, rules)
        state["step"] = 0
        step = make_train_step(lm, tcfg or TrainConfig(), opts,
                               microbatches=microbatches)
        with ctx:
            return measure(lambda: step(state, batch),
                           (state, _rows(batch, mesh, rules, one)))
    params = shards(params if params is not None else lm.abstract_params())
    if kind == "prefill":
        with ctx, torch.no_grad():
            return measure(lambda: lm.prefill(
                params, batch["tokens"], opts,
                img_embeds=batch.get("img_embeds"),
                enc_embeds=batch.get("enc_embeds")),
                (params, _rows(batch, mesh, rules, one)))
    if kind == "decode":
        cache = batch["cache"] if one else lm.shard_cache(batch["cache"],
                                                          mesh, rules)
        b = batch["tokens"].shape[0]
        positions = batch["cache_index"].expand(b)
        mine = _rows({"tokens": batch["tokens"]}, mesh, rules, one)
        with ctx, torch.no_grad():
            return measure(lambda: lm.decode_step(
                params, batch["tokens"], cache, positions,
                norm_impl=opts.norm_impl),
                (params, cache, mine, batch["cache_index"]))
    raise ValueError(kind)


def _rows(batch, mesh, rules, one: bool):
    """This rank's rows of a global batch (its share of the arguments)."""
    if one:
        return batch
    return {k: v[batch_rows(mesh, rules, v.shape[0])]
            for k, v in batch.items()}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             opt_overrides=None, rule_overrides=None, tag: str = "baseline",
             save: bool = True, microbatches: int = 1,
             out_dir: Path = OUT_DIR) -> Dict:
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    mesh_name = _mesh_name(multi_pod)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name, "tag": tag,
           "chips": 512 if multi_pod else 256,
           "tokens_per_step": shape.tokens_per_step}
    if not applicable(cfg, shape):
        rec["skipped"] = ("long_500k needs sub-quadratic attention state; "
                          f"{cfg.family} arch is full-attention (DESIGN.md §4)")
        return _save(rec, save, out_dir)

    cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    opts = _forward_opts(cfg, shape, opt_overrides)
    rec["opts"] = dataclasses.asdict(opts)
    t0 = time.time()
    try:
        init_fake_group(rec["chips"])
        mesh = make_production_mesh(multi_pod=multi_pod)
        rules = default_rules(mesh.axis_names,
                              seq_sharded_cache=(shape.name == "long_500k"))
        rules.update(rule_overrides or {})
        lm = LM(cfg)
        rec.update(dryrun_step(lm, shape.kind, input_specs(cfg, shape), mesh,
                               rules, opts, microbatches=microbatches))
        rec["model_flops_global"] = (cfg.flops_per_token(shape.seq_len,
                                                         shape.kind)
                                     * shape.tokens_per_step)
        rec["n_params"] = cfg.param_count()
        rec["n_active_params"] = cfg.active_param_count()
        rec["ok"] = True
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec["ok"] = False
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["dryrun_s"] = round(time.time() - t0, 2)
    return _save(rec, save, out_dir)


def _save(rec, save: bool, out_dir: Path = OUT_DIR):
    if save:
        d = Path(out_dir) / rec["mesh"]
        d.mkdir(parents=True, exist_ok=True)
        suffix = "" if rec.get("tag", "baseline") == "baseline" else \
            f"__{rec['tag']}"
        path = d / f"{rec['arch']}__{rec['shape']}{suffix}.json"
        path.write_text(json.dumps(rec, indent=1, default=str))
    status = ("SKIP" if rec.get("skipped")
              else "OK" if rec.get("ok") else "FAIL")
    flops = rec.get("cost_analysis", {}).get("flops", 0)
    coll = rec.get("collectives", {}).get("total_bytes", 0)
    print(f"[{status}] {rec['mesh']} {rec['arch']} {rec['shape']} "
          f"({rec.get('tag','baseline')}) "
          f"dryrun={rec.get('dryrun_s','-')}s flops/dev={flops:.3g} "
          f"coll B/dev={coll:.3g}"
          + (f" err={rec.get('error','')}" if not rec.get("ok") and
             not rec.get("skipped") else ""), flush=True)
    if not rec.get("ok") and not rec.get("skipped") and rec.get("traceback"):
        print(rec["traceback"][-1500:], flush=True)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out-dir", default=str(OUT_DIR),
                    help="where the records go (default "
                    "experiments/dryrun_torch)")
    args = ap.parse_args()

    meshes = ([True] if (args.multi_pod or args.mesh == "multi") else
              [False] if args.mesh == "single" else [False, True])
    archs = [args.arch] if args.arch else sorted(ASSIGNED_ARCHS)
    shapes = [args.shape] if args.shape else list(SHAPES)
    if not (args.all or args.arch or args.shape):
        ap.error("pass --all or --arch/--shape")

    n_fail = 0
    for mp in meshes:
        for arch in archs:
            for shape in shapes:
                out = (Path(args.out_dir) / _mesh_name(mp)
                       / f"{arch}__{shape}.json")
                if args.skip_existing and out.exists() and \
                        json.loads(out.read_text()).get("ok"):
                    print(f"[CACHED] {arch} {shape} {_mesh_name(mp)}",
                          flush=True)
                    continue
                rec = run_cell(arch, shape, mp, tag=args.tag,
                               out_dir=Path(args.out_dir))
                if not rec.get("ok") and not rec.get("skipped"):
                    n_fail += 1
    print(f"done; failures={n_fail}", flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
