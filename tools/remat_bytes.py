#!/usr/bin/env python3
"""Activation bytes a train forward leaves for its backward, by remat policy.

    PYTHONPATH=src python3 tools/remat_bytes.py [ARCH ...] [--batch B]
        [--seq S] [--device cpu|cuda]

For each arch (default zamba2-1.2b and rwkv6-1.6b) at full width and its
compute dtype, with fp32 parameters as the train path keeps them, the
loss's forward under ``TRAIN_OPTS`` is run at depth 0 (embedding, final
norm, unembedding and loss), at depth 1 and, for a hybrid config, at depth
1 with its shared block firing after layer 0; the differences give the
bytes of one layer and of one shared-block call under each of ``none``,
``selective`` and ``full``.  Counted: every tensor the autograd graph
packs (``saved_tensors_hooks``) that is not a parameter, plus, under
``selective``, the matmul outputs its policy keeps in the checkpoint's
own cache.  A policy's peak adds the parameters, the two moments and the
gradients (16 bytes a parameter) and, under remat, one layer's ``none``
bytes recomputed in its backward.  It prints the per-layer numbers and
the whole model's estimate at the given batch and length (default 4 x
1024); on the CPU it runs one layer at a time, so it fits the host.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.train import TRAIN_OPTS  # noqa: E402
from repro_torch.train.optimizer import tree_leaves  # noqa: E402

POLICIES = ("none", "selective", "full")


def saved_bytes(cfg, remat: str, b: int, s: int, device) -> int:
    lm = LM(cfg)
    params = lm.init(0, device=device, dtype=torch.float32)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    storages = {t.untyped_storage().data_ptr() for t in leaves}
    total = [0]

    def pack(t):
        if t.untyped_storage().data_ptr() not in storages:
            total[0] += t.numel() * t.element_size()
        return t

    policy = transformer._selective_policy

    def counting(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        if (decision == torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
                and not ctx.is_recompute):
            total[0] += (args[-2].shape[0] * args[-1].shape[1]
                         * args[-2].element_size())
        return decision

    rng = np.random.default_rng(0)
    batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                                device=device)
             for k in ("tokens", "labels")}
    opts = dataclasses.replace(TRAIN_OPTS, remat=remat, q_chunk=min(s, 1024),
                               kv_chunk=min(s, 1024))
    transformer._selective_policy = counting
    try:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            lm.loss(params, batch, opts)
    finally:
        transformer._selective_policy = policy
    return total[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("archs", nargs="*",
                    default=["zamba2-1.2b", "rwkv6-1.6b"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    gib = 2 ** 30
    for name in args.archs:
        base = get_config(name)
        cuts = {"top": dict(num_layers=0), "layer": dict(num_layers=1)}
        if base.family == "hybrid" and base.hybrid_attn_every:
            cuts["shared"] = dict(num_layers=1, hybrid_attn_every=1)
        # one sequence at a time: the bytes scale with the batch
        got = {(cut, p): saved_bytes(dataclasses.replace(base, **kw), p, 1,
                                     args.seq, args.device)
               for cut, kw in cuts.items() for p in POLICIES}
        state = 16 * base.param_count() / gib
        n_shared = (base.num_layers // base.hybrid_attn_every
                    if "shared" in cuts else 0)
        print(f"{name}: B=1 S={args.seq}, {str(base.dtype)} compute, fp32 "
              f"parameters; state (parameters, moments, gradients) "
              f"{state:.2f} GiB")
        for p in POLICIES:
            top = got[("top", p)]
            layer = got[("layer", p)] - top
            shared = (got[("shared", p)] - got[("layer", p)]
                      if n_shared else 0)
            acts = args.batch * (top + base.num_layers * layer
                                 + n_shared * shared) / gib
            recompute = 0.0
            if p != "none":
                recompute = args.batch * (
                    got[("layer", "none")] - got[("top", "none")]
                    + (got[("shared", "none")] - got[("layer", "none")]
                       if n_shared else 0)) / gib
            print(f"  {p:9s} per layer {layer / 2**20:8.1f} MiB, shared "
                  f"block {shared / 2**20:8.1f} MiB, outside the layers "
                  f"{top / 2**20:8.1f} MiB; at {args.batch} x {args.seq}: "
                  f"activations {acts:6.2f} GiB, peak ~"
                  f"{acts + state + recompute:6.2f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
