"""Training entry point of the port: data pipeline -> fault-tolerant loop ->
checkpoints -> metrics, on the card unless ``--device cpu``.

    python -m repro_torch.launch.train --arch qwen3-4b --reduced --steps 200
    python -m repro_torch.launch.train --device cpu --reduced --steps 3
    python -m repro_torch.launch.train --preset quickstart-100m --steps 300

It takes the flags of ``repro.launch.train`` and prints the same summary
lines.  The loss reaches K4 and the optimizer K5 (their plain versions on
the CPU); the forward uses blockwise attention and plain RMSNorm, as the
JAX trainer does.
"""
from __future__ import annotations

import argparse
import tempfile
import time
from pathlib import Path

import torch

from repro_torch.configs import CONFIGS, TrainConfig, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core import CheckpointManager, FTTrainLoop, job_mtbf_seconds
from repro_torch.data import (DeterministicLoader, LoaderConfig, TokenDataset,
                              synthetic_corpus, write_token_shards)
from repro_torch.models import LM, ForwardOpts
from repro_torch.models.common import resolve_device
from repro_torch.telemetry import MetricsRegistry
from repro_torch.train import init_train_state, make_train_step

QUICKSTART_100M = ModelConfig(
    name="quickstart-100m", family="dense", num_layers=12, d_model=768,
    num_heads=12, num_kv_heads=4, head_dim=64, d_ff=3072, vocab_size=32000)


def build_config(args) -> ModelConfig:
    if args.preset == "quickstart-100m":
        return QUICKSTART_100M
    cfg = get_config(args.arch)
    return cfg.reduced() if args.reduced else cfg


def main(argv=None):
    tmp = Path(tempfile.gettempdir())
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b",
                    choices=sorted(CONFIGS) + ["quickstart-100m"])
    ap.add_argument("--preset", default=None)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=False, help="the reduced config of --arch")
    ap.add_argument("--device", default="cuda",
                    help="torch device; the run fails if CUDA is asked for "
                         "and absent")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--data-dir", default=str(tmp / "repro_torch_data"))
    ap.add_argument("--ckpt-dir", default=str(tmp / "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="0 = Young's formula from measured step time")
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = build_config(args)
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"family={cfg.family}")

    # --- data ---------------------------------------------------------------
    data_dir = Path(args.data_dir) / cfg.name
    if not (data_dir / "index.txt").exists():
        toks = synthetic_corpus(max(2_000_000, args.batch * args.seq * 20),
                                cfg.vocab_size, seed=0)
        write_token_shards(str(data_dir), toks)
    ds = TokenDataset(str(data_dir))
    loader = DeterministicLoader(ds, LoaderConfig(args.batch, args.seq))

    # --- model / trainer -----------------------------------------------------
    lm = LM(cfg)
    tcfg = TrainConfig(learning_rate=args.lr, warmup_steps=20,
                       total_steps=args.steps)
    opts = ForwardOpts(attn_impl="blockwise", norm_impl="plain",
                       q_chunk=min(args.seq, 512), kv_chunk=min(args.seq, 512))
    state = init_train_state(lm, 0, tcfg, device=device)
    step = make_train_step(lm, tcfg, opts, microbatches=args.microbatches)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # --- warmup to measure step time for Young's interval --------------------
    # (the first step pays for kernel builds and allocator warm-up; as in
    # the JAX launcher, the loop then starts from the warmed-up state)
    b0 = loader.batch_at(0)
    t0 = time.perf_counter()
    state, _ = step(state, b0)
    sync()
    t_compile = time.perf_counter() - t0
    t0 = time.perf_counter()
    state, _ = step(state, b0)
    sync()
    step_time = time.perf_counter() - t0
    ckpt_every = args.ckpt_every or CheckpointManager(
        args.ckpt_dir, delta_seconds=max(step_time, 1.0),
        mtbf_seconds=job_mtbf_seconds(96), step_time=step_time).every
    ckpt_every = min(ckpt_every, max(args.steps // 3, 1))
    print(f"compile={t_compile:.1f}s step={step_time*1e3:.0f}ms "
          f"ckpt_every={ckpt_every}")

    # --- FT loop -------------------------------------------------------------
    # The loop starts from the warmed-up state, handed over once.  Steps
    # update it in place, so a restart before the first checkpoint rebuilds
    # it (seed 0 and the same two warm-up steps) instead of reusing it.
    warmed = [state]
    del state

    def init_state():
        if warmed:
            return warmed.pop()
        fresh = init_train_state(lm, 0, tcfg, device=device)
        for _ in range(2):
            fresh, _ = step(fresh, b0)
        return fresh

    reg = MetricsRegistry()
    loop = FTTrainLoop(step, init_state, args.ckpt_dir, ckpt_every,
                       registry=reg)
    t0 = time.perf_counter()
    loop.run(loader.batch_at, args.steps)
    wall = time.perf_counter() - t0
    for m in loop.metrics_log:
        if m["step"] % args.log_every == 0 or m["step"] == args.steps - 1:
            print(f"step {m['step']:5d} loss {m['loss']:.4f} "
                  f"gnorm {m['grad_norm']:.3f} lr {m['lr']:.2e}")
    toks = args.steps * args.batch * args.seq
    print(f"done: {args.steps} steps, {toks/wall:.0f} tok/s, "
          f"{reg.counter('checkpoints_written').get():.0f} checkpoints, "
          f"final loss {loop.metrics_log[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
