"""The fault-tolerant training loop of the port (counterpart of
``FTTrainLoop`` and ``job_mtbf_seconds`` in the JAX ``repro.core.runtime``):
a real train step wrapped with Young-interval file checkpoints, restart
from the latest checkpoint, and failure injection.

The port's train steps update the state in place, so a restart cannot go
back to a state object that training has since changed: the loop takes a
function that builds the initial state, and calls it again for a restart
that comes before the first checkpoint.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from repro_torch.core.checkpoint import (latest_step, load_checkpoint,
                                         save_checkpoint)
from repro_torch.telemetry import MetricsRegistry

MONTH = 30 * 24 * 3600.0

# per-second hazard rates of the failure kinds that stop a job outright
# (host crash, CUDA error), the JAX ``core.cluster.DEFAULT_RATES`` entries
CRASH_RATES = {"host_crash": 0.02 / MONTH, "cuda_error": 0.02 / MONTH}


def job_mtbf_seconds(n_nodes: int, rates: Optional[Dict] = None) -> float:
    """Mean seconds between job-stopping failures on ``n_nodes`` nodes."""
    crash_rate = sum((rates or CRASH_RATES).values())
    return 1.0 / (crash_rate * n_nodes)


class FTTrainLoop:
    """Wraps a train step with checkpoint/restart + failure injection.
    ``run`` survives injected failures by restoring the latest checkpoint;
    loss trajectories with and without failures agree (the data order is
    a function of the step).

    ``init_state()`` builds the starting state; it runs when there is no
    checkpoint to resume.  Metrics: ``train_step_seconds`` (host clock
    around a step and the read of its metrics, which waits for the device),
    ``job_restarts``, ``checkpoints_written``."""

    def __init__(self, train_step: Callable, init_state: Callable[[], Dict],
                 ckpt_dir: str, ckpt_every: int,
                 registry: Optional[MetricsRegistry] = None,
                 uploader: Optional[Callable] = None):
        self.train_step = train_step
        self.init_state = init_state
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.reg = registry or MetricsRegistry()
        self.uploader = uploader
        self.metrics_log: List[Dict] = []
        self.restarts = 0
        self._fired: set = set()

    def _restore_or_init(self, state=None):
        """The latest checkpoint, restored like ``state`` (or like a fresh
        initial state), or the initial state if there is none."""
        if latest_step(self.ckpt_dir) is None:
            return self.init_state(), 0
        return load_checkpoint(self.ckpt_dir,
                               template=state or self.init_state())

    def run(self, batches: Callable[[int], Dict], total_steps: int,
            fail_at: Optional[Callable[[int], bool]] = None):
        """``batches(step)`` yields the batch for a step.  ``fail_at(step)``
        True simulates a host crash at that step (once per step): progress
        since the last checkpoint is discarded and the loop restarts."""
        state, step = self._restore_or_init()
        while step < total_steps:
            if (fail_at is not None and fail_at(step)
                    and step not in self._fired):
                self._fired.add(step)
                self.restarts += 1
                self.reg.counter("job_restarts").inc()
                state, step = self._restore_or_init(state)
                continue
            t0 = time.perf_counter()
            state, metrics = self.train_step(state, batches(step))
            metrics = {k: float(v) for k, v in metrics.items()}
            self.reg.histogram("train_step_seconds").observe(
                time.perf_counter() - t0)
            self.metrics_log.append({"step": step, **metrics})
            step += 1
            if step % self.ckpt_every == 0:
                save_checkpoint(self.ckpt_dir, state, step,
                                uploader=self.uploader)
                self.reg.counter("checkpoints_written").inc()
        return state
