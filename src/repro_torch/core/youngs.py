"""Young's first-order optimal checkpoint interval [Young 1974], as used on
Vela: t_checkpoint = sqrt(2·δ·M) with δ = time to write a checkpoint and
M = mean time between failures.  A copy of the JAX package's
``core/youngs.py`` (pure Python)."""
from __future__ import annotations

import math


def young_interval(delta: float, mtbf: float) -> float:
    """Optimal seconds between checkpoints."""
    if not (delta > 0 and mtbf > 0):
        raise ValueError(f"delta {delta} and mtbf {mtbf} must be positive")
    return math.sqrt(2.0 * delta * mtbf)


def checkpoint_every_n_steps(delta: float, mtbf: float,
                             step_time: float) -> int:
    """The interval quantized to training steps (>= 1)."""
    return max(1, round(young_interval(delta, mtbf) / step_time))
