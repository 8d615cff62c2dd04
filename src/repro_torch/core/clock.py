"""Virtual/wall clock abstraction: the failure/storage simulators advance a
virtual clock so tests never sleep, while the same components run against the
wall clock in real deployments.  A copy of the JAX package's
``core/clock.py`` (pure Python)."""
from __future__ import annotations

import time


class Clock:
    def now(self) -> float:
        raise NotImplementedError

    def advance(self, dt: float) -> None:
        raise NotImplementedError


class WallClock(Clock):
    def now(self) -> float:
        return time.monotonic()

    def advance(self, dt: float) -> None:
        time.sleep(max(dt, 0.0))


class VirtualClock(Clock):
    def __init__(self, start: float = 0.0):
        self._t = float(start)

    def now(self) -> float:
        return self._t

    def advance(self, dt: float) -> None:
        assert dt >= 0, dt
        self._t += dt
