"""Deterministic fault injection for the serve engine.

The paper's operational core (§2.2.1 Autopilot, §2.3 automated failure
handling) is that faults are the steady state of large AI infrastructure:
the interesting property of a serving stack is not that it is fast when
everything works but that a NaN out of a fused kernel, a corrupted KV
page, or a lost accelerator degrades it *predictably*.  This module is the
injection half of that story — a seedable, fully deterministic
:class:`FaultPlan` that fires :class:`FaultEvent`\\ s at named seams of
``ServeEngine``:

========================  ====================================================
kind                      seam
========================  ====================================================
``nan_logits``            the fused decode+sample dispatch emits non-finite
                          logit rows for a victim slot (injected *inside*
                          the dispatch via a per-slot poison mask, so
                          detection exercises the real on-device guard)
``poison_page``           a live physical KV page's content is overwritten
                          with non-finite values (``PagedCache.poison_page``)
                          — the attention read path drags the corruption
                          into the victim's logits
``chip_failure``          one chip of the ``kv_pages``-sharded pool drops
                          out (``PagedCache.fail_chip``): its free pages are
                          drained, capacity degrades P -> P·(n-1)/n, and
                          every stream holding a page there must recover
``stall_chunk``           a mid-prefill slot's next chunk is refused pages
                          for ``duration`` iterations (a stuck allocator /
                          straggling grant) — the watchdog's prey
``dispatch_error``        the fused dispatch raises a transient
                          :class:`TransientDispatchError` ``duration`` times
                          before the (idempotent) retry goes through
========================  ====================================================

Determinism contract: a plan is a pure function of its event list and
``seed`` — replaying the same plan against the same workload reproduces the
same faults at the same engine iterations, which is what lets the recovery
benches assert *bitwise* stream parity against a fault-free run.

A copy of the JAX package's ``serve/faults.py``: ``FaultPlan.random`` keeps
numpy's ``default_rng`` stream and its order of draws, so a seed gives the
same plan in both packages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

#: the injectable fault kinds, in the order the docs table lists them
KINDS = ("nan_logits", "poison_page", "chip_failure", "stall_chunk",
         "dispatch_error")


class TransientDispatchError(RuntimeError):
    """A simulated transient device-dispatch failure (XID-style hiccup).

    Raised *before* the real dispatch runs, so its inputs — including the
    cache pools — are untouched and the retry is idempotent."""


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.

    ``iteration`` counts engine ``step()`` calls (0-based).  ``slot`` /
    ``chip`` / ``page`` pin the victim; left ``None``, the engine resolves
    a deterministic victim at fire time (lowest eligible slot / highest
    chip / the victim slot's last private page) so plans stay reproducible
    without the author knowing the admission layout in advance.
    ``duration`` extends the stateful kinds: iterations a ``stall_chunk``
    refuses pages, consecutive ``dispatch_error`` raises."""
    iteration: int
    kind: str
    slot: Optional[int] = None
    chip: Optional[int] = None
    page: Optional[int] = None
    duration: int = 1

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(have {KINDS})")
        if self.iteration < 0 or self.duration < 1:
            raise ValueError(f"bad schedule {self.iteration}@{self.duration}")


class FaultPlan:
    """A deterministic schedule of :class:`FaultEvent` s.

    The engine polls ``events_at(iteration)`` once per ``step()``; events
    whose preconditions are not met yet (e.g. a ``nan_logits`` event while
    no slot is active) are carried forward by the engine, not dropped, so
    every planned fault eventually fires on a draining workload."""

    def __init__(self, events: Sequence[FaultEvent], seed: int = 0):
        self.events: List[FaultEvent] = sorted(
            events, key=lambda e: (e.iteration, KINDS.index(e.kind)))
        self.seed = seed

    def __len__(self) -> int:
        return len(self.events)

    def __repr__(self) -> str:
        return (f"FaultPlan({len(self.events)} events, seed={self.seed}: "
                + ", ".join(f"{e.kind}@{e.iteration}" for e in self.events)
                + ")")

    def events_at(self, iteration: int) -> List[FaultEvent]:
        return [e for e in self.events if e.iteration == iteration]

    # ------------------------------------------------------- constructors ----
    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "FaultPlan":
        """Build a plan from a CLI string (``--fault-plan``).

        Comma-separated ``kind@iteration[:key=val[:key=val...]]`` entries;
        keys are ``slot`` / ``chip`` / ``page`` / ``dur``::

            nan_logits@5,poison_page@9:slot=2,chip_failure@12:chip=1
            stall_chunk@3:slot=0:dur=8,dispatch_error@7:dur=2
        """
        events: List[FaultEvent] = []
        for part in filter(None, (p.strip() for p in spec.split(","))):
            head, *opts = part.split(":")
            kind, at, iteration = head.partition("@")
            if not at:
                raise ValueError(f"fault {part!r}: expected kind@iteration")
            kw: Dict[str, int] = {}
            for opt in opts:
                key, eq, val = opt.partition("=")
                if not eq or key not in ("slot", "chip", "page", "dur"):
                    raise ValueError(f"fault {part!r}: bad option {opt!r} "
                                     "(slot=/chip=/page=/dur=)")
                kw["duration" if key == "dur" else key] = int(val)
            events.append(FaultEvent(int(iteration), kind, **kw))
        return cls(events, seed=seed)

    @classmethod
    def random(cls, n: int, max_iter: int, seed: int = 0,
               kinds: Tuple[str, ...] = ("nan_logits", "poison_page",
                                         "stall_chunk", "dispatch_error"),
               ) -> "FaultPlan":
        """A seeded random plan for soak tests: ``n`` events drawn over
        ``[1, max_iter)`` with victims left to engine-side deterministic
        resolution.  ``chip_failure`` is excluded by default — it is not
        repeatable (a chip fails once) and belongs in targeted plans."""
        rng = np.random.default_rng(seed)
        events = [FaultEvent(int(rng.integers(1, max_iter)),
                             str(rng.choice(list(kinds))),
                             duration=int(rng.integers(1, 4)))
                  for _ in range(n)]
        return cls(events, seed=seed)
