"""Multi-tenant SLO scheduling for the serve engine.

The cluster layer (``repro_torch.core.tenancy``) shares *nodes* between
namespaces; this module shares the two resources the serving engine
actually runs out of — **decode slots** and **KV pages** — between
tenants, in SLO terms:

- every :class:`~repro_torch.serve.engine.Request` carries a ``tenant`` id;
- each tenant belongs to a :class:`~repro_torch.core.tenancy.PriorityClass`
  (``interactive`` / ``batch`` built in, arbitrary classes accepted) and
  may carry a hard **page quota** enforced inside ``PagedCache``'s
  banker-style safety check (a quota deny is *not* a pool-exhaustion
  deny: the engine skips the request and keeps admitting others);
- admission is priority-ordered (stable FIFO within a class), and under
  slot/page pressure the engine **preempts** the lowest-priority running
  decode: its pages are evicted and the request re-queued for
  recompute-on-resume prefill (prefix sharing makes the re-prefill cheap
  when its prompt pages are still registered);
- chunked prefill schedules TTFT-sensitive classes first and can cap a
  class's prefill tokens per iteration (``PriorityClass.prefill_budget``).

Victim selection (:func:`next_victim`) is a pure function so the
preemption policy is directly property-testable.

A copy of the JAX package's ``serve/tenancy.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence

from repro_torch.core.tenancy import (BATCH, DEFAULT_CLASSES, INTERACTIVE,
                                PriorityClass)

__all__ = ["PriorityClass", "INTERACTIVE", "BATCH", "DEFAULT_CLASSES",
           "TenantSpec", "TenancyConfig", "Victim", "next_victim"]


@dataclass(frozen=True)
class TenantSpec:
    """One tenant: a name, its priority class, and an optional hard cap on
    concurrently-held KV pages (``None`` = bounded only by the pool)."""
    name: str
    cls: str = BATCH.name
    page_quota: Optional[int] = None


class TenancyConfig:
    """Validated tenant/class table handed to ``ServeEngine(tenancy=...)``.

    ``preemption=False`` keeps quotas and priority ordering but never
    evicts a running decode (admission then waits like the untenanted
    engine does under pool pressure).
    """

    def __init__(self, tenants: Iterable[TenantSpec],
                 classes: Optional[Dict[str, PriorityClass]] = None,
                 preemption: bool = True):
        self.classes: Dict[str, PriorityClass] = dict(DEFAULT_CLASSES)
        if classes:
            for name, cls in classes.items():
                if name != cls.name:
                    raise ValueError(f"class key {name!r} != name {cls.name!r}")
                self.classes[name] = cls
        self.tenants: Dict[str, TenantSpec] = {}
        for spec in tenants:
            if spec.name in self.tenants:
                raise ValueError(f"duplicate tenant {spec.name!r}")
            if spec.cls not in self.classes:
                raise ValueError(f"tenant {spec.name!r}: unknown class "
                                 f"{spec.cls!r} (have {sorted(self.classes)})")
            if spec.page_quota is not None and spec.page_quota < 1:
                raise ValueError(f"tenant {spec.name!r}: page_quota must be "
                                 f">= 1, got {spec.page_quota}")
            self.tenants[spec.name] = spec
        if not self.tenants:
            raise ValueError("TenancyConfig needs at least one tenant")
        self.preemption = bool(preemption)

    def spec(self, tenant: str) -> TenantSpec:
        try:
            return self.tenants[tenant]
        except KeyError:
            raise ValueError(f"unknown tenant {tenant!r} "
                             f"(have {sorted(self.tenants)})") from None

    def class_of(self, tenant: str) -> PriorityClass:
        return self.classes[self.spec(tenant).cls]

    def priority_of(self, tenant: str) -> int:
        return self.class_of(tenant).priority

    def has_quotas(self) -> bool:
        return any(t.page_quota is not None for t in self.tenants.values())

    @classmethod
    def parse(cls, tenants: str, quotas: str = "",
              preemption: bool = True) -> "TenancyConfig":
        """Build a config from CLI strings.

        ``tenants`` is ``name=class,name=class,...`` (class defaults to
        ``batch`` when omitted); ``quotas`` is ``name=pages,...``.
        """
        specs: Dict[str, TenantSpec] = {}
        for part in filter(None, (p.strip() for p in tenants.split(","))):
            name, _, klass = part.partition("=")
            specs[name] = TenantSpec(name, klass or BATCH.name)
        quota_of: Dict[str, int] = {}
        for part in filter(None, (p.strip() for p in quotas.split(","))):
            name, _, pages = part.partition("=")
            if name not in specs:
                raise ValueError(f"--quota names unknown tenant {name!r}")
            quota_of[name] = int(pages)
        return cls((TenantSpec(s.name, s.cls, quota_of.get(s.name))
                    for s in specs.values()), preemption=preemption)


@dataclass(frozen=True)
class Victim:
    """A running decode slot considered for preemption: its engine slot,
    its tenant's priority, whether its class allows preemption, and how
    many pages eviction would actually return to the pool (exclusively
    owned — shared prefix pages stay pinned by their other references)."""
    slot: int
    priority: int
    preemptible: bool
    freeable: int


def next_victim(candidates: Sequence[Victim],
                preemptor_priority: int) -> Optional[Victim]:
    """Pick the slot to preempt so ``preemptor_priority`` can admit.

    Only strictly-lower-priority, preemptible slots are eligible (equal
    priority never preempts — that would livelock two batch tenants).
    Among eligible victims: lowest priority first, then most freeable
    pages (fewest evictions to satisfy the preemptor), then lowest slot
    for determinism. Returns ``None`` when nothing is eligible.
    """
    eligible: List[Victim] = [v for v in candidates
                              if v.preemptible
                              and v.priority < preemptor_priority]
    if not eligible:
        return None
    return min(eligible, key=lambda v: (v.priority, -v.freeable, v.slot))
