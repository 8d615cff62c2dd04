"""Continuous-batching serve engine of the port: one fused decode+sample call
per iteration over a paged or contiguous KV cache (counterpart of the core
of the JAX ``repro.serve.engine``: whole-prompt admission, bucketed batched
prefill, chunked prefill, the fused step, and the metrics of
``docs/telemetry.md`` for what this engine does).

* **B fixed slots**, each holding one request at its own depth.  The fused
  step decodes every slot at its own position (``decode_step`` with (B,)
  positions and, paged, the (B, M) page table), samples on the device, and
  brings one (B,) vector of token ids to the host.
* **One CUDA graph a step**: on a single card the fused step (decode, the
  (B, V) fp32 rows, argmax, the non-finite guard and the active mask) is
  captured once, when the engine is built, and replayed every iteration
  (the JAX engine jits it into one dispatch).  Its inputs are static
  device buffers (tokens, positions, active, the cache's page table),
  refreshed each iteration from pinned host copies; the pools are written
  in place and never re-allocated, which each replay checks.  Rows with
  temperature > 0 are sampled eagerly from the graph's rows after the
  replay.  ``cuda_graph=False`` runs the same step eagerly on the card;
  the CPU and a sharded pool (whose merge goes through the host) always do,
  over the same static buffers.  A capture that fails raises.
* **Batched bucketed prefill**: admitted prompts are grouped by
  power-of-two length bucket (capped at ``max_seq``); each group is one
  ``forward(collect_cache=True)`` whose K/V block is scattered into every
  admitted slot's pages (paged) or rows (contiguous).
* **Chunked prefill** (``prefill_chunk=C``, paged only): an admitted
  prompt lands in C-token chunks that interleave with the decode steps,
  at most ``prefill_budget`` tokens (default one chunk) an iteration, so
  no decode iteration waits on more than that.  A round stacks at most
  one chunk per mid-prefill slot into one (n, C) ``LM.prefill_chunk``
  dispatch, eager on the card (graphing it is ROADMAP item 22); chunk k
  attends the pages chunks 0..k-1 wrote.  Pages are claimed chunk by
  chunk (``PagedCache.alloc_chunked`` / ``extend``, banker-safe: a grant
  that is not safe stalls the chunk until completions free pages), and a
  chunk whose positions all lie on landed shared pages skips its forward.
  A mid-prefill slot is inactive and shielded, so it decodes as a parked
  slot into scratch, and the decode step stays one replay of the same
  graph.
* **Admission control**: a request reserves its whole footprint (prompt +
  max_new_tokens) in the page pool; when the pool or the slots are short,
  admission stops in order and the request waits.  The contiguous cache
  reserves ``max_seq`` positions a slot up front and never defers.
* **Multi-tenant scheduling** (``tenancy=``, ``serve/tenancy.py``): each
  request names a tenant of a priority class, with an optional page quota
  that the paged allocator meters.  Admission runs in priority order (FIFO
  within a class); a quota deny skips just that request, a pool deny stops
  the pass once preemption has no victim left: the lowest-priority
  preemptible running decode loses its pages and is re-queued.  Chunk
  rounds take the TTFT-sensitive classes first, within per-class token
  caps.
* **Recompute on resume**: a preempted or recovered request re-enters as
  one prefill of prompt + the tokens it already emitted (re-sharing its
  still-registered prefix pages), sampled at stream step
  ``len(out_tokens)``, so greedy and seeded streams go on as if nothing
  happened.
* **Scratch-routed inactive writes**: free slots decode at position 0
  behind all-zero table rows, so their writes land in scratch page 0
  (contiguous: in row 0 of their own rows, which the next prefill
  rewrites).
* **Fault tolerance** (``fault_plan=``, ``serve/faults.py``): a seeded plan
  injects faults at named seams: NaN logit rows inside the fused step (a
  (B,) poison mask, one more static input of the graph, all False on
  healthy iterations), NaN written into a live KV page, a failed chip of
  the pool, stalled prefill chunks and transient dispatch errors (raised
  before the step touches anything, so the retry is idempotent).  A logit
  row with NaN/Inf yields the token -1 (the non-finite guard), in a
  decode step, a bucketed prefill or a prefill chunk; the slot's pages
  leave prefix sharing and the pool, and the request is re-queued for
  recompute on resume under a retry budget with exponential backoff.  A
  per-stream watchdog (``watchdog_iters``) recovers wedged slots.  A
  stream out of retries, or whose footprint no longer fits after a chip
  loss, is dead-lettered (``status="dead_letter"``, the reason on
  ``Request.error``); its neighbours are untouched.  Through all of it the
  decode step stays one replay of the same graph.
* **Host-RAM page tier** (``host_pages=``, or a persistent
  ``prefix_store=`` shared by successive engines; ``serve/offload.py``): a
  shared prefix page whose last sharer frees it is copied to pinned host
  memory, and a later admission whose prompt hits it copies it back into
  a fresh device page instead of recomputing it (prefetch-then-admit: the
  admission check still sees a cold request's demand).  Chunked, such
  pages count as shared, so the chunks they cover skip their forward.
  The copies write the pools in place, so the decode graph replays
  unchanged.  The store's totals are published as counter deltas
  (``serve_prefix_store_*``, ``serve_host_*``).
* **Health loop**, as in the JAX engine: ``verify_cache=True`` re-checks the
  allocator's invariants every iteration, and an ``AlertManager`` passed as
  ``alerts`` (over the engine's ``registry``) runs ``serve_light_checks``
  (``core/health.py``) and its rules every ``health_every`` iterations.  All
  of it is host code over counters and slot state.

**Image prefix** (a vlm config, internvl2-2b): each request carries its
stub ViT's patch embeddings (``Request.img_embeds``, zeros when absent),
prefilled in front of the prompt, so a slot's positions start after its
``img_len`` image rows, also on a resume.  Image positions are embeddings,
not tokens: such requests skip prefix sharing and the prefix store, and
prefill whole-prompt (chunked prefill is refused), as in JAX.

On CUDA the main path runs the port's kernels: K2 flash prefill, K1 paged
flash-decode (its int8 mode with ``kv_dtype="int8"``) and K3 RMSNorm at
every norm.  ``kv_dtype="int8"`` stores the pages as int8 rows with per-row
fp32 scales: the prefill block is quantized before it is written and each
decode row in the attention block; prefill attends over the float K/V, so
its logits are the native ones.  ``decode_impl`` is ``"kernel"`` (K1) or
``"gather"`` (the dense gathered view); the contiguous cache ignores it, as
in JAX, and runs no K1.

**Sharded pools** (``pool_group``, the counterpart of the JAX ``mesh=``):
the engine runs SPMD, one process per rank of a ``torch.distributed``
group.  Every rank builds the same engine with the same weights and takes
the same requests; its cache holds the rank's P/n-page shard of the pool,
and each decode layer merges the ranks' partials (K1's partials mode under
``"kernel"``), so every rank samples the same tokens and keeps the same
scheduler state.  ``run_until_drained`` checks at the end that every rank
emitted the same streams, and raises if not.  On a 2-D batch x pages mesh
(``dp_group``, the JAX ``dp_axis``) ``pool_group`` is the rank's model
group, over which its pool is split, and ``dp_group`` its dp group, whose
replicas split each attention's batch rows; the check then runs over the
whole world.
"""
from __future__ import annotations

import gc
import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.health import serve_light_checks
from repro_torch.core.telemetry import MetricsRegistry
from repro_torch.kernels import ops
from repro_torch.models import LM
from repro_torch.models.common import resolve_device
from repro_torch.parallel.pagedkv import PoolGroup
from repro_torch.serve.faults import (FaultEvent, FaultPlan,
                                      TransientDispatchError)
from repro_torch.serve.kvcache import (StagedBuffer, decode_transient_bytes,
                                       page_kv_bytes)
from repro_torch.serve.sampling import sample_batch
from repro_torch.serve.tenancy import TenancyConfig, Victim, next_victim


@dataclass
class SamplingParams:
    temperature: float = 0.0         # 0 => greedy
    top_k: int = 0                   # 0 => no top-k filter
    top_p: float = 1.0               # nucleus
    seed: int = 0


@dataclass
class Request:
    id: int
    prompt: np.ndarray               # (prompt_len,) int32
    max_new_tokens: int = 32
    eos_id: int = -1                 # -1: never stops early
    sampling: SamplingParams = field(default_factory=SamplingParams)
    img_embeds: Optional[np.ndarray] = None   # (num_image_tokens, d) for vlm
    out_tokens: List[int] = field(default_factory=list)
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    done_at: Optional[float] = None
    tenant: str = "default"          # tenancy key (ignored without tenancy=)
    preemptions: int = 0             # times this request lost its slot
    last_token_at: Optional[float] = None     # for inter-token latency
    retries: int = 0                 # fault/watchdog recoveries consumed
    error: Optional[str] = None      # dead-letter / stuck diagnostic
    status: str = "pending"          # terminal: completed|dead_letter|stuck
    _seq: int = 0                    # submit order, the FIFO tiebreak
    _resume_after: int = 0           # recovery backoff: earliest readmit iter


@dataclass
class _PrefillState:
    """A slot mid-chunked-prefill, resumable across iterations."""
    req: Request
    done: int = 0            # positions landed so far
    shared: int = 0          # leading positions backed by shared pages
    # what lands: the prompt, or after a preemption or a recovery, prompt +
    # the tokens already emitted (recompute on resume)
    tokens: Optional[np.ndarray] = None


class EngineStuckError(RuntimeError):
    """``run_until_drained`` ran out of ``max_iters`` with work in flight.
    ``.stuck`` holds the wedged requests, each ``status="stuck"`` with the
    diagnostic on ``Request.error``."""

    def __init__(self, message: str, stuck: List["Request"]):
        super().__init__(message)
        self.stuck = stuck


class RankDivergenceError(RuntimeError):
    """The ranks of a sharded engine emitted different streams."""


class ServeEngine:
    def __init__(self, lm: LM, params, max_batch: int, max_seq: int,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 prefix_sharing: bool = True, device="cuda",
                 kv_dtype: str = "native", decode_impl: str = "kernel",
                 pool_group=None, cache_backend: str = "paged",
                 cuda_graph: bool = True, prefill_chunk: int = 0,
                 prefill_budget: int = 0,
                 registry: Optional[MetricsRegistry] = None,
                 tenancy: Optional[TenancyConfig] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 watchdog_iters: int = 0, max_retries: int = 3,
                 verify_cache: bool = False, alerts=None,
                 health_every: int = 16,
                 locality_chips: Optional[int] = None, dp_group=None,
                 host_pages: int = 0, prefix_store=None):
        # per-slot positions rely on masked-then-overwritten cache writes,
        # which holds for attention KV caches but not recurrent state; an
        # encdec config's cross-attention K/V is per-request dense state
        if lm.cfg.family not in ("dense", "moe", "vlm"):
            raise ValueError(
                "ServeEngine supports attention-cache families (dense, moe, "
                f"vlm); {lm.cfg.name} is {lm.cfg.family}: it decodes through "
                "LM.decode_step over LM.init_cache(backend=None)")
        if cache_backend not in ("paged", "contiguous"):
            raise ValueError(f"cache_backend {cache_backend!r} not in "
                             "('paged', 'contiguous')")
        if decode_impl not in ("kernel", "gather"):
            raise ValueError(f"decode_impl {decode_impl!r} not in "
                             "('kernel', 'gather')")
        self.device = resolve_device(device)
        first = params["embed"]["table"]
        if first.device != self.device:
            raise ValueError(f"params live on {first.device}, the engine "
                             f"runs on {self.device}")
        self.lm, self.params = lm, params
        self.B, self.S = max_batch, max_seq
        # the image rows in front of every vlm prompt (0 for dense)
        self.img_len = (lm.cfg.num_image_tokens
                        if lm.cfg.family == "vlm" else 0)
        self.decode_impl = decode_impl
        self.pool_group = pool_group
        self.dp_group = dp_group
        self.reg = registry if registry is not None else MetricsRegistry()
        self.finished: List[Request] = []
        # the health loop (``step``): debug-mode cache checks every
        # iteration; with ``alerts`` the serve light checks and the alert
        # rules every ``health_every`` iterations
        self.verify_cache = bool(verify_cache)
        self.alerts = alerts
        self.health_every = int(health_every)
        dtype = torch.float32 if lm.cfg.dtype == "float32" else torch.bfloat16
        self.kv = lm.init_cache(max_batch, max_seq, backend=cache_backend,
                                page_size=page_size, num_pages=num_pages,
                                prefix_sharing=prefix_sharing,
                                device=self.device, dtype=dtype,
                                kv_dtype=kv_dtype, pool_group=pool_group,
                                locality_chips=locality_chips,
                                dp_group=dp_group, host_pages=host_pages,
                                prefix_store=prefix_store)
        # the store keeps running totals and may serve several engines:
        # each engine publishes them as counter deltas from its own marks
        self._host_synced: Dict[str, int] = {}
        # fault injection, detection and recovery (``serve/faults.py``): the
        # plan is polled once a step; all detection state is on the host
        self.fault_plan = fault_plan
        self.watchdog_iters = int(watchdog_iters)
        self.max_retries = int(max_retries)
        if fault_plan is not None and self.kv.backend != "paged":
            bad = ({e.kind for e in fault_plan.events}
                   & {"poison_page", "chip_failure", "stall_chunk"})
            if bad:
                raise ValueError(
                    f"fault kinds {sorted(bad)} target the paged allocator "
                    "(physical pages / chips / chunked grants); use "
                    "cache_backend='paged'")
        self._iter = 0                      # step() clock (faults, watchdog)
        self._last_progress: dict = {}      # slot -> last progress iter
        self._pending_faults: List[FaultEvent] = []  # carried until firable
        self._poison_slots: set = set()     # nan_logits victims this step
        self._stall_until: Dict[int, int] = {}   # slot -> stall expiry iter
        self._dispatch_fail_left = 0        # queued transient dispatch raises
        self._quarantined: Dict[int, int] = {}    # req.id -> recovery start
        # chunked prefill: C-token chunks, at most `budget` prefill tokens
        # an iteration (0: whole-prompt prefill); JAX's messages
        self.chunk = int(prefill_chunk)
        self.budget = int(prefill_budget) or self.chunk
        if prefill_budget and not self.chunk:
            raise ValueError(
                "prefill_budget bounds *chunked* prefill per iteration; "
                "without prefill_chunk the whole prompt lands in one "
                "dispatch and no budget applies (set prefill_chunk)")
        if self.chunk:
            if cache_backend != "paged":
                raise ValueError(
                    "chunked prefill is page-aware: chunks claim pages "
                    "incrementally and mid-prefill slots shield their table "
                    "rows from decode (use cache_backend='paged')")
            if self.img_len:
                raise ValueError(
                    "chunked prefill covers token prompts; VLM image-embed "
                    "prefixes prefill whole-prompt")
            if lm.cfg.family == "moe":
                raise ValueError(
                    "chunked prefill would change MoE expert-capacity "
                    "routing: moe_ffn computes capacity and token dropping "
                    "per forwarded sequence, so a (1, C) chunk routes "
                    "differently than the whole bucketed prompt and the "
                    "bitwise stream-parity contract breaks; MoE prompts "
                    "prefill whole-prompt")
            if self.chunk < 1 or self.budget < self.chunk:
                raise ValueError(
                    f"prefill budget {self.budget} below one chunk "
                    f"({self.chunk}): no chunk could ever dispatch")
        # tenancy: priority-ordered admission, page quotas (metered by the
        # paged allocator), preemption; JAX's messages
        self.tenancy = tenancy
        self._submit_seq = 0
        if tenancy is not None:
            if tenancy.has_quotas():
                if self.kv.backend != "paged":
                    raise ValueError(
                        "per-tenant page quotas are enforced inside the "
                        "paged backend's banker-style safety check; the "
                        "contiguous layout has no pages to meter (use "
                        "cache_backend='paged' or drop the quotas)")
                for spec in tenancy.tenants.values():
                    if spec.page_quota is not None:
                        self.kv.set_quota(spec.name, spec.page_quota)
            if tenancy.preemption and self.kv.backend != "paged":
                raise ValueError(
                    "preemption evicts a victim's KV pages back to the "
                    "pool; the contiguous layout pre-reserves every slot so "
                    "there is nothing to reclaim (use cache_backend='paged' "
                    "or TenancyConfig(..., preemption=False))")
            if self.chunk:
                for spec in tenancy.tenants.values():
                    cap = tenancy.classes[spec.cls].prefill_budget
                    if cap is not None and cap < self.chunk:
                        raise ValueError(
                            f"class {spec.cls!r} prefill_budget {cap} below "
                            f"one chunk ({self.chunk}): its tenants could "
                            "never finish a prefill")
        self.prefilling: dict = {}       # slot -> _PrefillState, FIFO
        self.slot_req: List[Optional[Request]] = [None] * max_batch
        self.slot_pos = np.zeros(max_batch, np.int32)   # next write index
        self.queue: List[Request] = []
        # per-slot state of the fused step: the pending (sampled, not yet
        # emitted) token and the sampling params, as flat (B,) arrays
        self.next_token = np.zeros(max_batch, np.int32)
        self.active = np.zeros(max_batch, bool)
        self.temps = np.zeros(max_batch, np.float32)
        self.top_ks = np.zeros(max_batch, np.int32)
        self.top_ps = np.ones(max_batch, np.float32)
        self.seeds = np.zeros(max_batch, np.int64)
        # the fused step's static device inputs; the poison mask (the
        # nan_logits seam) is all False on healthy iterations, so it is
        # refreshed only when it changes
        self._tokens = StagedBuffer((max_batch, 1), torch.long, self.device)
        self._positions = StagedBuffer((max_batch,), torch.int32,
                                       self.device)
        self._active = StagedBuffer((max_batch,), torch.bool, self.device)
        self._poison = StagedBuffer((max_batch,), torch.bool, self.device)
        self._poisoned = False
        self._declare_metrics()
        if tenancy is not None:
            for spec in tenancy.tenants.values():
                if spec.page_quota is not None:
                    self.reg.gauge("serve_tenant_quota_pages").set(
                        spec.page_quota, {"tenant": spec.name})
        self._graph = None
        # {"capture_ms", "pool_bytes"} once captured
        self.graph_stats = None
        if cuda_graph and self.device.type == "cuda" and pool_group is None:
            self._capture()

    def _declare_metrics(self):
        """Register every metric the engine emits, eagerly, so the surface
        is complete from iteration zero (names as in docs/telemetry.md)."""
        c, g, h = self.reg.counter, self.reg.gauge, self.reg.histogram
        c("serve_requests_total", "requests accepted by submit()")
        c("serve_admission_deferred_total",
          "admissions deferred by page-pool admission control; the "
          "'reason' label splits pool_exhausted vs quota_denied (the "
          "unlabeled series counts both)")
        c("serve_quota_denied_total",
          "admissions denied by a per-tenant page quota (the tenant's "
          "request is skipped; lower-priority tenants still admit)")
        c("serve_preemptions_total",
          "running decodes preempted under pressure: pages evicted, "
          "request re-queued for recompute-on-resume prefill")
        c("serve_prefill_dispatches_total",
          "prefill dispatches (bucketed groups + chunk rounds)")
        c("serve_prefill_tokens_total", "prompt tokens prefilled")
        c("serve_prefill_chunks_total", "chunked-prefill chunk dispatches")
        c("serve_prefill_chunk_stalls_total",
          "prefill chunks deferred because a page grant was not banker-safe")
        c("serve_prefill_chunks_skipped_total",
          "prefill chunks whose forward was skipped because every position "
          "was already backed by landed shared pages (device-shared or "
          "prefetched from the host tier)")
        c("serve_decode_stall_iters",
          "iterations where live decode streams waited on prefill work "
          "exceeding the per-iteration budget")
        c("serve_decode_dispatches_total", "fused decode+sample dispatches")
        c("serve_iterations_total", "engine iterations")
        c("serve_tokens_total", "tokens emitted by finished requests")
        h("serve_ttft_seconds", "submit-to-first-token latency")
        h("serve_latency_seconds", "submit-to-completion latency")
        h("serve_class_ttft_seconds",
          "submit-to-first-token latency by priority class ('class' label; "
          "populated when tenancy is configured)")
        h("serve_class_itl_seconds",
          "inter-token latency by priority class ('class' label; a "
          "preempted stream's requeue gap counts: that is the SLO cost "
          "of preemption)")
        h("serve_prefill_batch_size",
          "requests covered by one bucketed prefill dispatch",
          buckets=(1, 2, 4, 8, 16, 32, 64, float("inf")))
        g("serve_kv_pages_in_use", "physical KV pages reserved by live slots")
        g("serve_kv_bytes_reserved", "cache bytes reserved by live slots")
        g("serve_kv_bytes_per_chip",
          "pinned cache bytes per mesh chip: this rank's pool shard and its "
          "sink page on a sharded pool, the whole pool on one card")
        g("serve_kv_pages_shared", "pages with refcount > 1 (prefix sharing)")
        g("serve_decode_transient_bytes",
          "per-step transient of the paged KV read path, one layer")
        g("serve_kv_quant_enabled",
          "1 when the paged pool stores int8-quantized pages "
          "(kv_dtype=\"int8\"), 0 on native-dtype pools")
        g("serve_kv_quant_scale_bytes",
          "pinned bytes of the per-row fp32 scale arrays riding alongside "
          "the int8 pools (0 when not quantized)")
        g("serve_kv_quant_bytes_saved",
          "pinned-pool bytes the int8 format saves vs the same pool in the "
          "model dtype, scales included (0 when not quantized)")
        g("serve_tenant_pages_in_use",
          "footprint pages charged to each tenant ('tenant' label)")
        g("serve_tenant_quota_pages",
          "configured per-tenant page quota ('tenant' label)")
        c("serve_faults_injected_total",
          "injected faults that fired, by seam ('kind' label)")
        c("serve_stream_retries_total",
          "stream recoveries (quarantine + evict + re-queue) and transient "
          "dispatch retries, by detection ('reason' label)")
        c("serve_dead_letter_total",
          "requests terminally failed: recovery retries exhausted or "
          "footprint unfittable after a chip loss ('reason' label)")
        h("serve_recovery_iters",
          "engine iterations from a stream's quarantine to its next "
          "emitted token",
          buckets=(1, 2, 4, 8, 16, 32, 64, float("inf")))
        g("serve_streams_quarantined",
          "streams currently re-queued by fault recovery (awaiting resume)")
        c("serve_prefix_store_hits_total",
          "prefix-store page lookups served from the host tier")
        c("serve_prefix_store_misses_total",
          "prefix-store page lookups that missed (cold, evicted, digest "
          "collision, or quarantined-poisoned) and recomputed prefill")
        c("serve_host_evictions_total",
          "host-tier pages LRU-evicted to make room for newer prefixes")
        c("serve_host_offload_bytes_total",
          "wire bytes copied device->host by cold-prefix offload")
        c("serve_host_prefetch_bytes_total",
          "wire bytes copied host->device by prefix-hit prefetch")
        g("serve_host_pages_in_use",
          "prefix pages resident in the host-RAM tier's pinned buffers")

    def _tensor(self, a, dtype=None):
        """A fresh device tensor, for the prefill and the eager sampling of
        rows with temperature > 0 (the fused step's inputs are static)."""
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    # ------------------------------------------------------------- intake ----
    def _footprint(self, req: Request) -> int:
        """Cache positions a request can ever occupy, its image rows
        included: what ``submit`` checks against the pool and ``_admit``
        reserves."""
        return min(self.img_len + len(req.prompt) + req.max_new_tokens,
                   self.S)

    def submit(self, req: Request):
        if len(req.prompt) == 0:
            raise ValueError(f"request {req.id}: empty prompt")
        if len(req.prompt) + self.img_len >= self.S:
            raise ValueError(
                f"request {req.id}: prompt length {len(req.prompt)} "
                f"(+{self.img_len} image tokens) leaves no room to decode "
                f"in a max_seq={self.S} cache")
        if not self.kv.can_ever_fit(self._footprint(req)):
            raise ValueError(
                f"request {req.id}: footprint of {self._footprint(req)} "
                "positions can never fit the page pool")
        if self.tenancy is not None:
            self.tenancy.spec(req.tenant)    # raises on unknown tenant
        req.submitted_at = time.perf_counter()
        req._seq = self._submit_seq
        self._submit_seq += 1
        self.queue.append(req)
        self.reg.counter("serve_requests_total").inc()

    # ----------------------------------------------------------- tenancy ----
    def _prio(self, req: Request) -> int:
        return self.tenancy.priority_of(req.tenant) if self.tenancy else 0

    def _class_name(self, req: Request) -> str:
        return self.tenancy.spec(req.tenant).cls if self.tenancy else "none"

    def _tenant(self, req: Request) -> Optional[str]:
        return req.tenant if self.tenancy is not None else None

    def _admission_order(self) -> List[Request]:
        """The queue in admission order: priority class first, then submit
        order (plain FIFO without tenancy).  A request preempted during
        this pass re-enters ``queue`` but not this list, so one pass never
        preempts and re-admits the same request; a recovering request
        stays out until its backoff horizon ``_resume_after``."""
        ready = [r for r in self.queue if r._resume_after <= self._iter]
        return sorted(ready, key=lambda r: (-self._prio(r), r._seq))

    @staticmethod
    def _prefill_tokens(req: Request) -> np.ndarray:
        """What prefill lands for ``req``: its prompt, and for a preempted
        or recovered request also every token it has emitted (recompute
        on resume, re-sharing whatever of it is still registered)."""
        toks = np.asarray(req.prompt, np.int32)
        if req.out_tokens:
            toks = np.concatenate([toks,
                                   np.asarray(req.out_tokens, np.int32)])
        return toks

    def _count_deferral(self, reason: str) -> None:
        c = self.reg.counter("serve_admission_deferred_total")
        c.inc()                       # the unlabeled total (both causes)
        c.inc(1, {"reason": reason})
        if reason == "quota_denied":
            self.reg.counter("serve_quota_denied_total").inc()

    def _preempt_for(self, req: Request) -> Optional[int]:
        """Preempt the best victim so ``req`` can have its slot and pages:
        a running decode (not mid-prefill) of a strictly lower priority
        and a preemptible class (``next_victim``).  Returns the freed slot,
        or ``None`` when nothing is eligible."""
        if (self.tenancy is None or not self.tenancy.preemption
                or self.kv.backend != "paged"):
            return None
        cands = [Victim(i, self._prio(r),
                        self.tenancy.class_of(r.tenant).preemptible,
                        self.kv.slot_freeable(i))
                 for i, r in enumerate(self.slot_req)
                 if r is not None and i not in self.prefilling]
        victim = next_victim(cands, self._prio(req))
        if victim is None:
            return None
        self._preempt(victim.slot)
        return victim.slot

    def _release(self, slot: int, reset: bool = True) -> Request:
        """Take ``slot``'s request off it (its pages already released):
        the slot is parked, its table row zero in the numpy table, which
        ``decode_view`` copies into the same device tensor, so the graph's
        inputs stay where they were captured.  ``reset`` also drops its
        position and pending token (a preemption or a recovery; a
        completion leaves them, as JAX's does)."""
        req = self.slot_req[slot]
        self.slot_req[slot] = None
        self.active[slot] = False
        if reset:
            self.slot_pos[slot] = 0
            self.next_token[slot] = 0
        self.temps[slot] = 0.0          # a free slot never needs a draw
        self._last_progress.pop(slot, None)
        return req

    def _preempt(self, slot: int) -> None:
        """Evict ``slot``'s pages and re-queue its request, keeping its
        ``_seq``.  The pending token is dropped: the resume prefill
        re-samples it at the same stream step."""
        self.kv.evict(slot)
        req = self._release(slot)
        req.preemptions += 1
        self.queue.append(req)
        self.reg.counter("serve_preemptions_total").inc()

    # ----------------------------------------------------- fault recovery ----
    def _apply_faults(self) -> None:
        """Fire every pending fault whose preconditions hold; the rest are
        carried to the next iteration."""
        self._pending_faults = [
            e for e in self._pending_faults if not self._fire(e)]

    def _victim_slot(self, want: Optional[int]) -> Optional[int]:
        """The requested slot if it is decoding, else (none requested) the
        lowest decoding slot."""
        slots = [i for i in range(self.B)
                 if self.active[i] and i not in self.prefilling]
        if want is not None:
            return want if want in slots else None
        return slots[0] if slots else None

    def _fire(self, e: FaultEvent) -> bool:
        """Apply one fault event; ``False`` carries it forward."""
        if e.kind == "dispatch_error":
            self._dispatch_fail_left += e.duration
        elif e.kind == "nan_logits":
            slot = self._victim_slot(e.slot)
            if slot is None:
                return False
            self._poison_slots.add(slot)
        elif e.kind == "poison_page":
            pid = e.page
            if pid is None:
                slot = self._victim_slot(e.slot)
                if slot is None or self.slot_pos[slot] <= 0:
                    return False
                # the page of the victim's latest position: its next decode
                # step reads it
                pid = int(self.kv.page_table[
                    slot, (int(self.slot_pos[slot]) - 1) // self.kv.page])
            if pid <= 0:
                return False
            self.kv.poison_page(pid)
        elif e.kind == "stall_chunk":
            if not self.chunk:
                return True         # impossible by config: never fires
            slots = sorted(self.prefilling)
            if e.slot is not None:
                slots = [s for s in slots if s == e.slot]
            if not slots:
                return False
            self._stall_until[slots[0]] = self._iter + e.duration
        else:
            assert e.kind == "chip_failure", e.kind
            chip = e.chip if e.chip is not None else self.kv.chips - 1
            for s in self.kv.fail_chip(chip):
                self._recover(s, "chip_failure")
            # a queued request that can never fit the degraded pool would
            # wait forever: dead-letter it now
            for r in [r for r in self.queue
                      if not self.kv.can_ever_fit(self._footprint(r))]:
                self.queue.remove(r)
                self._dead_letter(r, "capacity_lost")
        self.reg.counter("serve_faults_injected_total").inc(
            1, {"kind": e.kind})
        return True

    def _recover(self, slot: int, reason: str) -> None:
        """Quarantine ``slot``'s stream and re-queue it for recompute on
        resume: the preemption path under a retry budget.  Its pages leave
        prefix sharing first (suspect content must not re-share into the
        resume), then the pool; the request keeps its ``_seq`` and waits
        out an exponential backoff.  Out of retries, or with a footprint
        the degraded pool can never hold, it is dead-lettered."""
        self.prefilling.pop(slot, None)
        if self.kv.backend == "paged":
            self.kv.unregister_pages(list(self.kv._slot_pages[slot]))
            self.kv.evict(slot)
        else:
            self.kv.free(slot)
        req = self._release(slot)
        self._stall_until.pop(slot, None)
        req.retries += 1
        self.reg.counter("serve_stream_retries_total").inc(
            1, {"reason": reason})
        if req.retries > self.max_retries:
            self._dead_letter(req, reason)
        elif not self.kv.can_ever_fit(self._footprint(req)):
            self._dead_letter(req, "capacity_lost")
        else:
            # the first quarantine iteration is kept across re-faults, so
            # serve_recovery_iters measures fault to resumption end to end
            self._quarantined.setdefault(req.id, self._iter)
            req._resume_after = self._iter + (1 << (req.retries - 1))
            self.queue.append(req)
            self.reg.gauge("serve_streams_quarantined").set(
                len(self._quarantined))
        self._export_memory()

    def _dead_letter(self, req: Request, reason: str) -> None:
        """Finish ``req`` unserved, with the error on it; its slot and
        pages were already released, and its neighbours are untouched."""
        req.status = "dead_letter"
        req.error = (f"dead-lettered after {req.retries} recoveries "
                     f"(reason: {reason})")
        req.done_at = time.perf_counter()
        self._quarantined.pop(req.id, None)
        self.reg.gauge("serve_streams_quarantined").set(
            len(self._quarantined))
        self.reg.counter("serve_dead_letter_total").inc(1, {"reason": reason})
        self.finished.append(req)

    def _watchdog(self) -> None:
        """Recover every live slot that made no progress (no token, no
        chunk landed, no admission) for ``watchdog_iters`` iterations."""
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            last = self._last_progress.get(slot, self._iter)
            if self._iter - last >= self.watchdog_iters:
                self._recover(slot, "watchdog")

    def _dispatch_fused(self, positions, steps, poison):
        """``_fused`` behind the transient-fault retry loop.  An injected
        ``TransientDispatchError`` raises before the step touches its
        static inputs or the pools, so the retry is idempotent;
        ``max_retries`` failures in a row re-raise (a dead dispatch path
        stops the engine, not a stream)."""
        attempt = 0
        while True:
            try:
                if self._dispatch_fail_left > 0:
                    self._dispatch_fail_left -= 1
                    raise TransientDispatchError(
                        f"injected dispatch failure (iteration {self._iter})")
                return self._fused(positions, steps, poison)
            except TransientDispatchError:
                attempt += 1
                self.reg.counter("serve_stream_retries_total").inc(
                    1, {"reason": "dispatch_error"})
                if attempt > self.max_retries:
                    raise
                time.sleep(min(0.001 * (1 << (attempt - 1)), 0.05))

    # ------------------------------------------------------------ prefill ----
    def _admit(self):
        """Admit queued requests in admission order while a slot and the
        pages of the request's footprint are free, then prefill them: one
        dispatch per power-of-two bucket (chunked: ``_admit_chunked``).  A
        pool deny preempts a lower-priority decode if tenancy allows,
        else stops the pass; a quota deny skips just that request."""
        if self.chunk:
            self._admit_chunked()
            return
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        admitted = []                     # (slot, req, bucket, shared, toks)
        for req in self._admission_order():
            toks = self._prefill_tokens(req)
            # image positions are embeddings, not tokens: no hash identity,
            # so vlm requests skip prefix sharing (and the prefix store)
            prefix = toks if self.img_len == 0 else None
            slot, shared = self._claim(free, req, lambda s: self.kv.alloc(
                s, self._footprint(req), prefix=prefix,
                tenant=self._tenant(req)))
            if slot is None:
                break
            if shared is None:
                continue
            bucket = min(1 << (len(toks) - 1).bit_length(),
                         self.S - self.img_len)
            admitted.append((slot, req, bucket, shared, toks))
        for bucket in sorted({a[2] for a in admitted}):
            self._prefill_group(bucket, [a for a in admitted
                                         if a[2] == bucket])
        if admitted:
            self._export_memory()

    def _claim(self, free: List[int], req: Request, alloc):
        """One admission attempt of ``req`` into ``free[0]`` through
        ``alloc`` (the whole-prompt or the chunked claim), preempting for a
        slot or for pages while there is a victim.  Returns (slot, shared
        length) with the slot taken out of ``free`` and ``req`` out of the
        queue; (-1, None) after a quota deny (skip the request); (None,
        None) after a pool deny (stop the pass)."""
        while True:
            if not free:
                slot = self._preempt_for(req)
                if slot is None:
                    self._count_deferral("pool_exhausted")
                    return None, None
                free.append(slot)
            shared = alloc(free[0])
            if shared is not None:
                self.queue.remove(req)
                return free.pop(0), shared
            if self.kv.last_deny == "quota":
                self._count_deferral("quota_denied")
                return -1, None
            slot = self._preempt_for(req)
            if slot is None:
                self._count_deferral("pool_exhausted")
                return None, None
            free.append(slot)

    def _prefill_group(self, bucket: int, group):
        """One forward for every admitted request of a bucket: stacked
        (n, bucket) tokens in, behind each request's image for a vlm
        config (a block of img_len + bucket positions); the K/V block
        scattered into each slot's pages and each request's first token
        sampled, at stream step ``len(out_tokens)`` (a resumed request
        lands its image, prompt + its emitted tokens and re-samples its
        pending token).  A non-finite row sends its slot to recovery before
        it decodes."""
        n = len(group)
        img = self.img_len
        block_len = img + bucket
        tokens = np.zeros((n, bucket), np.int32)
        last_idx = np.zeros(n, np.int64)
        imgs = (np.zeros((n, img, self.lm.cfg.d_model), np.float32)
                if img else None)
        # the write spec: flat pool rows per position (paged) or one slot
        # id per request (contiguous), the JAX engine's ``write_spec``
        paged = self.kv.backend == "paged"
        dest = np.zeros((n, block_len) if paged else n, np.int32)
        for j, (slot, req, _, shared, ptoks) in enumerate(group):
            tokens[j, :len(ptoks)] = ptoks
            last_idx[j] = img + len(ptoks) - 1
            if img and req.img_embeds is not None:
                imgs[j] = req.img_embeds
            dest[j] = (self.kv.prefill_dest(slot, block_len,
                                            img + len(ptoks), shared)
                       if paged else slot)
        reqs = [r for _, r, _, _, _ in group]
        logits, cache = self.lm.forward(
            self.params, self._tensor(tokens, torch.long), collect_cache=True,
            img_embeds=None if imgs is None else self._tensor(imgs))
        self.kv.staged_write_prefill(self.kv.quantize_block(cache["layers"]),
                                     self._tensor(dest))
        rows = logits[torch.arange(n, device=self.device),
                      self._tensor(last_idx), :self.lm.cfg.vocab_size].float()
        toks = self._sample_for(rows, reqs).cpu().numpy()
        for j, (slot, req, _, _, ptoks) in enumerate(group):
            self._start_decoding(slot, req, toks[j], img + len(ptoks))
            self.reg.counter("serve_prefill_tokens_total").inc(len(ptoks))
        self.reg.counter("serve_prefill_dispatches_total").inc()
        self.reg.histogram("serve_prefill_batch_size").observe(n)
        for j, (slot, _, _, _, _) in enumerate(group):
            if toks[j] == -1:
                self._recover(slot, "nonfinite_logits")

    def _admit_chunked(self):
        """Chunked admission, in the order and with the denies of
        ``_admit``: a request claims only its first chunk's pages
        (``kv.alloc_chunked``; its tenant is charged the whole footprint),
        takes a slot inactive with its decode shield up and joins
        ``prefilling``; its chunks dispatch from ``_run_prefill_chunks``."""
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        admitted = False
        for req in self._admission_order():
            toks = self._prefill_tokens(req)
            slot, shared = self._claim(
                free, req, lambda s: self.kv.alloc_chunked(
                    s, self._footprint(req), min(self.chunk, len(toks)),
                    prefix=toks, tenant=self._tenant(req)))
            if slot is None:
                break
            if shared is None:
                continue
            self.slot_req[slot] = req
            self.active[slot] = False           # not decodable yet
            self.kv.set_decode_shield(slot, True)
            self.prefilling[slot] = _PrefillState(req, shared=shared,
                                                  tokens=toks)
            self._last_progress[slot] = self._iter
            admitted = True
        if admitted:
            self._export_memory()

    def _run_prefill_chunks(self, budget: int, skip=(), cls_spent=None):
        """Spend up to ``budget`` tokens on prefill chunks in rounds: each
        round takes at most one chunk per mid-prefill slot (a slot's chunks
        depend on each other) and dispatches them as one (n, C)
        ``_chunk_group``; rounds repeat while budget and chunks remain.
        Slots are taken in admission order, with tenancy in priority order
        (``_seq`` the tiebreak), and a class's per-iteration token cap
        (``PriorityClass.prefill_budget``, counted in ``cls_spent`` across
        both passes of an iteration) holds its prompts back.  A slot under
        an injected ``stall_chunk`` stalls as a grant that is not safe
        does.  A non-final chunk whose positions all lie below the slot's
        shared prefix is skipped.  Each chunk first ``extend``s its slot to
        the chunk's end (the final one to the whole footprint); a grant
        that is not banker-safe stalls the slot for this call.  A chunk
        whose row is non-finite (it attended a poisoned page) sends its
        slot to recovery before its pages can be registered.  When a
        slot's last chunk lands it is unshielded and made active with its
        sampled first token pending, and decodes this iteration.  Returns
        (budget tokens spent, slots that stalled); ``skip`` holds slots a
        first pass this iteration saw stall."""
        spent = 0
        stalled: set = set()
        cls_spent = cls_spent if cls_spent is not None else {}
        landed = False
        done_slots = set(skip)
        while budget >= self.chunk and self.prefilling:
            order = [s for s in self.prefilling if s not in done_slots]
            if self.tenancy is not None:
                order.sort(key=lambda s: (-self._prio(self.prefilling[s].req),
                                          self.prefilling[s].req._seq))
            group = []                          # (slot, state, end, final)
            for slot in order:
                if (len(group) + 1) * self.chunk > budget:
                    break
                st = self.prefilling[slot]
                plen = len(st.tokens)
                cname = self._class_name(st.req)
                cap = (self.tenancy.classes[cname].prefill_budget
                       if self.tenancy is not None else None)
                if (cap is not None
                        and cls_spent.get(cname, 0) + self.chunk > cap):
                    done_slots.add(slot)
                    continue
                if self._iter < self._stall_until.get(slot, 0):
                    self.reg.counter(
                        "serve_prefill_chunk_stalls_total").inc()
                    stalled.add(slot)
                    done_slots.add(slot)
                    continue
                skipped = 0
                while (st.done + self.chunk < plen
                       and st.done + self.chunk <= st.shared):
                    st.done += self.chunk
                    skipped += 1
                if skipped:
                    self.reg.counter(
                        "serve_prefill_chunks_skipped_total").inc(skipped)
                    self._last_progress[slot] = self._iter
                end = min(st.done + self.chunk, plen)
                final = end == plen
                if not self.kv.extend(
                        slot, self._footprint(st.req) if final else end):
                    self.reg.counter(
                        "serve_prefill_chunk_stalls_total").inc()
                    stalled.add(slot)
                    done_slots.add(slot)
                    continue                    # defer and resume later
                cls_spent[cname] = cls_spent.get(cname, 0) + self.chunk
                group.append((slot, st, end, final))
            if not group:
                break
            toks = self._chunk_group(group)
            for j, (slot, st, end, final) in enumerate(group):
                req = st.req
                self.reg.counter("serve_prefill_tokens_total").inc(
                    end - st.done)
                budget -= self.chunk
                spent += self.chunk
                if toks[j] == -1:
                    self._recover(slot, "nonfinite_logits")
                    done_slots.add(slot)
                    continue
                self.kv.register_landed(slot, st.tokens, end)
                landed = True
                st.done = end
                self._last_progress[slot] = self._iter
                if final:
                    del self.prefilling[slot]
                    self.kv.set_decode_shield(slot, False)
                    self._start_decoding(slot, req, toks[j], len(st.tokens))
        if landed:
            self._export_memory()
        return spent, stalled

    def _chunk_group(self, group):
        """One chunk round: the stacked (n, C) chunks forwarded by
        ``LM.prefill_chunk`` over the slots' real table rows, and a first
        token sampled from each chunk's last valid row at its stream step
        (used only when the chunk is its slot's last).  Returns the (n,)
        ids on the host."""
        n, c = len(group), self.chunk
        tokens = np.zeros((n, c), np.int64)
        dest = np.zeros((n, c), np.int32)
        rows = np.zeros((n, self.kv.max_pages), np.int32)
        starts = np.zeros(n, np.int64)
        lasts = np.zeros(n, np.int64)
        for j, (slot, st, end, _) in enumerate(group):
            tokens[j, :end - st.done] = st.tokens[st.done:end]
            dest[j] = self.kv.chunk_dest(slot, st.done, end, c, st.shared)
            rows[j] = self.kv.table_row(slot)
            starts[j], lasts[j] = st.done, end - 1
        cache = {**self.kv.state, "page_table": self._tensor(rows)}
        logits, _ = self.lm.prefill_chunk(
            self.params, self._tensor(tokens), cache, self._tensor(starts),
            self._tensor(dest), self._tensor(lasts),
            pool_group=self.pool_group, dp_group=self.dp_group)
        toks = self._sample_for(
            logits[:, -1, :self.lm.cfg.vocab_size].float(),
            [st.req for _, st, _, _ in group])
        self.reg.counter("serve_prefill_chunks_total").inc(n)
        self.reg.counter("serve_prefill_dispatches_total").inc()
        return toks.cpu().numpy()

    def _start_decoding(self, slot: int, req: Request, first_token,
                        landed: int) -> None:
        """Make ``slot`` a live decode stream of ``req``, whose ``landed``
        positions are in its pages, with its sampled first token
        pending."""
        self.slot_req[slot] = req
        self.slot_pos[slot] = landed
        self._last_progress[slot] = self._iter
        self.next_token[slot] = first_token
        self.active[slot] = True
        self.temps[slot] = req.sampling.temperature
        self.top_ks[slot] = req.sampling.top_k
        self.top_ps[slot] = req.sampling.top_p
        self.seeds[slot] = req.sampling.seed

    @staticmethod
    def _guard(rows, tok):
        """The non-finite guard: -1 on a row with any NaN/Inf."""
        return torch.where(torch.isfinite(rows).all(dim=-1), tok,
                           torch.full_like(tok, -1))

    def _sample(self, rows, temps, top_ks, top_ps, seeds, steps):
        """Sample (n, V) fp32 rows through ``_guard``.  A non-finite row
        has no distribution: it draws from zeros, and the guard discards
        what it drew."""
        if all(t <= 0 for t in temps):
            tok = torch.argmax(rows, dim=-1).to(torch.int32)
        else:
            finite = torch.isfinite(rows).all(dim=-1, keepdim=True)
            tok = sample_batch(torch.where(finite, rows,
                                           torch.zeros_like(rows)),
                               self._tensor(temps, torch.float32),
                               self._tensor(top_ks, torch.int64),
                               self._tensor(top_ps, torch.float32),
                               self._tensor(seeds, torch.int64),
                               self._tensor(steps, torch.int64))
        return self._guard(rows, tok)

    def _sample_for(self, rows, reqs):
        """A prefill's first tokens: row j sampled with ``reqs[j]``'s
        params at its stream step ``len(out_tokens)``."""
        sp = [r.sampling for r in reqs]
        return self._sample(rows, [s.temperature for s in sp],
                            [s.top_k for s in sp], [s.top_p for s in sp],
                            [s.seed for s in sp],
                            [len(r.out_tokens) for r in reqs])

    # ------------------------------------------------------------- decode ----
    def _decode(self, view):
        """Decode all B slots over the static inputs: the (B, V) fp32 logit
        rows, NaN where the poison mask is set (the nan_logits seam), and
        their greedy ids through ``_guard``, 0 on inactive slots.  The
        CUDA graph captures this call; the eager step runs it as it is."""
        logits, _ = self.lm.decode_step(
            self.params, self._tokens.dev, view, self._positions.dev,
            decode_impl=self.decode_impl, pool_group=self.pool_group,
            dp_group=self.dp_group)
        rows = logits[:, -1, :self.lm.cfg.vocab_size].float().masked_fill(
            self._poison.dev[:, None], float("nan"))
        tok = self._guard(rows, torch.argmax(rows, dim=-1).to(torch.int32))
        return rows, torch.where(self._active.dev, tok, torch.zeros_like(tok))

    @staticmethod
    def _operand_ptrs(view):
        ptrs = {name: t.data_ptr() for name, t in view["layers"].items()}
        if "page_table" in view:
            ptrs["page_table"] = view["page_table"].data_ptr()
        return ptrs

    def _capture(self):
        """Capture ``_decode`` in one CUDA graph.  No slot is live yet: the
        static inputs and the table hold their initial zeros, so every slot
        is parked (token 0, position 0, inactive, not poisoned) and the
        writes land on scratch page 0 or row 0 of empty slots.  Two eager
        steps on a side stream first build the kernels, compile the Triton
        ones and fill the model's host-side caches (RoPE frequencies, whose
        upload could not be captured); their launches count, the capture's
        do not (each replay adds them)."""
        dev = self.device
        view = self.kv.decode_view()
        try:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                for _ in range(2):
                    self._decode(view)
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(dev)
            t0 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            # a cyclic collection inside the capture could free an earlier
            # engine's graph or events, which invalidates the capture
            collecting = gc.isenabled()
            gc.disable()
            try:
                with ops.launches_recorded() as launches:
                    with torch.cuda.graph(graph):
                        out = self._decode(view)
            finally:
                if collecting:
                    gc.enable()
            torch.cuda.synchronize(dev)
        except Exception as e:
            raise RuntimeError("capturing the fused decode step in a CUDA "
                               f"graph failed: {e}") from e
        self._graph, self._graph_out = graph, out
        self._graph_launches = launches
        self._graph_ptrs = self._operand_ptrs(view)
        self.graph_stats = {
            "capture_ms": (time.perf_counter() - t0) * 1e3,
            "pool_bytes": torch.cuda.memory_reserved(dev) - reserved}

    def _replay(self, view):
        """One replay of the captured step; the pools and the table must
        still be the tensors it captured."""
        if self._operand_ptrs(view) != self._graph_ptrs:
            raise RuntimeError(
                "the KV pools or the page table were re-allocated after the "
                "decode step was captured: its CUDA graph would read memory "
                "they no longer own")
        self._graph.replay()
        ops.count_replay(self._graph_launches)
        return self._graph_out

    def _fused(self, positions, steps, poison=None):
        """The fused step: refresh the static inputs (the poison mask only
        when it is or was set; ``None``: no slot poisoned), replay the
        graph (or run the step eagerly), then sample the rows with
        temperature > 0 from its rows.  Returns the (B,) ids (0 on inactive
        slots, -1 on a non-finite row)."""
        self._tokens.set(self.next_token[:, None])
        self._positions.set(positions)
        self._active.set(self.active)
        poisoned = poison is not None and bool(np.any(poison))
        if poisoned or self._poisoned:
            self._poison.set(poison if poisoned else False)
            self._poisoned = poisoned
        view = self.kv.decode_view()
        rows, tok = (self._replay(view) if self._graph is not None
                     else self._decode(view))
        if np.any(self.temps[self.active] > 0):
            tok = torch.where(self._active.dev, self._sample(
                rows, self.temps, self.top_ks, self.top_ps, self.seeds,
                steps), torch.zeros_like(tok))
        return tok

    def step(self) -> bool:
        """One engine iteration in the JAX engine's order: the fault plan's
        events fire (those whose preconditions are not met are carried),
        ``_step`` runs, the watchdog recovers any stream that made no
        progress for ``watchdog_iters`` iterations, then the health loop:
        ``kv.verify()`` when ``verify_cache``, and with an ``AlertManager``
        wired in, every ``health_every`` iterations, ``serve_light_checks``
        and the alert rules.  All of that is host code: the decode step
        stays one replay of its graph.  Returns whether work ran or is in
        flight."""
        if self.fault_plan is not None:
            self._pending_faults.extend(self.fault_plan.events_at(self._iter))
            if self._pending_faults:
                self._apply_faults()
        live = self._step()
        if self.watchdog_iters:
            self._watchdog()
        if self.verify_cache and hasattr(self.kv, "verify"):
            self.kv.verify()
        if self.alerts is not None and self._iter % self.health_every == 0:
            serve_light_checks(self)
            self.alerts.evaluate()
        self._iter += 1
        return live

    def _step(self) -> bool:
        """One engine iteration: admit (and prefill), then one fused
        decode+sample call for every slot.  Chunked: in-flight chunks
        first (a stalled slot has first claim on pages freed since), then
        admission, then the leftover budget on the new admissions' chunks.
        ``serve_decode_stall_iters`` counts iterations where live streams
        waited on more prefill tokens than the budget (any, unchunked).
        Returns whether work ran or is in flight."""
        streams_waiting = bool(np.any(self.active))
        pf0 = self.reg.counter("serve_prefill_tokens_total").get()
        if self.chunk:
            cls_spent: Dict[str, int] = {}
            spent, stalled = self._run_prefill_chunks(self.budget,
                                                      cls_spent=cls_spent)
            self._admit()
            if spent < self.budget:
                self._run_prefill_chunks(self.budget - spent, skip=stalled,
                                         cls_spent=cls_spent)
        else:
            self._admit()
        if streams_waiting and self.reg.counter(
                "serve_prefill_tokens_total").get() - pf0 > self.budget:
            self.reg.counter("serve_decode_stall_iters").inc()
        active_idx = [i for i, r in enumerate(self.slot_req)
                      if r is not None and i not in self.prefilling]
        if not active_idx:
            return bool(self.prefilling)    # chunks still in flight
        # the token sampled now is len(out_tokens) + 1 deep in its stream
        # (the pending token, sampled earlier, is emitted this iteration)
        steps = np.zeros(self.B, np.int64)
        for i in active_idx:
            steps[i] = len(self.slot_req[i].out_tokens) + 1
        # inactive slots, mid-prefill ones too, decode at position 0: their
        # writes land in scratch
        positions = np.where(self.active,
                             np.minimum(self.slot_pos, self.S - 1), 0)
        poison = np.zeros(self.B, bool)
        if self._poison_slots:
            poison[sorted(self._poison_slots)] = True
            self._poison_slots.clear()
        sampled = self._dispatch_fused(positions, steps,
                                       poison).cpu().numpy()
        self.reg.counter("serve_decode_dispatches_total").inc()
        self.reg.counter("serve_iterations_total").inc()
        now = time.perf_counter()
        freed = False
        for i in active_idx:
            req = self.slot_req[i]
            tok = int(self.next_token[i])
            req.out_tokens.append(tok)
            if req.first_token_at is None:
                req.first_token_at = now
                self.reg.histogram("serve_ttft_seconds").observe(
                    now - req.submitted_at)
                if self.tenancy is not None:
                    self.reg.histogram("serve_class_ttft_seconds").observe(
                        now - req.submitted_at,
                        {"class": self._class_name(req)})
            elif self.tenancy is not None and req.last_token_at is not None:
                self.reg.histogram("serve_class_itl_seconds").observe(
                    now - req.last_token_at, {"class": self._class_name(req)})
            req.last_token_at = now
            self.slot_pos[i] += 1
            self._last_progress[i] = self._iter
            if req.id in self._quarantined:
                # the recovered stream emits again: its recovery is done
                self.reg.histogram("serve_recovery_iters").observe(
                    self._iter - self._quarantined.pop(req.id))
                self.reg.gauge("serve_streams_quarantined").set(
                    len(self._quarantined))
            if (len(req.out_tokens) >= req.max_new_tokens
                    or tok == req.eos_id or self.slot_pos[i] >= self.S):
                req.done_at = now
                req.status = "completed"
                self.reg.counter("serve_tokens_total").inc(
                    len(req.out_tokens))
                self.reg.histogram("serve_latency_seconds").observe(
                    now - req.submitted_at)
                self.finished.append(req)
                self.kv.free(i)
                self._release(i, reset=False)
                freed = True
            elif sampled[i] == -1:
                # the guard tripped on this step's logits (a NaN row or a
                # poisoned page): the token just emitted came from clean
                # logits, the resume prefill re-draws this one
                self._recover(i, "nonfinite_logits")
            else:
                self.next_token[i] = sampled[i]
        if freed:
            self._export_memory()
        return True

    def _export_memory(self):
        st = self.kv.memory_stats()
        if self.tenancy is not None:
            for name in self.tenancy.tenants:
                self.reg.gauge("serve_tenant_pages_in_use").set(
                    st.tenant_pages.get(name, 0), {"tenant": name})
        self.reg.gauge("serve_kv_pages_in_use").set(st.pages_in_use)
        self.reg.gauge("serve_kv_bytes_reserved").set(st.bytes_reserved)
        self.reg.gauge("serve_kv_pages_shared").set(st.pages_shared)
        self.reg.gauge("serve_kv_bytes_per_chip").set(
            st.bytes_per_chip + st.bytes_sink_per_chip)
        # dense rows gather nothing: only the paged read has a transient
        self.reg.gauge("serve_decode_transient_bytes").set(
            decode_transient_bytes(self.lm.cfg, self.B, self.kv.max_pages,
                                   st.page_size, self.kv.dtype,
                                   self.decode_impl, st.kv_dtype)
            if st.backend == "paged" else 0)
        quant = st.kv_dtype == "int8"
        self.reg.gauge("serve_kv_quant_enabled").set(int(quant))
        self.reg.gauge("serve_kv_quant_scale_bytes").set(st.bytes_scales)
        saved = 0
        if quant:
            # the same pool (scratch page included) in the compute dtype
            saved = page_kv_bytes(self.lm.cfg, st.page_size, self.kv.dtype) \
                * (st.pages_total + 1) - st.bytes_total
        self.reg.gauge("serve_kv_quant_bytes_saved").set(saved)
        self.reg.gauge("serve_host_pages_in_use").set(st.host_pages_in_use)
        if self.kv.store is not None:
            totals = self.kv.store.stats()
            for metric, key in (
                    ("serve_prefix_store_hits_total", "hits"),
                    ("serve_prefix_store_misses_total", "misses"),
                    ("serve_host_evictions_total", "evictions"),
                    ("serve_host_offload_bytes_total", "offload_bytes"),
                    ("serve_host_prefetch_bytes_total", "prefetch_bytes")):
                delta = totals[key] - self._host_synced.get(key, 0)
                if delta:
                    self.reg.counter(metric).inc(delta)
                self._host_synced[key] = totals[key]

    def run_until_drained(self, max_iters: int = 10_000,
                          on_stuck: str = "raise") -> List[Request]:
        """Step until every submitted request is completed or
        dead-lettered.  Sharded, every rank must have emitted the same
        streams: ``RankDivergenceError`` otherwise.  Out of ``max_iters``
        with work in flight, every survivor is flagged ``status="stuck"``
        with its diagnostic on ``Request.error``; ``on_stuck="raise"``
        raises ``EngineStuckError`` naming the wedged slots and their last
        progress, ``"status"`` returns them after ``finished``."""
        assert on_stuck in ("raise", "status"), on_stuck
        for _ in range(max_iters):
            if not self.step() and not self.queue:
                self._check_ranks_agree()
                return self.finished
        if not self.queue and all(r is None for r in self.slot_req):
            self._check_ranks_agree()
            return self.finished
        stuck: List[Request] = []
        what: List[str] = []
        for slot, req in enumerate(self.slot_req):
            if req is None:
                continue
            last = self._last_progress.get(slot)
            lp = f"iteration {last}" if last is not None else "never"
            stuck.append(req)
            what.append(f"request {req.id} wedged in slot {slot} "
                        f"(last progress: {lp})")
        for req in self.queue:
            stuck.append(req)
            what.append(f"request {req.id} still queued")
        for req, w in zip(stuck, what):
            req.status = "stuck"
            req.error = f"undrained after {max_iters} iterations ({w})"
        if on_stuck == "status":
            return self.finished + stuck
        raise EngineStuckError(
            f"engine not drained after {max_iters} iterations: "
            + "; ".join(what), stuck)

    def _check_ranks_agree(self) -> None:
        """Sharded: every rank of the world (both groups of a 2-D mesh)
        emitted the same streams, else ``RankDivergenceError``."""
        if self.pool_group is None:
            return
        world = (self.pool_group if self.dp_group is None
                 else PoolGroup.of())
        streams = sorted((r.id, r.status, r.out_tokens)
                         for r in self.finished)
        if not world.same_on_every_rank(json.dumps(streams).encode()):
            raise RankDivergenceError(
                f"rank {world.rank} of {world.size}: "
                "the ranks' token streams differ")
