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
  graph.  Tenancy, faults and the host tier, which JAX's chunked path
  also serves, raise ``NotImplementedError`` naming their ROADMAP items.
* **Admission control**: a request reserves its whole footprint (prompt +
  max_new_tokens) in the page pool; when the pool or the slots are short,
  admission stops in FIFO order and the request waits.  The contiguous
  cache reserves ``max_seq`` positions a slot up front and never defers.
* **Scratch-routed inactive writes**: free slots decode at position 0
  behind all-zero table rows, so their writes land in scratch page 0
  (contiguous: in row 0 of their own rows, which the next prefill
  rewrites).
* **Non-finite guard**: a logit row with NaN/Inf yields the token -1; fault
  recovery is not ported yet, so the engine raises on it.
* **Health loop**, as in the JAX engine: ``verify_cache=True`` re-checks the
  allocator's invariants every iteration, and an ``AlertManager`` passed as
  ``alerts`` (over the engine's ``registry``) runs ``serve_light_checks``
  (``core/health.py``) and its rules every ``health_every`` iterations.  All
  of it is host code over counters and slot state.

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
emitted the same streams, and raises if not.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.health import serve_light_checks
from repro_torch.core.telemetry import MetricsRegistry
from repro_torch.kernels import ops
from repro_torch.models import LM
from repro_torch.models.common import resolve_device
from repro_torch.serve.kvcache import (StagedBuffer, decode_transient_bytes,
                                       page_kv_bytes)
from repro_torch.serve.sampling import sample_batch


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
    out_tokens: List[int] = field(default_factory=list)
    submitted_at: float = 0.0
    first_token_at: Optional[float] = None
    done_at: Optional[float] = None
    status: str = "pending"          # terminal: completed


@dataclass
class _PrefillState:
    """A slot mid-chunked-prefill, resumable across iterations."""
    req: Request
    done: int = 0            # prompt positions landed so far
    shared: int = 0          # leading positions backed by shared pages


#: the JAX engine's keywords the port does not serve yet, and their items
UNPORTED = {"tenancy": 11, "fault_plan": 12, "watchdog_iters": 12,
            "host_pages": 13}


class NonFiniteLogitsError(RuntimeError):
    """A logit row was NaN/Inf.  The JAX engine recovers such streams by
    recompute; the port has no fault recovery yet, so it stops."""


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
                 verify_cache: bool = False, alerts=None,
                 health_every: int = 16, **unported):
        assert lm.cfg.family == "dense", lm.cfg.family
        for name, value in unported.items():
            if name not in UNPORTED:
                raise TypeError(f"ServeEngine got an unexpected keyword "
                                f"argument {name!r}")
            if value:
                raise NotImplementedError(
                    f"ServeEngine({name}=...) is not ported yet (ROADMAP "
                    f"Queue 1 item {UNPORTED[name]})")
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
        self.decode_impl = decode_impl
        self.pool_group = pool_group
        self.reg = registry if registry is not None else MetricsRegistry()
        self.finished: List[Request] = []
        # the health loop (``step``): debug-mode cache checks every
        # iteration; with ``alerts`` the serve light checks and the alert
        # rules every ``health_every`` iterations.  No watchdog is ported
        # (item 12), so the checks' progress window is its default.
        self.verify_cache = bool(verify_cache)
        self.alerts = alerts
        self.health_every = int(health_every)
        self.watchdog_iters = 0
        self._iter = 0                      # step() clock
        self._last_progress: dict = {}      # slot -> last progress iter
        dtype = torch.float32 if lm.cfg.dtype == "float32" else torch.bfloat16
        self.kv = lm.init_cache(max_batch, max_seq, backend=cache_backend,
                                page_size=page_size, num_pages=num_pages,
                                prefix_sharing=prefix_sharing,
                                device=self.device, dtype=dtype,
                                kv_dtype=kv_dtype, pool_group=pool_group)
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
            if self.chunk < 1 or self.budget < self.chunk:
                raise ValueError(
                    f"prefill budget {self.budget} below one chunk "
                    f"({self.chunk}): no chunk could ever dispatch")
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
        # the fused step's static device inputs
        self._tokens = StagedBuffer((max_batch, 1), torch.long, self.device)
        self._positions = StagedBuffer((max_batch,), torch.int32,
                                       self.device)
        self._active = StagedBuffer((max_batch,), torch.bool, self.device)
        self._declare_metrics()
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
          "admissions deferred by page-pool or slot admission control")
        c("serve_prefill_dispatches_total",
          "prefill dispatches (bucketed groups + chunk rounds)")
        c("serve_prefill_tokens_total", "prompt tokens prefilled")
        c("serve_prefill_chunks_total", "chunked-prefill chunk dispatches")
        c("serve_prefill_chunk_stalls_total",
          "prefill chunks deferred because a page grant was not banker-safe")
        c("serve_prefill_chunks_skipped_total",
          "prefill chunks whose forward was skipped because every position "
          "was already backed by landed shared pages")
        c("serve_decode_stall_iters",
          "iterations where live decode streams waited on prefill work "
          "exceeding the per-iteration budget")
        c("serve_decode_dispatches_total", "fused decode+sample dispatches")
        c("serve_iterations_total", "engine iterations")
        c("serve_tokens_total", "tokens emitted by finished requests")
        h("serve_ttft_seconds", "submit-to-first-token latency")
        h("serve_latency_seconds", "submit-to-completion latency")
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

    def _tensor(self, a, dtype=None):
        """A fresh device tensor, for the prefill and the eager sampling of
        rows with temperature > 0 (the fused step's inputs are static)."""
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    # ------------------------------------------------------------- intake ----
    def _footprint(self, req: Request) -> int:
        """Cache positions a request can ever occupy: what ``submit``
        checks against the pool and ``_admit`` reserves."""
        return min(len(req.prompt) + req.max_new_tokens, self.S)

    def submit(self, req: Request):
        if len(req.prompt) == 0:
            raise ValueError(f"request {req.id}: empty prompt")
        if len(req.prompt) >= self.S:
            raise ValueError(
                f"request {req.id}: prompt length {len(req.prompt)} leaves "
                f"no room to decode in a max_seq={self.S} cache")
        if not self.kv.can_ever_fit(self._footprint(req)):
            raise ValueError(
                f"request {req.id}: footprint of {self._footprint(req)} "
                "positions can never fit the page pool")
        req.submitted_at = time.perf_counter()
        self.queue.append(req)
        self.reg.counter("serve_requests_total").inc()

    # ------------------------------------------------------------ prefill ----
    def _admit(self):
        """Admit queued requests in FIFO order while a slot and the pages
        of the request's footprint are free, then prefill them: one
        dispatch per power-of-two prompt bucket (chunked: ``_admit_chunked``
        instead)."""
        if self.chunk:
            self._admit_chunked()
            return
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        admitted = []                           # (slot, req, bucket, shared)
        for req in list(self.queue):
            shared = (self.kv.alloc(free[0], self._footprint(req),
                                    prefix=np.asarray(req.prompt, np.int32))
                      if free else None)
            if shared is None:
                self.reg.counter("serve_admission_deferred_total").inc()
                break
            self.queue.remove(req)
            bucket = min(1 << (len(req.prompt) - 1).bit_length(), self.S)
            admitted.append((free.pop(0), req, bucket, shared))
        for bucket in sorted({a[2] for a in admitted}):
            self._prefill_group(bucket, [a for a in admitted
                                         if a[2] == bucket])
        if admitted:
            self._export_memory()

    def _prefill_group(self, bucket: int, group):
        """One forward for every admitted request of a bucket: stacked
        (n, bucket) tokens in; the K/V block scattered into each slot's
        pages and each request's first token sampled."""
        n = len(group)
        tokens = np.zeros((n, bucket), np.int32)
        last_idx = np.zeros(n, np.int64)
        # the write spec: flat pool rows per position (paged) or one slot
        # id per request (contiguous), the JAX engine's ``write_spec``
        paged = self.kv.backend == "paged"
        dest = np.zeros((n, bucket) if paged else n, np.int32)
        for j, (slot, req, _, shared) in enumerate(group):
            plen = len(req.prompt)
            tokens[j, :plen] = req.prompt
            last_idx[j] = plen - 1
            dest[j] = (self.kv.prefill_dest(slot, bucket, plen, shared)
                       if paged else slot)
        sp = [r.sampling for _, r, _, _ in group]
        logits, cache = self.lm.forward(self.params,
                                        self._tensor(tokens, torch.long),
                                        collect_cache=True)
        self.kv.staged_write_prefill(self.kv.quantize_block(cache["layers"]),
                                     self._tensor(dest))
        rows = logits[torch.arange(n, device=self.device),
                      self._tensor(last_idx), :self.lm.cfg.vocab_size].float()
        toks = self._sample(rows, [s.temperature for s in sp],
                            [s.top_k for s in sp], [s.top_p for s in sp],
                            [s.seed for s in sp], [0] * n)
        toks = toks.cpu().numpy()
        self.reg.counter("serve_prefill_dispatches_total").inc()
        self.reg.histogram("serve_prefill_batch_size").observe(n)
        for j, (slot, req, _, _) in enumerate(group):
            if toks[j] == -1:
                raise NonFiniteLogitsError(
                    f"request {req.id}: non-finite logits in prefill")
            self._start_decoding(slot, req, toks[j])
            self.reg.counter("serve_prefill_tokens_total").inc(
                len(req.prompt))

    def _admit_chunked(self):
        """Chunked admission in FIFO order: a request claims only its first
        chunk's pages (``kv.alloc_chunked``), takes a slot inactive with its
        decode shield up and joins ``prefilling``; its chunks dispatch from
        ``_run_prefill_chunks``.  A deny stops admission."""
        free = [i for i, r in enumerate(self.slot_req) if r is None]
        admitted = False
        for req in list(self.queue):
            shared = (self.kv.alloc_chunked(
                free[0], self._footprint(req),
                min(self.chunk, len(req.prompt)),
                prefix=np.asarray(req.prompt, np.int32)) if free else None)
            if shared is None:
                self.reg.counter("serve_admission_deferred_total").inc()
                break
            slot = free.pop(0)
            self.queue.remove(req)
            self.slot_req[slot] = req
            self.active[slot] = False           # not decodable yet
            self.kv.set_decode_shield(slot, True)
            self.prefilling[slot] = _PrefillState(req, shared=shared)
            self._last_progress[slot] = self._iter
            admitted = True
        if admitted:
            self._export_memory()

    def _run_prefill_chunks(self, budget: int, skip=()):
        """Spend up to ``budget`` tokens on prefill chunks in rounds: each
        round takes at most one chunk per mid-prefill slot (a slot's chunks
        depend on each other) in admission order and dispatches them as one
        (n, C) ``_chunk_group``; rounds repeat while budget and chunks
        remain.  A non-final chunk whose positions all lie below the slot's
        shared prefix is skipped.  Each chunk first ``extend``s its slot to
        the chunk's end (the final one to the whole footprint); a grant
        that is not banker-safe stalls the slot for this call.  When a
        slot's last chunk lands it is unshielded and made active with its
        sampled first token pending, and decodes this iteration.  Returns
        (budget tokens spent, slots that stalled); ``skip`` holds slots a
        first pass this iteration saw stall."""
        spent = 0
        stalled: set = set()
        landed = False
        done_slots = set(skip)
        while budget >= self.chunk and self.prefilling:
            group = []                          # (slot, state, end, final)
            for slot in [s for s in self.prefilling if s not in done_slots]:
                if (len(group) + 1) * self.chunk > budget:
                    break
                st = self.prefilling[slot]
                plen = len(st.req.prompt)
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
                    raise NonFiniteLogitsError(
                        f"request {req.id}: non-finite logits in the prefill "
                        f"chunk at position {st.done}")
                self.kv.register_landed(
                    slot, np.asarray(req.prompt, np.int32), end)
                landed = True
                st.done = end
                self._last_progress[slot] = self._iter
                if final:
                    del self.prefilling[slot]
                    self.kv.set_decode_shield(slot, False)
                    self._start_decoding(slot, req, toks[j])
        if landed:
            self._export_memory()
        return spent, stalled

    def _chunk_group(self, group):
        """One chunk round: the stacked (n, C) chunks forwarded by
        ``LM.prefill_chunk`` over the slots' real table rows, and a first
        token sampled from each chunk's last valid row (used only when the
        chunk is its prompt's last).  Returns the (n,) ids on the host."""
        n, c = len(group), self.chunk
        tokens = np.zeros((n, c), np.int64)
        dest = np.zeros((n, c), np.int32)
        rows = np.zeros((n, self.kv.max_pages), np.int32)
        starts = np.zeros(n, np.int64)
        lasts = np.zeros(n, np.int64)
        for j, (slot, st, end, _) in enumerate(group):
            tokens[j, :end - st.done] = st.req.prompt[st.done:end]
            dest[j] = self.kv.chunk_dest(slot, st.done, end, c, st.shared)
            rows[j] = self.kv.table_row(slot)
            starts[j], lasts[j] = st.done, end - 1
        cache = {**self.kv.state, "page_table": self._tensor(rows)}
        logits, _ = self.lm.prefill_chunk(
            self.params, self._tensor(tokens), cache, self._tensor(starts),
            self._tensor(dest), self._tensor(lasts),
            pool_group=self.pool_group)
        sp = [st.req.sampling for _, st, _, _ in group]
        toks = self._sample(logits[:, -1, :self.lm.cfg.vocab_size].float(),
                            [s.temperature for s in sp],
                            [s.top_k for s in sp], [s.top_p for s in sp],
                            [s.seed for s in sp], [0] * n)
        self.reg.counter("serve_prefill_chunks_total").inc(n)
        self.reg.counter("serve_prefill_dispatches_total").inc()
        return toks.cpu().numpy()

    def _start_decoding(self, slot: int, req: Request, first_token) -> None:
        """Make ``slot`` a live decode stream of ``req`` with its sampled
        first token pending."""
        self.slot_req[slot] = req
        self.slot_pos[slot] = len(req.prompt)
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
        """Sample (n, V) fp32 rows through ``_guard``."""
        if all(t <= 0 for t in temps):
            tok = torch.argmax(rows, dim=-1).to(torch.int32)
        else:
            tok = sample_batch(rows, self._tensor(temps, torch.float32),
                               self._tensor(top_ks, torch.int64),
                               self._tensor(top_ps, torch.float32),
                               self._tensor(seeds, torch.int64),
                               self._tensor(steps, torch.int64))
        return self._guard(rows, tok)

    # ------------------------------------------------------------- decode ----
    def _decode(self, view):
        """Decode all B slots over the static inputs: the (B, V) fp32 logit
        rows and their greedy ids through ``_guard``, 0 on inactive slots.
        The CUDA graph captures this call; the eager step runs it as it
        is."""
        logits, _ = self.lm.decode_step(
            self.params, self._tokens.dev, view, self._positions.dev,
            decode_impl=self.decode_impl, pool_group=self.pool_group)
        rows = logits[:, -1, :self.lm.cfg.vocab_size].float()
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
        is parked (token 0, position 0, inactive) and the writes land on
        scratch page 0 or row 0 of empty slots.  Two eager steps on a side
        stream first build the kernels, compile the Triton ones and fill
        the model's host-side caches (RoPE frequencies, whose upload could
        not be captured); their launches count, the capture's do not (each
        replay adds them)."""
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
            with ops.launches_recorded() as launches:
                with torch.cuda.graph(graph):
                    out = self._decode(view)
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

    def _fused(self, positions, steps):
        """The fused step: refresh the static inputs, replay the graph (or
        run the step eagerly), then sample the rows with temperature > 0 from
        its rows.  Returns the (B,) ids (0 on inactive slots)."""
        self._tokens.set(self.next_token[:, None])
        self._positions.set(positions)
        self._active.set(self.active)
        view = self.kv.decode_view()
        rows, tok = (self._replay(view) if self._graph is not None
                     else self._decode(view))
        if np.any(self.temps[self.active] > 0):
            tok = torch.where(self._active.dev, self._sample(
                rows, self.temps, self.top_ks, self.top_ps, self.seeds,
                steps), torch.zeros_like(tok))
        return tok

    def step(self) -> bool:
        """One engine iteration (``_step``), then the health loop in the
        JAX engine's order: ``kv.verify()`` when ``verify_cache``, and with
        an ``AlertManager`` wired in, every ``health_every`` iterations,
        ``serve_light_checks`` and the alert rules.  The checks read host
        counters and slot state only: the decode step stays one replay of
        its graph.  Returns whether work ran or is in flight."""
        live = self._step()
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
            spent, stalled = self._run_prefill_chunks(self.budget)
            self._admit()
            if spent < self.budget:
                self._run_prefill_chunks(self.budget - spent, skip=stalled)
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
        sampled = self._fused(positions, steps).cpu().numpy()
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
            self.slot_pos[i] += 1
            self._last_progress[i] = self._iter
            if (len(req.out_tokens) >= req.max_new_tokens
                    or tok == req.eos_id or self.slot_pos[i] >= self.S):
                req.done_at = now
                req.status = "completed"
                self.reg.counter("serve_tokens_total").inc(
                    len(req.out_tokens))
                self.reg.histogram("serve_latency_seconds").observe(
                    now - req.submitted_at)
                self.finished.append(req)
                self.slot_req[i] = None
                self.active[i] = False
                self.temps[i] = 0.0     # a free slot never needs a draw
                self._last_progress.pop(i, None)
                self.kv.free(i)
                freed = True
            elif sampled[i] == -1:
                raise NonFiniteLogitsError(
                    f"request {req.id}: non-finite logits at decode step "
                    f"{len(req.out_tokens)}")
            else:
                self.next_token[i] = sampled[i]
        if freed:
            self._export_memory()
        return True

    def _export_memory(self):
        st = self.kv.memory_stats()
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

    def run_until_drained(self, max_iters: int = 10_000) -> List[Request]:
        """Step until every submitted request has completed.  Sharded, every
        rank must have emitted the same streams: ``RankDivergenceError``
        otherwise."""
        for _ in range(max_iters):
            if not self.step() and not self.queue:
                self._check_ranks_agree()
                return self.finished
        raise RuntimeError(f"engine not drained after {max_iters} "
                           f"iterations ({len(self.queue)} queued)")

    def _check_ranks_agree(self) -> None:
        if self.pool_group is None:
            return
        streams = sorted((r.id, r.out_tokens) for r in self.finished)
        if not self.pool_group.same_on_every_rank(
                json.dumps(streams).encode()):
            raise RankDivergenceError(
                f"rank {self.pool_group.rank} of {self.pool_group.size}: "
                "the ranks' token streams differ")
