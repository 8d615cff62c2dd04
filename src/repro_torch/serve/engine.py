"""Continuous-batching serve engine of the port: one fused decode+sample call
per iteration over a paged KV cache (counterpart of the core of the JAX
``repro.serve.engine``: whole-prompt admission, bucketed batched prefill,
the fused step, and the metrics of ``docs/telemetry.md`` for what this
engine does).

* **B fixed slots**, each holding one request at its own depth.  The fused
  step decodes every slot at its own position (``decode_step`` with (B,)
  positions and the (B, M) page table), samples on the device, and brings
  one (B,) vector of token ids to the host.
* **Batched bucketed prefill**: admitted prompts are grouped by
  power-of-two length bucket (capped at ``max_seq``); each group is one
  ``forward(collect_cache=True)`` whose K/V block is scattered into every
  admitted slot's pages.
* **Admission control**: a request reserves its whole footprint (prompt +
  max_new_tokens) in the page pool; when the pool or the slots are short,
  admission stops in FIFO order and the request waits.
* **Scratch-routed inactive writes**: free slots decode at position 0
  behind all-zero table rows, so their writes land in scratch page 0.
* **Non-finite guard**: a logit row with NaN/Inf yields the token -1; fault
  recovery is not ported yet, so the engine raises on it.

On CUDA the main path runs the port's kernels: K2 flash prefill, K1 paged
flash-decode and K3 RMSNorm at every norm.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.models import LM
from repro_torch.models.common import resolve_device
from repro_torch.serve.kvcache import decode_transient_bytes
from repro_torch.serve.sampling import sample_batch
from repro_torch.telemetry import MetricsRegistry


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


class NonFiniteLogitsError(RuntimeError):
    """A logit row was NaN/Inf.  The JAX engine recovers such streams by
    recompute; the port has no fault recovery yet, so it stops."""


class ServeEngine:
    def __init__(self, lm: LM, params, max_batch: int, max_seq: int,
                 page_size: int = 16, num_pages: Optional[int] = None,
                 prefix_sharing: bool = True, device="cuda"):
        assert lm.cfg.family == "dense", lm.cfg.family
        self.device = resolve_device(device)
        first = params["embed"]["table"]
        if first.device != self.device:
            raise ValueError(f"params live on {first.device}, the engine "
                             f"runs on {self.device}")
        self.lm, self.params = lm, params
        self.B, self.S = max_batch, max_seq
        self.reg = MetricsRegistry()
        self.finished: List[Request] = []
        dtype = torch.float32 if lm.cfg.dtype == "float32" else torch.bfloat16
        self.kv = lm.init_cache(max_batch, max_seq, page_size=page_size,
                                num_pages=num_pages,
                                prefix_sharing=prefix_sharing,
                                device=self.device, dtype=dtype)
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
        self._declare_metrics()

    def _declare_metrics(self):
        """Register every metric the engine emits, eagerly, so the surface
        is complete from iteration zero (names as in docs/telemetry.md)."""
        c, g, h = self.reg.counter, self.reg.gauge, self.reg.histogram
        c("serve_requests_total", "requests accepted by submit()")
        c("serve_admission_deferred_total",
          "admissions deferred by page-pool or slot admission control")
        c("serve_prefill_dispatches_total", "bucketed prefill dispatches")
        c("serve_prefill_tokens_total", "prompt tokens prefilled")
        c("serve_decode_stall_iters",
          "iterations where live decode streams waited on prefill work")
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
        g("serve_kv_pages_shared", "pages with refcount > 1 (prefix sharing)")
        g("serve_decode_transient_bytes",
          "per-step transient of the paged KV read path, one layer")

    def _tensor(self, a, dtype=None):
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
        dispatch per power-of-two prompt bucket."""
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
        dest = np.zeros((n, bucket), np.int32)
        for j, (slot, req, _, shared) in enumerate(group):
            plen = len(req.prompt)
            tokens[j, :plen] = req.prompt
            last_idx[j] = plen - 1
            dest[j] = self.kv.prefill_dest(slot, bucket, plen, shared)
        sp = [r.sampling for _, r, _, _ in group]
        logits, cache = self.lm.forward(self.params,
                                        self._tensor(tokens, torch.long),
                                        collect_cache=True)
        self.kv.staged_write_prefill(cache["layers"], self._tensor(dest))
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
            self.slot_req[slot] = req
            self.slot_pos[slot] = len(req.prompt)
            self.next_token[slot] = toks[j]
            self.active[slot] = True
            self.temps[slot] = req.sampling.temperature
            self.top_ks[slot] = req.sampling.top_k
            self.top_ps[slot] = req.sampling.top_p
            self.seeds[slot] = req.sampling.seed
            self.reg.counter("serve_prefill_tokens_total").inc(
                len(req.prompt))

    def _sample(self, rows, temps, top_ks, top_ps, seeds, steps):
        """Sample (n, V) fp32 rows; a row with any NaN/Inf yields -1."""
        if all(t <= 0 for t in temps):
            tok = torch.argmax(rows, dim=-1).to(torch.int32)
        else:
            tok = sample_batch(rows, self._tensor(temps, torch.float32),
                               self._tensor(top_ks, torch.int64),
                               self._tensor(top_ps, torch.float32),
                               self._tensor(seeds, torch.int64),
                               self._tensor(steps, torch.int64))
        return torch.where(torch.isfinite(rows).all(dim=-1), tok,
                           torch.full_like(tok, -1))

    # ------------------------------------------------------------- decode ----
    def _fused(self, positions, steps):
        """The fused step: decode all B slots at their own positions, then
        sample every slot.  Returns the (B,) ids (0 on inactive slots)."""
        logits, _ = self.lm.decode_step(
            self.params, self._tensor(self.next_token[:, None], torch.long),
            self.kv.decode_view(), self._tensor(positions, torch.int32))
        rows = logits[:, -1, :self.lm.cfg.vocab_size].float()
        tok = self._sample(rows, self.temps.tolist(), self.top_ks.tolist(),
                           self.top_ps.tolist(), self.seeds.tolist(),
                           steps.tolist())
        return torch.where(self._tensor(self.active), tok,
                           torch.zeros_like(tok))

    def step(self) -> bool:
        """One engine iteration: admit (and prefill), then one fused
        decode+sample call for every slot.  Returns whether work ran."""
        streams_waiting = bool(np.any(self.active))
        pf0 = self.reg.counter("serve_prefill_tokens_total").get()
        self._admit()
        if streams_waiting and \
                self.reg.counter("serve_prefill_tokens_total").get() > pf0:
            self.reg.counter("serve_decode_stall_iters").inc()
        active_idx = [i for i, r in enumerate(self.slot_req) if r is not None]
        if not active_idx:
            return False
        # the token sampled now is len(out_tokens) + 1 deep in its stream
        # (the pending token, sampled earlier, is emitted this iteration)
        steps = np.zeros(self.B, np.int64)
        for i in active_idx:
            steps[i] = len(self.slot_req[i].out_tokens) + 1
        # inactive slots decode at position 0: their writes land in scratch
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
        self.reg.gauge("serve_decode_transient_bytes").set(
            decode_transient_bytes(self.lm.cfg, self.kv.page, self.kv.dtype))

    def run_until_drained(self, max_iters: int = 10_000) -> List[Request]:
        """Step until every submitted request has completed."""
        for _ in range(max_iters):
            if not self.step() and not self.queue:
                return self.finished
        raise RuntimeError(f"engine not drained after {max_iters} "
                           f"iterations ({len(self.queue)} queued)")
