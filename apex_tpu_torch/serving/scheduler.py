"""Continuous-batching scheduler: admission, the per-step join of
prefills and decodes, eviction, per-request fault isolation and
end-to-end telemetry.

Counterpart of ``apex_tpu/serving/scheduler.py``. Every engine
:meth:`ContinuousBatcher.step`:

1. **Admits** queued requests against the KV pool, reusing published
   prompt-prefix blocks by reference (the prefix cache): the private
   remainder is reserved — the full span (prompt + max_new_tokens) for
   a short prompt, or staged chunk by chunk for a long one, with the
   decode span reserved together with the last chunk, so a request
   that reaches decoding can never run out of blocks. A request larger
   than the whole pool is rejected; a transiently full pool leaves it
   queued.
2. **Prefills** fresh short prompts as one batch, right-padded to its
   longest prompt, emitting each request's first token from the same
   call that writes its cache. Long or prefix-resumed prompts advance
   one chunk per step under the per-step ``prefill_token_budget``
   (chunked prefill), so a long prompt never stalls the step's decode.
3. **Decodes** every in-flight sequence as one batch — a finishing
   sequence's slot and blocks go to the next admission on the very
   next step.
4. **Finishes** sequences that reached ``max_new_tokens`` or their EOS
   and frees their blocks (shared prefix blocks stay in the prefix
   cache).

Every batch is padded only to its own largest prompt, chunk and block
table: the attention mask drops the padding, and eager PyTorch has no
compiled shapes to reuse, so the reference's power-of-two shape buckets
would only add work (:meth:`ContinuousBatcher.warmup` loads the kernel
libraries and library handles instead).

The fleet router (``serving/fleet.py``) reaches three hooks:
:meth:`ContinuousBatcher.take_queued` (the bounded hedge),
:meth:`ContinuousBatcher.take_prefilled` and
:meth:`ContinuousBatcher.install_prefilled` (the disaggregated KV
handoff).

The engine degrades per request, never per process:

- **deadlines**: ``Request.deadline_ms`` is a TTL from submission;
  expired requests (queued, prefilling or decoding) are reaped at the
  top of every step, before admission and decode, with outcome
  ``deadline_exceeded``;
- **quarantine**: a lane whose logits are not finite (``StepOut.finite``)
  finishes with outcome ``error`` while the rest of its batch keeps its
  tokens; a decode or chunk dispatch that raises is retried by binary
  split, so only the offending sequences bottom out as singletons. A
  quarantined sequence's blocks are zeroed before any reuse (the flash
  kernels multiply a masked slot's probability 0 by its V row, and
  0 × NaN is NaN);
- **preemption drain**: with a ``preemption`` handler, ``should_stop()``
  stops admission; with a ``snapshot_dir`` every queued and in-flight
  request goes into an atomic snapshot a fresh engine resumes from
  (``resilience.resume_requests``), without one in-flight work finishes
  and the queue is refused;
- **live weight swap**: ``resilience.swap_weights`` stages validated
  weights, installed here at the next step boundary.

Telemetry goes to the metrics registry (gauges per step, latency
histograms, outcome counters, structured events that double as flight
recorder triggers), the timeline (``prefill`` / ``prefill_chunk`` /
``decode`` spans, category ``serving``), an optional request tracer
(``serving.tracing``) and an optional SLO monitor (``telemetry.slo``),
whose latched alert sheds admission. The tracer and the SLO monitor
default to None and cost one attribute check per hook site.
``APEX_TPU_FAULTS`` drills every path (``resilience/faults.py``):
``serving_pool_exhausted``, ``decode_step_exception``,
``io:decode_step``, ``decode_nonfinite`` (+ ``decode_nonfinite_lane``),
``prefill_chunk_exception``, ``io:prefill_chunk``, ``sigterm``,
``serving_snapshot_corrupt`` and ``weight_swap_mismatch``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from apex_tpu_torch.resilience import faults
from apex_tpu_torch.serving.decode import DecodeStep, make_decode_step
from apex_tpu_torch.serving.kv_cache import (
    TRASH_BLOCK,
    KVCache,
    PoolExhausted,
    apply_copies,
    scrub_blocks,
)
from apex_tpu_torch.telemetry import flight as _flight
from apex_tpu_torch.telemetry import metrics as _metrics
from apex_tpu_torch.telemetry import timeline as _timeline
from apex_tpu_torch.telemetry.metrics import TOKEN_COUNT_BUCKETS


@dataclasses.dataclass
class Request:
    """One generation request. ``deadline_ms`` is a TTL from submission
    (None: no deadline): a request still queued, prefilling or decoding
    when it elapses finishes with outcome ``deadline_exceeded`` and the
    tokens generated so far.

    ``temperature == 0`` decodes greedily; ``temperature > 0`` draws
    from the softmax at that temperature, restricted to the top
    ``top_k`` logits (0: off) and the ``top_p`` nucleus (1.0: off),
    keyed on ``seed`` and each token's sequence index, so the stream is
    a pure function of ``(seed, index)`` (``decode.select_token``) and a
    drain/resume replays it.

    ``trace_id`` is the request plane's identity: None until the
    engine's tracer mints one at ``submit()``; a resumed drain snapshot
    carries the original id back, with ``resumed_from`` naming the
    snapshot."""

    id: Any
    prompt: Sequence[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    deadline_ms: Optional[float] = None
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    trace_id: Optional[str] = None
    resumed_from: Optional[str] = None

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).ravel()
        if len(self.prompt) < 1:
            raise ValueError(f"request {self.id!r}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"request {self.id!r}: max_new_tokens must be >= 1")
        if self.deadline_ms is not None and self.deadline_ms <= 0:
            raise ValueError(
                f"request {self.id!r}: deadline_ms must be > 0 or None")
        if self.temperature < 0:
            raise ValueError(
                f"request {self.id!r}: temperature must be >= 0")
        if self.top_k < 0:
            raise ValueError(f"request {self.id!r}: top_k must be >= 0")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(
                f"request {self.id!r}: top_p must be in (0, 1]")


@dataclasses.dataclass
class RequestResult:
    """A finished request: generated tokens and its latency (TTFT =
    submit -> first token; TPOT = mean inter-token interval after the
    first). ``finish_reason`` is ``length``, ``eos``, ``error`` or
    ``deadline_exceeded``.

    ``reason`` is the machine-readable code of every other than normal
    outcome (None for ``length`` / ``eos``): ``"draining"`` (refused by
    a draining engine, or queued when it drained without a snapshot),
    ``"oversized"`` (can never fit the pool), ``"deadline_queued"`` /
    ``"deadline_prefilling"`` / ``"deadline_in_flight"`` (the state the
    TTL elapsed in) and ``"quarantined"``."""

    id: Any
    tokens: List[int]
    ttft_s: Optional[float]
    tpot_s: Optional[float]
    finish_reason: str
    error: Optional[str] = None
    reason: Optional[str] = None


@dataclasses.dataclass
class _InFlight:
    req: Request
    seq_id: Any
    generated: List[int]
    t_submit: float
    t_first: Optional[float] = None
    t_last: Optional[float] = None
    # prompt tokens already in the cache (prefix-cache matches count);
    # a request is prefilling while prefilled < len(prompt)
    prefilled: int = 0
    stalls: int = 0

    @property
    def position(self) -> int:
        """0-based position of the next cache append: the last
        generated token's slot (the prompt is already cached)."""
        return len(self.req.prompt) + len(self.generated) - 1


class ContinuousBatcher:
    """The continuous-batching engine (module docstring).

    ``max_batch`` bounds in-flight sequences; ``max_prefill_batch``
    bounds how many admissions one step prefills together.
    ``prefill_chunk`` (None = monolithic prefill) is the chunk length
    for prompts longer than it; ``prefill_token_budget`` caps the chunk
    tokens one step may spend (default: a full chunk batch), and
    ``prefill_interval=k`` runs chunks only every k-th step while
    decodes are in flight.

    ``registry`` (default: the process-global one) and ``timeline``
    (default: the global timeline, disabled unless enabled) take the
    engine's telemetry; ``preemption`` (a ``PreemptionHandler``) and
    ``snapshot_dir`` arm the drain; ``tracer`` (a ``RequestTracer``) and
    ``slo`` (an ``SLOMonitor``) arm the request plane. ``model`` is the
    module whose weights ``resilience.swap_weights`` replaces."""

    def __init__(self, model, cache: KVCache, *,
                 max_batch: int = 8, max_prefill_batch: int = 4,
                 prefill_chunk: Optional[int] = None,
                 prefill_token_budget: Optional[int] = None,
                 prefill_interval: int = 1,
                 registry=None, timeline=None,
                 clock: Callable[[], float] = time.perf_counter,
                 step_fn: Optional[DecodeStep] = None,
                 preemption=None, snapshot_dir: Optional[str] = None,
                 tracer=None, slo=None):
        self.model = model
        self.cache = cache
        self.step_fn = (step_fn if step_fn is not None
                        else make_decode_step(model, cache))
        self.max_batch = int(max_batch)
        self.max_prefill_batch = int(max_prefill_batch)
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1 or None")
        self.prefill_chunk = (int(prefill_chunk)
                              if prefill_chunk is not None else None)
        self.prefill_token_budget = (
            int(prefill_token_budget) if prefill_token_budget is not None
            else (self.prefill_chunk * self.max_prefill_batch
                  if self.prefill_chunk else None))
        if prefill_interval < 1:
            raise ValueError("prefill_interval must be >= 1")
        self.prefill_interval = int(prefill_interval)
        self.clock = clock
        self._registry = (registry if registry is not None
                          else _metrics.registry())
        self._timeline = timeline
        # guards the queue, pool reservation, the finished list and the
        # staged weight swap (submit() may run on a client thread); the
        # in-flight lists and the cache pools belong to the engine thread
        self._lock = threading.Lock()
        self.queue: "deque[Tuple[Request, float]]" = deque()
        self.running: List[_InFlight] = []
        self.prefilling: List[_InFlight] = []
        self.finished: List[RequestResult] = []
        self.step_idx = 0
        self._seq_counter = 0
        self._chunk_dispatches = 0        # prefill_chunk_exception idx
        self._pending_copies: Dict[Any, List[Tuple[int, int, int]]] = {}
        self._pool_exhausted_dumped = False
        # resilience plane (serving/resilience.py)
        self.preemption = preemption
        self.snapshot_dir = snapshot_dir
        self.draining = False
        self.drained_snapshot: Optional[str] = None
        self._pending_swap = None             # (state dict, info) staged
        self._snapshot_count = 0
        self._swap_count = 0
        # request plane: both optional, one attribute check per hook site
        self.tracer = tracer
        self.slo = slo
        self._shed_active = False
        if slo is not None:
            slo.attach(
                trace_provider=(tracer.trace_dicts
                                if tracer is not None else None),
                introspect_provider=self.introspect)

    # -- telemetry helpers ---------------------------------------------------

    def _tl(self):
        if self._timeline is not None:
            return self._timeline
        return _timeline.get_timeline()

    def _publish_gauges(self) -> None:
        r = self._registry
        r.gauge("serving_queue_depth",
                "requests waiting for admission").set(len(self.queue))
        r.gauge("serving_batch_size",
                "in-flight sequences this engine step").set(
            len(self.running))
        r.gauge("serving_kv_blocks_in_use",
                "KV pool blocks held by in-flight sequences").set(
            self.cache.blocks_in_use)
        stats = self.cache.prefix_stats()
        r.gauge("serving_prefix_blocks_shared",
                "KV blocks referenced by >= 2 sequences").set(
            stats["shared_blocks"])
        r.gauge("serving_prefix_cached_blocks",
                "zero-ref prefix-cache blocks resident (reclaimable)"
                ).set(stats["cached_blocks"])
        r.gauge("serving_prefilling",
                "admitted sequences still prefilling (chunked)").set(
            len(self.prefilling))

    def _push_result(self, res: RequestResult) -> None:
        # every outcome lands here, so the request plane closes traces
        # and feeds the SLO window here
        tr = self.tracer
        if tr is not None and tr.enabled:
            tr.finish(res.id, res.finish_reason, t=self.clock(),
                      error=res.error)
        if self.slo is not None:
            self.slo.observe_request(
                res.id, ttft_s=res.ttft_s, tpot_s=res.tpot_s,
                ok=res.finish_reason in ("length", "eos"),
                t=self.clock())
        with self._lock:
            self.finished.append(res)

    def _finish(self, fl: _InFlight, reason: str,
                error: Optional[str] = None, *, dirty: bool = False,
                clean_blocks: Sequence[int] = (),
                reason_code: Optional[str] = None) -> None:
        self._pending_copies.pop(fl.seq_id, None)
        self.cache.free(fl.seq_id, dirty=dirty, clean_blocks=clean_blocks)
        n = len(fl.generated)
        ttft = (fl.t_first - fl.t_submit) if fl.t_first is not None else None
        tpot = None
        if n > 1 and fl.t_first is not None and fl.t_last is not None:
            tpot = (fl.t_last - fl.t_first) / (n - 1)
        r = self._registry
        r.counter("serving_requests",
                  "finished requests by outcome").inc(outcome=reason)
        r.counter("serving_tokens", "generated tokens").inc(n)
        if ttft is not None:
            r.histogram("serving_ttft_seconds",
                        "submit -> first generated token").observe(ttft)
        if tpot is not None:
            r.histogram("serving_tpot_seconds",
                        "mean inter-token interval after the first"
                        ).observe(tpot)
        self._push_result(RequestResult(
            id=fl.req.id, tokens=list(fl.generated), ttft_s=ttft,
            tpot_s=tpot, finish_reason=reason, error=error,
            reason=reason_code))

    def _reject(self, req: Request, msg: str, *,
                reason: str = "oversized") -> None:
        ev = self._registry.event("serving_request_error",
                                  request=str(req.id), error=msg,
                                  reason=reason)
        _flight.notify("serving_request_error",
                       error=RuntimeError(msg), fleet=False,
                       extra={"request": str(req.id), "reason": reason,
                              "event": ev})
        self._push_result(RequestResult(
            id=req.id, tokens=[], ttft_s=None, tpot_s=None,
            finish_reason="error", error=msg, reason=reason))

    # -- API -----------------------------------------------------------------

    def submit(self, request: Request) -> None:
        """Enqueue one request (thread-safe). A draining engine refuses
        it at once (outcome ``error``, reason ``draining``): its
        snapshot is committed, so a late request belongs to the resumed
        engine. With a tracer, the trace id is minted here (or
        continued, when a resumed snapshot set ``request.trace_id``)."""
        now = self.clock()
        tr = self.tracer
        if tr is not None and tr.enabled:
            request.trace_id = tr.begin(
                request.id, t_submit=now, trace_id=request.trace_id,
                resumed_from=request.resumed_from)
        if self.draining:
            self._push_result(RequestResult(
                id=request.id, tokens=[], ttft_s=None, tpot_s=None,
                finish_reason="error",
                error="engine draining (preemption): resubmit to the "
                      "resumed engine",
                reason="draining"))
            return
        with self._lock:
            self.queue.append((request, now))

    def warmup(self, state, seq_buckets: Optional[Sequence[int]] = None,
               width_buckets: Optional[Sequence[int]] = None,
               chunk_buckets: Optional[Sequence[int]] = None):
        """Load what the engine's first routed request would otherwise
        pay for, before it is routed to: one small prefill and one
        decode, every write landing in the pool's trash block, so the
        kernel libraries are loaded and the library handles (cuBLAS)
        made on this engine's device. The port has no shape buckets to
        compile (module docstring): the bucket arguments keep the
        reference's call shape, and any value but None is refused, as
        it could tune nothing. Returns ``state`` unchanged (the trash
        block is no sequence's)."""
        if (seq_buckets, width_buckets, chunk_buckets) != (None,) * 3:
            raise ValueError("warmup: the port compiles no shape buckets; "
                             "seq_buckets, width_buckets and chunk_buckets "
                             "take None only")
        s = min(self.cache.block_size, 8)
        trash = np.full((1, 1), TRASH_BLOCK, np.int32)
        self.step_fn.prefill(state, np.zeros((1, s), np.int32),
                             np.full((1,), s, np.int32), trash)
        out = self.step_fn.decode(state, np.zeros((1,), np.int32),
                                  np.zeros((1,), np.int32), trash)
        out.next_token.cpu()                  # waits for the device
        return state

    def take_queued(self, max_n: Optional[int] = None
                    ) -> List[Tuple[Request, float]]:
        """Withdraw up to ``max_n`` queued (not yet admitted) requests
        from the tail of the queue — newest first, so the oldest
        arrivals keep their admission order — as ``[(request,
        t_submit)]``. The engine forgets them (no result, no trace
        transition: the caller owns both now): the fleet router's
        bounded hedge moves work a stalled engine has not started;
        in-flight work stays put."""
        out: List[Tuple[Request, float]] = []
        with self._lock:
            while self.queue and (max_n is None or len(out) < max_n):
                out.append(self.queue.pop())
        return out

    # -- disaggregated handoff hooks (serving/fleet.py) ----------------------

    def take_prefilled(self, max_n: Optional[int] = None
                       ) -> List[_InFlight]:
        """Surrender up to ``max_n`` prefill-complete in-flight
        sequences (prompt cached, first token sampled): the prefill side
        of a disaggregated handoff. The engine forgets each request (no
        result, no trace transition) but its KV reservation stays
        allocated: the caller exports the blocks and then
        ``cache.free``-s the sequence, on success and on failure.
        Engine-thread only, like ``step``."""
        out: List[_InFlight] = []
        keep: List[_InFlight] = []
        for f in self.running:
            if ((max_n is None or len(out) < max_n)
                    and f.prefilled >= len(f.req.prompt)
                    and f.generated):
                out.append(f)
            else:
                keep.append(f)
        self.running = keep
        for f in out:
            self._pending_copies.pop(f.seq_id, None)
        return out

    def install_prefilled(self, state, req: Request,
                          generated: Sequence[int], k, v, *,
                          t_submit: float,
                          t_first: Optional[float] = None,
                          t_last: Optional[float] = None):
        """Adopt a handed-off, prefill-complete request: reserve its
        full decode span (prompt + max_new_tokens), install the
        already-verified KV payload into the fresh blocks
        (``KVCache.import_blocks``; verification is the caller's,
        before this call), publish the prompt blocks into the local
        prefix index and join ``running`` directly. ``t_submit`` /
        ``t_first`` / ``t_last`` are the source engine's, so TTFT and
        TPOT stay end to end. Raises ``PoolExhausted`` (reserving
        nothing) when the local pool cannot hold the span; returns the
        state. Engine-thread only, like ``step``."""
        total = len(req.prompt) + req.max_new_tokens
        with self._lock:
            self._seq_counter += 1
            seq_id = ("h", self._seq_counter, req.id)
        self.cache.allocate(seq_id, total)
        try:
            state = self.cache.import_blocks(state, seq_id, k, v)
        except Exception:
            self.cache.free(seq_id)
            raise
        fl = _InFlight(req=req, seq_id=seq_id,
                       generated=[int(t) for t in generated],
                       t_submit=t_submit, t_first=t_first,
                       t_last=(t_last if t_last is not None else t_first),
                       prefilled=len(req.prompt))
        self.running.append(fl)
        self.cache.publish_prefix(seq_id, req.prompt)
        tr = self.tracer
        if tr is not None and tr.enabled:
            tr.decoding(req.id)
        return state

    def idle(self) -> bool:
        with self._lock:
            return (not self.queue and not self.running
                    and not self.prefilling)

    def drain(self) -> List[RequestResult]:
        """Pop the results finished since the last call."""
        with self._lock:
            out, self.finished = self.finished, []
        return out

    def introspect(self) -> Dict[str, Any]:
        """One JSON-able view of the live engine: every queued,
        prefilling and decoding request (state, age, deadline headroom,
        block-table size, chunk progress, generated count, trace id),
        pool and prefix-cache occupancy, the SLO window summary and the
        tracer's. Host reads only — safe from any thread."""
        now = self.clock()
        with self._lock:
            queued = list(self.queue)
        prefilling = list(self.prefilling)
        running = list(self.running)

        def entry(req: Request, state: str, t_submit: float,
                  fl: Optional[_InFlight] = None) -> Dict[str, Any]:
            age = now - t_submit
            left = (req.deadline_ms - age * 1e3
                    if req.deadline_ms is not None else None)
            out = {"id": str(req.id), "trace_id": req.trace_id,
                   "state": state, "age_s": round(age, 6),
                   "deadline_ms": req.deadline_ms,
                   "deadline_left_ms": (round(left, 3)
                                        if left is not None else None),
                   "prompt_tokens": int(len(req.prompt)),
                   "max_new_tokens": int(req.max_new_tokens),
                   "prefilled": 0, "generated": 0, "blocks": 0}
            if fl is not None:
                out["prefilled"] = int(fl.prefilled)
                out["generated"] = len(fl.generated)
                try:
                    out["blocks"] = len(self.cache.table(fl.seq_id))
                except KeyError:
                    pass
            return out

        requests = ([entry(req, "queued", t) for req, t in queued]
                    + [entry(f.req, "prefilling", f.t_submit, f)
                       for f in prefilling]
                    + [entry(f.req, "decoding", f.t_submit, f)
                       for f in running])
        return {
            "step": self.step_idx,
            "draining": self.draining,
            "queue_depth": len(queued),
            "in_flight": len(running),
            "prefilling": len(prefilling),
            "requests": requests,
            "pool": {
                "num_blocks": self.cache.num_blocks,
                "block_size": self.cache.block_size,
                "blocks_in_use": self.cache.blocks_in_use,
                "free_blocks": self.cache.free_blocks,
                "prefix": self.cache.prefix_stats(),
            },
            "slo": (self.slo.summary()
                    if self.slo is not None else None),
            "traces": (self.tracer.summary()
                       if self.tracer is not None else None),
        }

    # -- resilience plane (serving/resilience.py) ----------------------------

    def _snapshot_entries(self) -> List[Dict[str, Any]]:
        """Every queued, prefilling and in-flight request as JSON-ready
        entries (the drain snapshot payload), in the order a resumed
        engine re-admits them: prompt, generated-so-far tokens, the
        admission knobs and the sampling knobs with the seed (a sampled
        stream is a pure function of ``(seed, token index)``)."""
        def entry(req: Request, generated: List[int],
                  state: str) -> Dict[str, Any]:
            return {"id": req.id,
                    "prompt": [int(t) for t in req.prompt],
                    "max_new_tokens": int(req.max_new_tokens),
                    "eos_id": req.eos_id,
                    "deadline_ms": req.deadline_ms,
                    "temperature": float(req.temperature),
                    "top_k": int(req.top_k),
                    "top_p": float(req.top_p),
                    "seed": int(req.seed),
                    "trace_id": req.trace_id,
                    "generated": generated, "state": state}

        out: List[Dict[str, Any]] = []
        with self._lock:
            queued = list(self.queue)
        for req, _ in queued:
            out.append(entry(req, [], "queued"))
        for f in self.prefilling:
            # no first token yet: the resumed engine re-prefills the
            # whole prompt (chunk progress is cache state, not tokens)
            out.append(entry(f.req, [], "prefilling"))
        for f in self.running:
            out.append(entry(f.req, [int(t) for t in f.generated],
                             "in_flight"))
        return out

    def _stage_params(self, params, info: Dict[str, Any]) -> None:
        """Stage a validated weight swap (``resilience.swap_weights``);
        it is installed at the top of the next step."""
        with self._lock:
            self._pending_swap = (params, info)

    def _install_pending_params(self, idx: int) -> None:
        with self._lock:
            pend, self._pending_swap = self._pending_swap, None
        if pend is None:
            return
        import torch

        params, info = pend
        with torch.no_grad():
            self.model.load_state_dict(params)    # copies in place
        r = self._registry
        r.counter("serving_weight_swaps",
                  "live weight hot-swaps installed").inc()
        r.event("serving_weight_swap", step=idx,
                old_digest=info["old_digest"],
                new_digest=info["new_digest"])

    def _reap_deadlines(self, idx: int, now: float) -> List[Any]:
        """Reap every queued, prefilling and in-flight request whose TTL
        elapsed — before admission, chunking and decode, so an expired
        request never buys a chunk or a decode slot. Returns the reaped
        ids."""
        def expired(req: Request, t_submit: float) -> bool:
            return (req.deadline_ms is not None
                    and (now - t_submit) * 1000.0 >= req.deadline_ms)

        expired_q: List[Tuple[Request, float]] = []
        with self._lock:
            if any(expired(req, t) for req, t in self.queue):
                keep: "deque[Tuple[Request, float]]" = deque()
                for req, t in self.queue:
                    (expired_q if expired(req, t) else keep).append(
                        (req, t))
                self.queue = keep
        expired_pre = [f for f in self.prefilling
                       if expired(f.req, f.t_submit)]
        expired_run = [f for f in self.running
                       if expired(f.req, f.t_submit)]
        if not expired_q and not expired_run and not expired_pre:
            return []
        r = self._registry
        ids: List[Any] = []
        for req, _ in expired_q:
            r.counter("serving_deadline_exceeded",
                      "requests reaped past their TTL").inc(where="queued")
            self._push_result(RequestResult(
                id=req.id, tokens=[], ttft_s=None, tpot_s=None,
                finish_reason="deadline_exceeded",
                error=f"deadline {req.deadline_ms:g}ms elapsed before "
                      "admission",
                reason="deadline_queued"))
            ids.append(req.id)
        if expired_pre:
            gone = {id(f) for f in expired_pre}
            self.prefilling = [f for f in self.prefilling
                               if id(f) not in gone]
            for f in expired_pre:
                r.counter("serving_deadline_exceeded",
                          "requests reaped past their TTL").inc(
                    where="prefilling")
                self._finish(f, "deadline_exceeded",
                             error=f"deadline {f.req.deadline_ms:g}ms "
                                   "elapsed mid-prefill",
                             reason_code="deadline_prefilling")
                ids.append(f.req.id)
        if expired_run:
            gone = {id(f) for f in expired_run}
            self.running = [f for f in self.running
                            if id(f) not in gone]
            for f in expired_run:
                r.counter("serving_deadline_exceeded",
                          "requests reaped past their TTL").inc(
                    where="in_flight")
                self._finish(f, "deadline_exceeded",
                             error=f"deadline {f.req.deadline_ms:g}ms "
                                   "elapsed mid-decode",
                             reason_code="deadline_in_flight")
                ids.append(f.req.id)
        # the event rides the flight recorder's ring; no bundle per
        # expiry (deadlines are routine)
        r.event("serving_deadline_exceeded", step=idx,
                requests=[str(i) for i in ids])
        return ids

    def _scrub_pending(self, state):
        """Zero the pool rows of dirty blocks whose refcount reached
        zero since the last step (quarantined tenants of shared
        blocks), then hand them back to the allocator — before
        admission can reuse them."""
        blocks = self.cache.take_pending_scrub()
        if not blocks:
            return state
        state = scrub_blocks(state, blocks)
        self.cache.scrub_done(blocks)
        self._registry.counter(
            "serving_blocks_scrubbed",
            "dirty blocks zeroed before reuse").inc(len(blocks))
        return state

    def _quarantine(self, state, quarantined, idx: int,
                    report: Dict[str, Any]):
        """Finish the named ``(flight, reason)`` pairs with outcome
        ``error`` while the rest of the engine keeps serving: counters,
        the ``serving_quarantine`` event and flight bundle.

        A non-finite lane wrote NaN K/V into its own blocks during the
        dispatch that exposed it, and the attention kernels multiply a
        masked slot's probability 0 by its V row (0 × NaN = NaN), so a
        freed block must never hand NaN to its next tenant. Blocks only
        this sequence references are zeroed here; its shared or
        published blocks are marked dirty — unpublished at once and
        zeroed when their refcount reaches zero (``_scrub_pending``)."""
        excl = sorted({b for f, _ in quarantined
                       for b in self.cache.exclusive_blocks(f.seq_id)})
        state = scrub_blocks(state, excl)
        r = self._registry
        ids = [str(f.req.id) for f, _ in quarantined]
        reasons = [msg for _, msg in quarantined]
        gone = {id(f) for f, _ in quarantined}
        self.running = [f for f in self.running if id(f) not in gone]
        self.prefilling = [f for f in self.prefilling
                           if id(f) not in gone]
        traced = self.tracer is not None and self.tracer.enabled
        for f, msg in quarantined:
            kind = ("nonfinite" if "nonfinite" in msg else "exception")
            r.counter("serving_quarantined",
                      "sequences quarantined by per-request fault "
                      "isolation").inc(reason=kind)
            if traced:
                self.tracer.mark(f.req.id, "quarantine", self.clock(),
                                 reason=msg, step=idx)
            self._finish(f, "error", error=f"quarantined: {msg}",
                         dirty=True, clean_blocks=excl,
                         reason_code="quarantined")
            report["finished"].append(f.req.id)
        report.setdefault("quarantined", []).extend(
            f.req.id for f, _ in quarantined)
        ev = r.event("serving_quarantine", step=idx, requests=ids,
                     reasons=reasons, in_flight=len(self.running))
        _flight.notify("serving_quarantine", fleet=False,
                       extra={"step": idx, "requests": ids,
                              "reasons": reasons, "event": ev})
        return state

    def _enter_drain(self, idx: int, report: Dict[str, Any]) -> None:
        """Flip to drain mode on a preemption flag: no admission ever
        again on this engine. With a ``snapshot_dir``, queued and
        in-flight work goes into an atomic snapshot (in-flight blocks
        free; a fresh engine resumes it); without one, or when the save
        fails, in-flight work decodes to completion and the queue is
        refused — nothing is dropped silently."""
        self.draining = True
        signum = getattr(self.preemption, "signum", None)
        n_queued = len(self.queue)
        n_running = len(self.running) + len(self.prefilling)
        path = None
        save_error: Optional[str] = None
        if self.snapshot_dir is not None:
            from apex_tpu_torch.serving import resilience as _sresil

            try:
                path = _sresil.save_snapshot(
                    self, self.snapshot_dir, step=idx,
                    reason=f"preemption (signal {signum})")
            except Exception as e:  # noqa: BLE001 — degrade, don't drop
                save_error = f"{type(e).__name__}: {str(e)[:200]}"
        if path is not None:
            self.drained_snapshot = path
            tr = self.tracer
            if tr is not None and tr.enabled:
                # every snapshotted trace ends here with outcome
                # `drained`; the resumed engine continues the same id
                t = self.clock()
                with self._lock:
                    queued_reqs = [req for req, _ in self.queue]
                for req in queued_reqs:
                    tr.drained(req.id, t, snapshot=path)
                for f in self.prefilling + self.running:
                    tr.drained(f.req.id, t, snapshot=path)
            for f in self.running:
                self.cache.free(f.seq_id)
            for f in self.prefilling:
                self.cache.free(f.seq_id)
            self.running = []
            self.prefilling = []
            self._pending_copies.clear()
            with self._lock:
                self.queue.clear()
        else:
            with self._lock:
                dropped, self.queue = list(self.queue), deque()
            for req, _ in dropped:
                self._reject(req, (
                    "preempted before admission and no drain snapshot "
                    + (f"(save failed: {save_error})" if save_error
                       else "(no snapshot_dir configured)")),
                    reason="draining")
        report["drained"] = True
        report["snapshot"] = path
        r = self._registry
        r.counter("serving_drains", "preemption drains entered").inc(
            mode="snapshot" if path is not None else "finish")
        ev = r.event("serving_drain", step=idx, signum=signum,
                     snapshot=path, save_error=save_error,
                     queued=n_queued, in_flight=n_running)
        _flight.notify("serving_drain", fleet=False,
                       extra={"step": idx, "snapshot": path,
                              "save_error": save_error,
                              "queued": n_queued,
                              "in_flight": n_running, "event": ev})

    # -- one engine step -----------------------------------------------------

    def _admit(self, exhausted: bool) -> Tuple[List[_InFlight],
                                               List[_InFlight]]:
        """Pop queued requests into the engine; returns ``(direct,
        chunked)``: ``direct`` prefill whole this step (a fresh short
        prompt), ``chunked`` enter the prefilling state (a long prompt
        under chunked prefill, or any prefix-cache resume). Nothing is
        admitted while draining, while a latched SLO alert sheds load,
        or (``exhausted``) under the pool-exhaustion drill."""
        if self.draining:
            return [], []
        if self.slo is not None and self.slo.should_shed():
            if self.queue:
                self._registry.counter(
                    "serving_slo_shed",
                    "admission passes shed by a latched SLO "
                    "burn-rate alert").inc()
                if not self._shed_active:
                    self._shed_active = True
                    self._registry.event("serving_slo_shed",
                                         slos=self.slo.alerting(),
                                         queued=len(self.queue))
            return [], []
        self._shed_active = False
        if any(f.stalls > 0 for f in self.prefilling):
            # a prefilling sequence waits on blocks: new admissions
            # would take the blocks it needs
            self._registry.counter(
                "serving_admission_deferred",
                "admissions deferred by a transiently full pool").inc()
            return [], []
        direct: List[_InFlight] = []
        chunked: List[_InFlight] = []
        rejects: List[Tuple[Request, str]] = []
        hits: List[int] = []
        deferred = False
        chunk = self.prefill_chunk
        with self._lock:
            while (self.queue
                   and (len(self.running) + len(self.prefilling)
                        + len(direct) + len(chunked) < self.max_batch)
                   and len(direct) + len(chunked) < self.max_prefill_batch):
                req, t_submit = self.queue[0]
                total = len(req.prompt) + req.max_new_tokens
                need = self.cache.blocks_for(total)
                if need > self.cache.num_blocks:
                    self.queue.popleft()
                    rejects.append((req, (
                        f"request needs {need} KV blocks, pool capacity "
                        f"is {self.cache.num_blocks} — can never be "
                        "admitted")))
                    continue
                if exhausted:
                    break                    # shed load: stay queued
                try:
                    self._seq_counter += 1
                    seq_id = ("s", self._seq_counter, req.id)
                    match = self.cache.allocate_prefix(
                        seq_id, req.prompt, total_len=total, chunk=chunk)
                except PoolExhausted:
                    self._seq_counter -= 1
                    deferred = True
                    break                    # wait for blocks to free
                self.queue.popleft()
                fl = _InFlight(req=req, seq_id=seq_id, generated=[],
                               t_submit=t_submit, prefilled=match.matched)
                hits.append(1 if match.matched > 0 else 0)
                if match.copies:
                    self._pending_copies[seq_id] = list(match.copies)
                if (match.matched == 0
                        and (chunk is None or len(req.prompt) <= chunk)):
                    direct.append(fl)
                else:
                    chunked.append(fl)
        if deferred:
            self._registry.counter(
                "serving_admission_deferred",
                "admissions deferred by a transiently full pool").inc()
        if hits:
            c = self._registry.counter(
                "serving_prefix_cache_hits",
                "admissions by prompt-prefix cache outcome")
            n_hit = sum(hits)
            if n_hit:
                c.inc(n_hit, outcome="hit")
            if len(hits) - n_hit:
                c.inc(len(hits) - n_hit, outcome="miss")
        for req, msg in rejects:
            self._reject(req, msg)
        tr = self.tracer
        if tr is not None and tr.enabled and (direct or chunked):
            now = self.clock()
            for fl in direct:
                tr.admitted(fl.req.id, now, mode="direct",
                            matched=fl.prefilled)
            for fl in chunked:
                tr.admitted(fl.req.id, now, mode="chunked",
                            matched=fl.prefilled)
        return direct, chunked

    def _tables_for(self, seq_ids: List[Any]) -> np.ndarray:
        width = max(len(self.cache.table(sid)) for sid in seq_ids)
        return self.cache.table_array(seq_ids, width)

    @staticmethod
    def _sampling_for(flights: List[_InFlight]):
        """Per-lane ``(temperatures, top_ks, top_ps, seeds)`` (the
        reference's ``_sampling_for`` :1070)."""
        return (np.array([f.req.temperature for f in flights], np.float32),
                np.array([f.req.top_k for f in flights], np.int32),
                np.array([f.req.top_p for f in flights], np.float32),
                np.array([f.req.seed & 0xFFFFFFFF for f in flights],
                         np.uint32))

    def _prefill(self, admitted: List[_InFlight], state):
        """Prefill the admissions as one batch; returns ``(state,
        finite)``, ``finite[i]`` lane ``i``'s all-finite flag. Only a
        finite lane gets its first token; the caller quarantines the
        others before they join ``running``."""
        b = len(admitted)
        s = max(len(f.req.prompt) for f in admitted)
        tokens = np.zeros((b, s), np.int32)
        lengths = np.zeros((b,), np.int32)
        for i, f in enumerate(admitted):
            tokens[i, :len(f.req.prompt)] = f.req.prompt
            lengths[i] = len(f.req.prompt)
        tables = self._tables_for([f.seq_id for f in admitted])
        t0 = self.clock()
        with self._tl().phase("prefill", category="serving"):
            out = self.step_fn.prefill(state, tokens, lengths, tables,
                                       self._sampling_for(admitted))
            ids = out.next_token.cpu().numpy()   # waits for the device
        now = self.clock()
        finite = out.finite.cpu().numpy()
        tr = self.tracer
        traced = tr is not None and tr.enabled
        for i, f in enumerate(admitted):
            if traced:
                tr.span(f.req.id, "prefill", t0, now - t0,
                        tokens=len(f.req.prompt))
            if finite[i]:
                f.generated.append(int(ids[i]))
                f.prefilled = len(f.req.prompt)
                f.t_first = f.t_last = now
                self.cache.publish_prefix(f.seq_id, f.req.prompt)
                if traced:
                    tr.mark(f.req.id, "first_token", now)
        return out.cache, finite

    # -- chunked prefill -----------------------------------------------------

    def _chunk_batch(self, state, batchees, cidx: int, s: int, width: int):
        """One chunk-prefill dispatch over ``batchees`` = ``[(flight,
        chunk_len)]``, padded to the top-level dispatch's ``s`` and
        ``width``; returns ``(state, token_ids, finite, now)``. The
        fault sites raise before the dispatch: ``prefill_chunk_exception``
        checks the top-level index ``cidx`` (every split retry fails
        too), ``io:prefill_chunk`` counts calls (one transient index is
        absorbed by the retry)."""
        b = len(batchees)
        tokens = np.zeros((b, s), np.int32)
        starts = np.zeros((b,), np.int32)
        lengths = np.zeros((b,), np.int32)
        for i, (f, cs) in enumerate(batchees):
            tokens[i, :cs] = f.req.prompt[f.prefilled:f.prefilled + cs]
            starts[i] = f.prefilled
            lengths[i] = cs
        tables = self.cache.table_array([f.seq_id for f, _ in batchees],
                                        width)
        with self._tl().phase("prefill_chunk", category="serving"):
            faults.maybe_prefill_chunk_exception(cidx)
            faults.check("prefill_chunk")
            out = self.step_fn.prefill_chunk(
                state, tokens, starts, lengths, tables,
                self._sampling_for([f for f, _ in batchees]))
            ids = out.next_token.cpu().numpy()
        now = self.clock()
        return out.cache, ids, out.finite.cpu().numpy(), now

    def _split_retry(self, state, items, dispatch, site: str,
                     nonfinite_msg: str, flight=lambda it: it):
        """Run ``dispatch(state, items)`` with per-request fault
        isolation; returns ``(state, done, quarantined)``, ``done``
        ``[(item, token, t)]``, ``quarantined`` ``[(flight, msg)]``
        (``flight(item)`` names an item's request). A dispatch that
        raises is retried by binary split (each half its own dispatch),
        offenders bottoming out as singletons; non-finite logits need
        no split: the per-lane finite flag names them."""
        try:
            state, ids, finite, now = dispatch(state, items)
        except Exception as e:  # noqa: BLE001 — isolate, keep serving
            if len(items) == 1:
                msg = f"{type(e).__name__}: {str(e)[:200]}"
                return state, [], [(flight(items[0]), msg)]
            if self.tracer is not None and self.tracer.enabled:
                t = self.clock()
                for it in items:
                    self.tracer.mark(flight(it).req.id, "retry_split", t,
                                     batch=len(items), site=site)
            mid = len(items) // 2
            state, d_lo, q_lo = self._split_retry(
                state, items[:mid], dispatch, site, nonfinite_msg, flight)
            state, d_hi, q_hi = self._split_retry(
                state, items[mid:], dispatch, site, nonfinite_msg, flight)
            return state, d_lo + d_hi, q_lo + q_hi
        done, quarantined = [], []
        for i, it in enumerate(items):
            if finite[i]:
                done.append((it, int(ids[i]), now))
            else:
                quarantined.append((flight(it), nonfinite_msg))
        return state, done, quarantined

    def _prefill_chunks(self, state, idx: int, report: Dict[str, Any]):
        """Advance the prefilling sequences by one chunk each under the
        per-step token budget. Each chunk extends the block table just
        in time, and the final chunk reserves the decode span. A
        sequence that cannot extend stalls in place; if nothing is
        decoding (so no block will ever free), the first stalled
        sequence goes back to the head of the queue."""
        if (self.prefill_interval > 1 and self.running
                and idx % self.prefill_interval):
            return state                       # a decode-only step
        chunk = self.prefill_chunk
        budget = self.prefill_token_budget
        r = self._registry
        batchees: List[Tuple[_InFlight, int]] = []
        stalled: List[_InFlight] = []
        used = 0
        for f in self.prefilling:
            if len(batchees) >= self.max_prefill_batch:
                break
            rem = len(f.req.prompt) - f.prefilled
            cs = rem if chunk is None else min(rem, chunk)
            if budget is not None and batchees and used + cs > budget:
                break
            final = f.prefilled + cs >= len(f.req.prompt)
            target = (len(f.req.prompt) + f.req.max_new_tokens
                      if final else f.prefilled + cs)
            try:
                self.cache.extend(f.seq_id, target)
            except PoolExhausted:
                f.stalls += 1
                stalled.append(f)
                r.counter("serving_prefill_stalled",
                          "chunk reservations deferred by a full "
                          "pool").inc()
                if (f.stalls == 1 and self.tracer is not None
                        and self.tracer.enabled):
                    self.tracer.mark(f.req.id, "prefill_stalled",
                                     prefilled=f.prefilled)
                continue
            f.stalls = 0
            batchees.append((f, cs))
            used += cs
        if not batchees:
            if stalled and not self.running:
                f = stalled[0]
                self.prefilling.remove(f)
                self._pending_copies.pop(f.seq_id, None)
                self.cache.free(f.seq_id)
                with self._lock:
                    self.queue.appendleft((f.req, f.t_submit))
                r.counter("serving_prefill_requeued",
                          "prefilling sequences returned to the queue "
                          "to break a reservation deadlock").inc()
                r.event("serving_prefill_requeued", step=idx,
                        request=str(f.req.id), prefilled=f.prefilled)
                if self.tracer is not None and self.tracer.enabled:
                    self.tracer.requeued(f.req.id, self.clock())
            return state
        # pending copy-on-write forks land before the chunk gathers
        copies: List[Tuple[int, int, int]] = []
        for f, _ in batchees:
            copies.extend(self._pending_copies.pop(f.seq_id, ()))
        if copies:
            state = apply_copies(state, copies)
            for f, _ in batchees:
                self.cache.fork_copied(f.seq_id)
        cidx = self._chunk_dispatches
        self._chunk_dispatches += 1
        s = max(cs for _, cs in batchees)
        width = max(len(self.cache.table(f.seq_id)) for f, _ in batchees)
        t0 = self.clock()
        state, done, quarantined = self._split_retry(
            state, batchees,
            lambda st, bs: self._chunk_batch(st, bs, cidx, s, width),
            "prefill_chunk", "nonfinite logits (prefill chunk)",
            flight=lambda b: b[0])
        t1 = self.clock()
        tr = self.tracer
        traced = tr is not None and tr.enabled
        now_done: List[_InFlight] = []
        for (f, cs), tok, now in done:
            f.prefilled += cs
            r.counter("serving_prefill_chunks",
                      "prefill chunks dispatched").inc()
            r.histogram("serving_prefill_chunk_tokens",
                        "prompt tokens per prefill chunk",
                        buckets=TOKEN_COUNT_BUCKETS).observe(cs)
            report["prefilled"].append(f.req.id)
            if traced:
                tr.chunk_span(f.req.id, t0, t1 - t0, tokens=cs)
            if f.prefilled >= len(f.req.prompt):
                f.generated.append(tok)
                f.t_first = f.t_last = now
                now_done.append(f)
                self.cache.publish_prefix(f.seq_id, f.req.prompt)
                if traced:
                    tr.mark(f.req.id, "first_token", now)
                    tr.decoding(f.req.id)
        if now_done:
            gone = {id(f) for f in now_done}
            self.prefilling = [f for f in self.prefilling
                               if id(f) not in gone]
            self.running.extend(now_done)
        if quarantined:
            state = self._quarantine(state, quarantined, idx, report)
        return state

    # -- decode --------------------------------------------------------------

    def _decode_batch(self, state, flights: List[_InFlight], idx: int,
                      width: int):
        """One decode dispatch over ``flights`` at the step's table
        ``width``; returns ``(state, token_ids, finite, now)``. The
        fault sites raise before the dispatch, so the split retries
        pass them again: step-indexed clauses fail every sub-dispatch,
        call-indexed ``io:decode_step`` faults are absorbed."""
        b = len(flights)
        tokens = np.zeros((b,), np.int32)
        positions = np.zeros((b,), np.int32)
        for i, f in enumerate(flights):
            tokens[i] = f.generated[-1]
            positions[i] = f.position
        tables = self.cache.table_array([f.seq_id for f in flights], width)
        with self._tl().phase("decode", category="serving"):
            faults.maybe_decode_exception(idx)
            faults.check("decode_step")
            out = self.step_fn.decode(state, tokens, positions, tables,
                                      self._sampling_for(flights))
            ids = out.next_token.cpu().numpy()
        now = self.clock()
        return out.cache, ids, out.finite.cpu().numpy(), now

    def _reap(self) -> List[Any]:
        done, keep = [], []
        for f in self.running:
            if (f.req.eos_id is not None
                    and f.generated[-1] == f.req.eos_id):
                self._finish(f, "eos")
                done.append(f.req.id)
            elif len(f.generated) >= f.req.max_new_tokens:
                self._finish(f, "length")
                done.append(f.req.id)
            else:
                keep.append(f)
        self.running = keep
        return done

    def step(self, state) -> Tuple[Any, Dict[str, Any]]:
        """One engine iteration over the cache ``state``; returns
        ``(state, report)``: the admitted / prefilled / decoded /
        finished / expired request ids, ``quarantined`` when any was,
        ``drained`` and ``snapshot`` on a drain, the queue length and
        the blocks in use.

        The order is the reference's: a staged weight swap installs
        first, then the sigterm drill, the deadline reap, the drain,
        the pending scrubs, the pool-exhaustion drill, admission (with
        the SLO shed), prefill, chunks, a reap, the non-finite drill,
        the isolated decode, a reap, the gauges and the SLO tick."""
        idx = self.step_idx
        self.step_idx += 1
        self._install_pending_params(idx)
        faults.maybe_sigterm(idx)
        report: Dict[str, Any] = {
            "step": idx,
            "admitted": [],
            "prefilled": [],
            "decoded": [],
            "finished": [],
            "expired": self._reap_deadlines(idx, self.clock()),
        }
        if (not self.draining and self.preemption is not None
                and self.preemption.should_stop()):
            self._enter_drain(idx, report)
            if self.drained_snapshot is not None:
                # queued and in-flight work is in the snapshot
                report["queued"] = 0
                report["blocks_in_use"] = self.cache.blocks_in_use
                self._publish_gauges()
                return state, report
        state = self._scrub_pending(state)
        exhausted = faults.should_pool_exhaust(idx)
        if exhausted:
            self._registry.event("serving_pool_exhausted", step=idx,
                                 injected=True,
                                 queued=len(self.queue),
                                 in_flight=len(self.running))
            if not self._pool_exhausted_dumped:
                self._pool_exhausted_dumped = True
                _flight.notify(
                    "serving_pool_exhausted", fleet=False,
                    extra={"step": idx, "queued": len(self.queue),
                           "blocks_in_use": self.cache.blocks_in_use,
                           "prefix_cache": self.cache.prefix_stats()})
        direct, chunked = self._admit(exhausted)
        report["admitted"] = [f.req.id for f in direct + chunked]
        report["queued"] = len(self.queue)
        self.prefilling.extend(chunked)
        if direct:
            state, finite = self._prefill(direct, state)
            self.running.extend(f for i, f in enumerate(direct)
                                if finite[i])
            bad = [(f, "nonfinite logits (prefill)")
                   for i, f in enumerate(direct) if not finite[i]]
            if bad:
                state = self._quarantine(state, bad, idx, report)
        if self.prefilling:
            state = self._prefill_chunks(state, idx, report)
        # a request whose first token already ended it buys no decode
        report["finished"].extend(self._reap())
        if self.running:
            width = max(len(self.cache.table(f.seq_id))
                        for f in self.running)
            lane = faults.nonfinite_lane_at(idx)
            if lane is not None and lane < len(self.running):
                from apex_tpu_torch.serving import resilience as _sresil

                f = self.running[lane]
                state = _sresil.poison_lane_kv(
                    state, self.cache, f.seq_id, f.position - 1)
            t0 = self.clock()
            state, accepted, quarantined = self._split_retry(
                state, self.running,
                lambda st, fs: self._decode_batch(st, fs, idx, width),
                "decode", "nonfinite logits")
            tr = self.tracer
            traced = tr is not None and tr.enabled
            for f, tok, now in accepted:
                f.generated.append(tok)
                f.t_last = now
                if traced:
                    tr.decode_tick(f.req.id, t0, now)
            report["decoded"] = [f.req.id for f, _, _ in accepted]
            if quarantined:
                state = self._quarantine(state, quarantined, idx,
                                         report)
        report["finished"].extend(self._reap())
        report["blocks_in_use"] = self.cache.blocks_in_use
        self._publish_gauges()
        if self.slo is not None:
            now = self.clock()
            self.slo.observe("queue_depth", float(report["queued"]),
                             t=now)
            self.slo.tick(now=now, step=idx)
        return state, report


def serve_loop(batcher: ContinuousBatcher, state, requests:
               Sequence[Request], *,
               arrivals: Optional[Sequence[float]] = None,
               clock: Callable[[], float] = time.perf_counter,
               sleep: Callable[[float], None] = time.sleep):
    """Drive ``batcher`` over an arrival schedule (seconds from the
    start; default all at 0) until every request finishes; returns
    ``(state, results)``. A draining engine ends the loop early: the
    arrivals not yet submitted stay with the caller, and the loop
    returns once the in-flight work is finished or snapshotted
    (``batcher.drained_snapshot`` names the snapshot)."""
    order = sorted(range(len(requests)),
                   key=lambda i: arrivals[i] if arrivals else 0.0)
    t0 = clock()
    results: List[RequestResult] = []
    i = 0
    while i < len(order) or not batcher.idle():
        if (batcher.draining and not batcher.running
                and not batcher.prefilling):
            break
        now = clock() - t0
        while (i < len(order) and not batcher.draining
               and (not arrivals or arrivals[order[i]] <= now)):
            batcher.submit(requests[order[i]])
            i += 1
        if batcher.idle():
            if batcher.draining:
                break
            if i < len(order):
                sleep(max(0.0, min(arrivals[order[i]] - now, 0.001)))
            continue
        state, _ = batcher.step(state)
        results.extend(batcher.drain())
    results.extend(batcher.drain())
    return state, results


def static_batch_generate(model, cache: KVCache, state,
                          requests: Sequence[Request], *,
                          batch_size: int = 8,
                          arrivals: Optional[Sequence[float]] = None,
                          clock: Callable[[], float] = time.perf_counter,
                          sleep: Callable[[float], None] = time.sleep,
                          step_fn: Optional[DecodeStep] = None):
    """The static-batch baseline: fixed batches in arrival order, each
    run to its slowest member's last token before the next starts. Same
    steps and cache as the engine; only the scheduling differs. Returns
    ``(state, results)``."""
    step = step_fn if step_fn is not None else make_decode_step(model,
                                                                cache)
    t0 = clock()
    results: List[RequestResult] = []
    pending = list(requests)
    submit_at = list(arrivals) if arrivals else [0.0] * len(pending)
    pos = 0
    while pos < len(pending):
        batch = pending[pos:pos + batch_size]
        t_sub = submit_at[pos:pos + batch_size]
        pos += len(batch)
        wait = max(t_sub) - (clock() - t0)
        if wait > 0:
            sleep(wait)
        seqs = []
        for j, req in enumerate(batch):
            sid = ("static", pos, j)
            cache.allocate(sid, len(req.prompt) + req.max_new_tokens)
            seqs.append(sid)
        b = len(batch)
        s = max(len(r.prompt) for r in batch)
        w = max(len(cache.table(sid)) for sid in seqs)
        tokens = np.zeros((b, s), np.int32)
        lengths = np.zeros((b,), np.int32)
        for j, req in enumerate(batch):
            tokens[j, :len(req.prompt)] = req.prompt
            lengths[j] = len(req.prompt)
        tables = cache.table_array(seqs, w)
        out = step.prefill(state, tokens, lengths, tables)
        gen = [[int(t)] for t in out.next_token.cpu().numpy()]
        now = clock()
        state = out.cache
        t_first = [now] * len(batch)
        t_last = [now] * len(batch)
        for _ in range(max(r.max_new_tokens for r in batch) - 1):
            toks = np.zeros((b,), np.int32)
            poss = np.zeros((b,), np.int32)
            for j, req in enumerate(batch):
                toks[j] = gen[j][-1]
                poss[j] = len(req.prompt) + len(gen[j]) - 1
            out = step.decode(state, toks, poss, tables)
            ids = out.next_token.cpu().numpy()
            now = clock()
            state = out.cache
            for j, req in enumerate(batch):
                if len(gen[j]) < req.max_new_tokens:
                    gen[j].append(int(ids[j]))
                    t_last[j] = now
        for j, req in enumerate(batch):
            n = len(gen[j])
            ttft = t_first[j] - (t0 + t_sub[j])
            tpot = ((t_last[j] - t_first[j]) / (n - 1)) if n > 1 else None
            results.append(RequestResult(
                id=req.id, tokens=gen[j], ttft_s=ttft, tpot_s=tpot,
                finish_reason="length"))
            cache.free(seqs[j])
    return state, results


__all__ = ["ContinuousBatcher", "Request", "RequestResult", "serve_loop",
           "static_batch_generate"]
