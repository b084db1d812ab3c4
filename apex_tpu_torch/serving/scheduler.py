"""Continuous-batching scheduler: admission, the per-step join of
prefills and decodes, and eviction.

Counterpart of the core of ``apex_tpu/serving/scheduler.py``
(:128-1644). Every engine :meth:`ContinuousBatcher.step`:

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
   call that writes its cache. Long or
   prefix-resumed prompts advance one chunk per step under the
   per-step ``prefill_token_budget`` (chunked prefill), so a long
   prompt never stalls the step's decode.
3. **Decodes** every in-flight sequence as one batch — a finishing
   sequence's slot and blocks go to the next admission on the very next
   step.

Every batch is padded only to its own largest prompt, chunk and block
table: the attention mask drops the padding, and eager PyTorch has no
compiled shapes to reuse, so the reference's power-of-two shape buckets
would only add work.
4. **Finishes** sequences that reached ``max_new_tokens`` or their EOS
   and frees their blocks (shared prefix blocks stay in the prefix
   cache).

The reference's resilience and observability planes are not ported
yet: deadlines, per-request quarantine and fault isolation, preemption
drain snapshots, live weight swap, the request tracer, SLO monitoring,
the metrics registry and timeline hooks, and the fleet handoff hooks.
Their constructor arguments are absent. A lane whose logits are not
finite therefore raises instead of being quarantined.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from apex_tpu_torch.serving.decode import DecodeStep, make_decode_step
from apex_tpu_torch.serving.kv_cache import (
    KVCache,
    PoolExhausted,
    apply_copies,
)


@dataclasses.dataclass
class Request:
    """One generation request. ``temperature == 0`` decodes greedily;
    ``temperature > 0`` draws from the softmax at that temperature,
    restricted to the top ``top_k`` logits (0: off) and the ``top_p``
    nucleus (1.0: off), keyed on ``seed`` and each token's sequence
    index, so the stream is a pure function of ``(seed, index)``
    (``decode.select_token``)."""

    id: Any
    prompt: Sequence[int]
    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).ravel()
        if len(self.prompt) < 1:
            raise ValueError(f"request {self.id!r}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"request {self.id!r}: max_new_tokens must be >= 1")
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
    first). ``finish_reason`` is ``length``, ``eos`` or ``error``;
    ``reason`` is ``"oversized"`` for a request that can never fit the
    pool, None otherwise."""

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
    decodes are in flight."""

    def __init__(self, model, cache: KVCache, *,
                 max_batch: int = 8, max_prefill_batch: int = 4,
                 prefill_chunk: Optional[int] = None,
                 prefill_token_budget: Optional[int] = None,
                 prefill_interval: int = 1,
                 clock: Callable[[], float] = time.perf_counter,
                 step_fn: Optional[DecodeStep] = None):
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
        # guards the queue, pool reservation and the finished list
        # (submit() may run on a client thread); the in-flight lists and
        # the cache pools belong to the engine thread
        self._lock = threading.Lock()
        self.queue: "deque[Tuple[Request, float]]" = deque()
        self.running: List[_InFlight] = []
        self.prefilling: List[_InFlight] = []
        self.finished: List[RequestResult] = []
        self.step_idx = 0
        self._seq_counter = 0
        self._pending_copies: Dict[Any, List[Tuple[int, int, int]]] = {}

    # -- results -------------------------------------------------------------

    def _finish(self, fl: _InFlight, reason: str) -> None:
        self._pending_copies.pop(fl.seq_id, None)
        self.cache.free(fl.seq_id)
        n = len(fl.generated)
        ttft = (fl.t_first - fl.t_submit) if fl.t_first is not None else None
        tpot = None
        if n > 1 and fl.t_first is not None and fl.t_last is not None:
            tpot = (fl.t_last - fl.t_first) / (n - 1)
        with self._lock:
            self.finished.append(RequestResult(
                id=fl.req.id, tokens=list(fl.generated), ttft_s=ttft,
                tpot_s=tpot, finish_reason=reason))

    # -- API -----------------------------------------------------------------

    def submit(self, request: Request) -> None:
        """Enqueue one request (thread-safe)."""
        now = self.clock()
        with self._lock:
            self.queue.append((request, now))

    def idle(self) -> bool:
        with self._lock:
            return (not self.queue and not self.running
                    and not self.prefilling)

    def drain(self) -> List[RequestResult]:
        """Pop the results finished since the last call."""
        with self._lock:
            out, self.finished = self.finished, []
        return out

    # -- one engine step -----------------------------------------------------

    def _admit(self) -> Tuple[List[_InFlight], List[_InFlight]]:
        """Pop queued requests into the engine; returns ``(direct,
        chunked)``: ``direct`` prefill whole this step (a fresh short
        prompt), ``chunked`` enter the prefilling state (a long prompt
        under chunked prefill, or any prefix-cache resume)."""
        if any(f.stalls > 0 for f in self.prefilling):
            # a prefilling sequence waits on blocks: new admissions
            # would take the blocks it needs
            return [], []
        direct: List[_InFlight] = []
        chunked: List[_InFlight] = []
        rejects: List[Tuple[Request, str]] = []
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
                try:
                    self._seq_counter += 1
                    seq_id = ("s", self._seq_counter, req.id)
                    match = self.cache.allocate_prefix(
                        seq_id, req.prompt, total_len=total, chunk=chunk)
                except PoolExhausted:
                    self._seq_counter -= 1
                    break                    # wait for blocks to free
                self.queue.popleft()
                fl = _InFlight(req=req, seq_id=seq_id, generated=[],
                               t_submit=t_submit, prefilled=match.matched)
                if match.copies:
                    self._pending_copies[seq_id] = list(match.copies)
                if (match.matched == 0
                        and (chunk is None or len(req.prompt) <= chunk)):
                    direct.append(fl)
                else:
                    chunked.append(fl)
            for req, msg in rejects:
                self.finished.append(RequestResult(
                    id=req.id, tokens=[], ttft_s=None, tpot_s=None,
                    finish_reason="error", error=msg, reason="oversized"))
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

    @staticmethod
    def _check_finite(out, flights: List[_InFlight], where: str) -> None:
        finite = out.finite[:len(flights)].cpu().numpy()
        if not finite.all():
            bad = [str(f.req.id) for i, f in enumerate(flights)
                   if not finite[i]]
            raise FloatingPointError(
                f"non-finite logits in {where} for request(s) "
                f"{', '.join(bad)}")

    def _prefill(self, admitted: List[_InFlight], state):
        """Prefill the admissions as one batch and record each one's
        first token."""
        b = len(admitted)
        s = max(len(f.req.prompt) for f in admitted)
        tokens = np.zeros((b, s), np.int32)
        lengths = np.zeros((b,), np.int32)
        for i, f in enumerate(admitted):
            tokens[i, :len(f.req.prompt)] = f.req.prompt
            lengths[i] = len(f.req.prompt)
        tables = self._tables_for([f.seq_id for f in admitted])
        out = self.step_fn.prefill(state, tokens, lengths, tables,
                                   self._sampling_for(admitted))
        ids = out.next_token.cpu().numpy()       # waits for the device
        now = self.clock()
        self._check_finite(out, admitted, "prefill")
        for i, f in enumerate(admitted):
            f.generated.append(int(ids[i]))
            f.prefilled = len(f.req.prompt)
            f.t_first = f.t_last = now
            self.cache.publish_prefix(f.seq_id, f.req.prompt)
        return out.cache

    def _prefill_chunks(self, state, idx: int, report: Dict[str, Any]):
        """Advance the prefilling sequences by one chunk each
        under the per-step token budget. Each chunk extends the block
        table just in time, and the final chunk reserves the decode
        span. A sequence that cannot extend stalls in place; if nothing
        is decoding (so no block will ever free), the first stalled
        sequence goes back to the head of the queue."""
        if (self.prefill_interval > 1 and self.running
                and idx % self.prefill_interval):
            return state                       # a decode-only step
        chunk = self.prefill_chunk
        budget = self.prefill_token_budget
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
            return state
        # pending copy-on-write forks land before the chunk gathers
        copies: List[Tuple[int, int, int]] = []
        for f, _ in batchees:
            copies.extend(self._pending_copies.pop(f.seq_id, ()))
        if copies:
            state = apply_copies(state, copies)
            for f, _ in batchees:
                self.cache.fork_copied(f.seq_id)
        b = len(batchees)
        s = max(cs for _, cs in batchees)
        tokens = np.zeros((b, s), np.int32)
        starts = np.zeros((b,), np.int32)
        lengths = np.zeros((b,), np.int32)
        for i, (f, cs) in enumerate(batchees):
            tokens[i, :cs] = f.req.prompt[f.prefilled:f.prefilled + cs]
            starts[i] = f.prefilled
            lengths[i] = cs
        tables = self._tables_for([f.seq_id for f, _ in batchees])
        out = self.step_fn.prefill_chunk(
            state, tokens, starts, lengths, tables,
            self._sampling_for([f for f, _ in batchees]))
        ids = out.next_token.cpu().numpy()
        now = self.clock()
        flights = [f for f, _ in batchees]
        self._check_finite(out, flights, "prefill_chunk")
        done: List[_InFlight] = []
        for i, (f, cs) in enumerate(batchees):
            f.prefilled += cs
            report["prefilled"].append(f.req.id)
            if f.prefilled >= len(f.req.prompt):
                f.generated.append(int(ids[i]))
                f.t_first = f.t_last = now
                done.append(f)
                self.cache.publish_prefix(f.seq_id, f.req.prompt)
        if done:
            gone = {id(f) for f in done}
            self.prefilling = [f for f in self.prefilling
                               if id(f) not in gone]
            self.running.extend(done)
        return out.cache

    def _decode(self, state):
        """One decode call over every running sequence; appends each
        sequence's next token."""
        flights = self.running
        b = len(flights)
        tokens = np.zeros((b,), np.int32)
        positions = np.zeros((b,), np.int32)
        for i, f in enumerate(flights):
            tokens[i] = f.generated[-1]
            positions[i] = f.position
        tables = self._tables_for([f.seq_id for f in flights])
        out = self.step_fn.decode(state, tokens, positions, tables,
                                  self._sampling_for(flights))
        ids = out.next_token.cpu().numpy()
        now = self.clock()
        self._check_finite(out, flights, "decode")
        for i, f in enumerate(flights):
            f.generated.append(int(ids[i]))
            f.t_last = now
        return out.cache

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
        ``(state, report)`` with the admitted / prefilled / decoded /
        finished request ids, the queue length and the blocks in
        use."""
        idx = self.step_idx
        self.step_idx += 1
        report: Dict[str, Any] = {"step": idx, "admitted": [],
                                  "prefilled": [], "decoded": [],
                                  "finished": []}
        direct, chunked = self._admit()
        report["admitted"] = [f.req.id for f in direct + chunked]
        report["queued"] = len(self.queue)
        self.prefilling.extend(chunked)
        if direct:
            state = self._prefill(direct, state)
            self.running.extend(direct)
        if self.prefilling:
            state = self._prefill_chunks(state, idx, report)
        # a request whose first token already ended it buys no decode
        report["finished"].extend(self._reap())
        if self.running:
            report["decoded"] = [f.req.id for f in self.running]
            state = self._decode(state)
        report["finished"].extend(self._reap())
        report["blocks_in_use"] = self.cache.blocks_in_use
        return state, report


def serve_loop(batcher: ContinuousBatcher, state, requests:
               Sequence[Request], *,
               arrivals: Optional[Sequence[float]] = None,
               clock: Callable[[], float] = time.perf_counter,
               sleep: Callable[[float], None] = time.sleep):
    """Drive ``batcher`` over an arrival schedule (seconds from the
    start; default all at 0) until every request finishes; returns
    ``(state, results)``."""
    order = sorted(range(len(requests)),
                   key=lambda i: arrivals[i] if arrivals else 0.0)
    t0 = clock()
    results: List[RequestResult] = []
    i = 0
    while i < len(order) or not batcher.idle():
        now = clock() - t0
        while i < len(order) and (not arrivals or arrivals[order[i]] <= now):
            batcher.submit(requests[order[i]])
            i += 1
        if batcher.idle():
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
