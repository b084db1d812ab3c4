"""Step timeline: per-phase host-loop spans and perfetto export.

Counterpart of ``apex_tpu/telemetry/timeline.py``: a ring-buffered
:class:`StepTimeline` of :class:`Span` records (the serving scheduler
records its ``prefill`` / ``prefill_chunk`` / ``decode`` dispatches
under category ``serving``), :meth:`StepTimeline.export_trace` as
Chrome-trace / perfetto JSON, the process-global timeline
(:func:`enable`, :func:`disable`, :func:`get_timeline`) and the
process-wide span observer (:func:`set_span_observer`,
:func:`record_global_span`).

A disabled timeline records nothing and every entry point returns at
once; an enabled one costs a ``perf_counter`` pair and a deque append
per span. ``phase(..., sync_on=t)`` synchronizes the CUDA stream of
the tensor ``t`` before the clock stops (the reference blocks on a jax
value), so the span covers device completion rather than launch; it is
a no-op for a CPU tensor.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, NamedTuple, Optional

def sync_tensor(t) -> None:
    """Wait for the work queued on the CUDA stream of tensor ``t``; a
    no-op for a CPU tensor (or anything without a ``device``)."""
    dev = getattr(t, "device", None)
    if dev is not None and dev.type == "cuda":
        import torch

        torch.cuda.current_stream(dev).synchronize()


class Span(NamedTuple):
    """One timed region: ``t0`` is absolute ``perf_counter`` seconds,
    ``dur`` seconds, ``step`` the host-loop step index it happened in
    (-1 = outside any step scope); ``args`` are extra JSON-able
    key/values the trace export folds into the event (the comms plane
    attributes payload/wire bytes to its ``collective:*`` spans)."""

    name: str
    t0: float
    dur: float
    step: int
    category: str
    args: Optional[Dict[str, Any]] = None


class StepTimeline:
    """Ring-buffered span recorder for the training host loop.

    ``capacity`` bounds memory: the newest ``capacity`` spans are kept,
    older ones fall off (``summary()`` reports how many were dropped).
    All methods are thread-safe; clock is ``time.perf_counter``.
    """

    def __init__(self, capacity: int = 4096, *, enabled: bool = True,
                 clock: Callable[[], float] = time.perf_counter):
        self.enabled = bool(enabled)
        self.capacity = int(capacity)
        self.clock = clock
        self._lock = threading.Lock()
        self._spans: "deque[Span]" = deque(maxlen=self.capacity)
        self._recorded = 0
        self._dropped_dur = 0.0
        self._origin = clock()
        self._step = -1
        self._step_t0: Optional[float] = None

    # -- recording ---------------------------------------------------------

    def record_span(self, name: str, t0: float, dur: float, *,
                    category: str = "phase",
                    step: Optional[int] = None,
                    args: Optional[Dict[str, Any]] = None) -> None:
        if not self.enabled:
            return
        with self._lock:
            span = Span(
                str(name), float(t0), float(dur),
                self._step if step is None else int(step), str(category),
                dict(args) if args else None)
            if (self._spans.maxlen is not None
                    and len(self._spans) == self._spans.maxlen):
                # ring wraparound: the evicted span's time would vanish
                # from any later pull-based accounting — total it so
                # summary()/publish() can surface the loss (a zero-
                # capacity ring evicts the incoming span itself)
                self._dropped_dur += (self._spans[0].dur
                                      if self._spans else span.dur)
            self._spans.append(span)
            self._recorded += 1
        obs = _SPAN_OBSERVER
        if obs is not None:
            try:
                obs(span)
            except Exception:  # noqa: BLE001 — observers never take down the loop
                pass

    @contextlib.contextmanager
    def phase(self, name: str, *, sync_on: Any = None,
              category: str = "phase"):
        """``with tl.phase("h2d"): ...`` — record the block as a span.
        ``sync_on`` (a tensor) synchronizes its CUDA stream before the
        clock stops, so the span covers device completion, not just
        the launch; a CPU tensor needs no wait."""
        if not self.enabled:
            yield
            return
        t0 = self.clock()
        try:
            yield
        finally:
            if sync_on is not None:
                sync_tensor(sync_on)
            self.record_span(name, t0, self.clock() - t0,
                             category=category)

    # -- step scopes -------------------------------------------------------

    def begin_step(self) -> int:
        """Open a host-loop step; spans recorded until ``end_step``
        carry its index. Returns the step index."""
        if not self.enabled:
            return self._step
        with self._lock:
            self._step += 1
            self._step_t0 = self.clock()
        return self._step

    def end_step(self) -> None:
        """Close the open step, recording its whole wall span as
        ``host_step`` (category ``step``)."""
        if not self.enabled:
            return
        with self._lock:
            t0, self._step_t0 = self._step_t0, None
        if t0 is not None:
            self.record_span("host_step", t0, self.clock() - t0,
                             category="step")

    @contextlib.contextmanager
    def step_scope(self):
        """``with tl.step_scope(): ...`` — begin_step/end_step pair."""
        self.begin_step()
        try:
            yield self._step
        finally:
            self.end_step()

    # -- reading -----------------------------------------------------------

    @property
    def origin(self) -> float:
        """The local clock value ``export_trace``'s ``ts=0`` maps to —
        what ``fleet.export_fleet_trace`` shifts against when it moves
        every host's events onto the shared barrier instant."""
        with self._lock:
            return self._origin

    def spans(self) -> list:
        with self._lock:
            return list(self._spans)

    def reset(self) -> None:
        with self._lock:
            self._spans.clear()
            self._recorded = 0
            self._dropped_dur = 0.0
            self._step = -1
            self._step_t0 = None
            self._origin = self.clock()

    def summary(self) -> Dict[str, Any]:
        """Per-phase aggregate over the retained window: count,
        total/mean/max/last ms — the JSON-able phase breakdown bench
        records carry."""
        spans = self.spans()
        phases: Dict[str, Dict[str, float]] = {}
        for s in spans:
            p = phases.setdefault(s.name, {
                "count": 0, "total_ms": 0.0, "max_ms": 0.0, "last_ms": 0.0})
            ms = s.dur * 1e3
            p["count"] += 1
            p["total_ms"] += ms
            p["max_ms"] = max(p["max_ms"], ms)
            p["last_ms"] = ms
        for p in phases.values():
            p["mean_ms"] = p["total_ms"] / p["count"]
            for k in ("total_ms", "mean_ms", "max_ms", "last_ms"):
                p[k] = round(p[k], 4)
        with self._lock:
            dropped = self._recorded - len(spans)
            dropped_s = self._dropped_dur
            steps = self._step + 1
        return {"enabled": self.enabled, "steps": steps,
                "spans": len(spans), "dropped_spans": dropped,
                "dropped_span_seconds": round(dropped_s, 6),
                "phases": phases}

    def export_trace(self, path: Optional[str] = None, *,
                     last_steps: Optional[int] = None) -> Dict[str, Any]:
        """The retained window as Chrome-trace JSON (the "JSON Array
        Format" chrome://tracing and ui.perfetto.dev load): complete
        ``"ph": "X"`` events with microsecond ``ts``/``dur`` relative
        to the timeline origin, one tid per category. Writes to
        ``path`` when given; always returns the dict.

        ``last_steps=N`` slices to the newest ``N`` host-loop steps —
        the flight recorder's bundle window. Spans recorded outside any
        step scope (``step == -1``) are kept: they cannot be dated by
        step, and the ring already bounds them."""
        spans = self.spans()
        if last_steps is not None and spans:
            newest = max(s.step for s in spans)
            cutoff = newest - int(last_steps) + 1
            spans = [s for s in spans if s.step < 0 or s.step >= cutoff]
        pid = os.getpid()
        tids: Dict[str, int] = {}
        events = []
        for s in spans:
            tid = tids.setdefault(s.category, len(tids))
            ev_args: Dict[str, Any] = {"step": s.step}
            if s.args:
                ev_args.update(s.args)
            events.append({
                "name": s.name,
                "cat": s.category,
                "ph": "X",
                "ts": round((s.t0 - self._origin) * 1e6, 3),
                "dur": round(s.dur * 1e6, 3),
                "pid": pid,
                "tid": tid,
                "args": ev_args,
            })
        # thread-name metadata makes the perfetto track labels readable
        for cat, tid in tids.items():
            events.append({
                "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": cat},
            })
        trace = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path is not None:
            tmp = f"{path}.tmp-{pid}"
            with open(tmp, "w") as f:
                json.dump(trace, f)
            os.replace(tmp, path)
        return trace

# ---------------------------------------------------------------------------
# The process-global timeline (the spine Timers/annotate/loaders ride)
# ---------------------------------------------------------------------------

_GLOBAL: Optional[StepTimeline] = None
_ENV = "APEX_TPU_TELEMETRY"

# one push-based listener every StepTimeline (global AND private
# instances, e.g. the train step's) feeds each recorded span through —
# how the goodput ledger attributes time without polling the ring.
# Checked as a single module-global read per span; None means nobody
# is listening.
_SPAN_OBSERVER: Optional[Callable[[Span], None]] = None


def set_span_observer(cb: Optional[Callable[[Span], None]]) -> None:
    """Install (or clear, with None) the process-wide span observer.
    The callback runs on the recording thread for every span of every
    enabled timeline; exceptions are swallowed — it must be cheap."""
    global _SPAN_OBSERVER
    _SPAN_OBSERVER = cb


def _env_enabled() -> bool:
    return os.environ.get(_ENV, "").strip().lower() in (
        "1", "true", "yes", "on")


def get_timeline() -> StepTimeline:
    """The process-global timeline. Created on first use — DISABLED
    unless ``APEX_TPU_TELEMETRY`` is truthy or :func:`enable` ran."""
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = StepTimeline(enabled=_env_enabled())
    return _GLOBAL


def enable(capacity: int = 4096) -> StepTimeline:
    """Turn the global timeline on (fresh ring buffer); returns it."""
    global _GLOBAL
    _GLOBAL = StepTimeline(capacity=capacity, enabled=True)
    return _GLOBAL


def disable() -> None:
    global _GLOBAL
    _GLOBAL = StepTimeline(enabled=False)


def global_enabled() -> bool:
    """Whether the global timeline records (a cheap hot-path check)."""
    tl = _GLOBAL
    if tl is None:
        return _env_enabled() and get_timeline().enabled
    return tl.enabled


def record_global_span(name: str, t0: float, dur: float, *,
                       category: str = "phase",
                       args: Optional[Dict[str, Any]] = None) -> None:
    """Record into the global timeline iff it is enabled (no-op —
    not even a timeline construction — otherwise)."""
    tl = _GLOBAL
    if tl is not None and tl.enabled:
        tl.record_span(name, t0, dur, category=category, args=args)
    elif tl is None and _env_enabled():
        get_timeline().record_span(name, t0, dur, category=category,
                                   args=args)


__all__ = [
    "Span",
    "StepTimeline",
    "disable",
    "enable",
    "get_timeline",
    "global_enabled",
    "record_global_span",
    "set_span_observer",
    "sync_tensor",
]
