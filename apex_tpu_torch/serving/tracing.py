"""Per-request tracing: the serving tier's request plane.

Counterpart of ``apex_tpu/serving/tracing.py``, host Python copied as
is. A :class:`RequestTrace` per request is born when
``ContinuousBatcher.submit()`` mints its trace id (or continues one a
drain snapshot carried back), gets spans and marks at every scheduler
transition — ``queued``, ``admitted``, ``prefill``, each
``prefill_chunk[i]``, one coalesced ``decode`` window, ``first_token``,
``retry_split``, ``quarantine``, ``prefill_stalled``, ``requeued``,
``resumed`` and a terminal ``finished`` with the outcome — and exports
as perfetto JSON with one track per trace id, in
``StepTimeline.export_trace``'s event format. Completed traces rotate
through a bounded keep-last-``keep`` ring. A batcher built without a
tracer pays one attribute check per hook site.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence

# terminal outcomes a trace can end with (the RequestResult
# finish_reason vocabulary plus the engine-side terminals; `rerouted`
# closes one ENGINE's segment when the fleet router hands the request
# to a peer — the next segment continues the same trace id)
OUTCOMES = ("length", "eos", "error", "deadline_exceeded", "rejected",
            "drained", "rerouted")


class RequestTrace:
    """One request's timeline: spans (name, t0, dur, args), point
    marks (name, t, args), and the terminal outcome. Timestamps are
    absolute tracer-clock seconds; the perfetto export rebases them on
    the tracer origin. ``max_spans`` bounds memory per trace —
    overflow is counted (``dropped``), never silent."""

    __slots__ = ("trace_id", "request_id", "t_submit", "resumed_from",
                 "state", "outcome", "error", "t_finish", "spans",
                 "marks", "dropped", "chunk_idx", "queued_since",
                 "_decode", "_max_spans")

    def __init__(self, trace_id: str, request_id: Any, t_submit: float,
                 *, resumed_from: Optional[str] = None,
                 max_spans: int = 512):
        self.trace_id = trace_id
        self.request_id = request_id
        self.t_submit = float(t_submit)
        self.resumed_from = resumed_from
        self.state = "queued"
        self.outcome: Optional[str] = None
        self.error: Optional[str] = None
        self.t_finish: Optional[float] = None
        self.spans: List[Dict[str, Any]] = []
        self.marks: List[Dict[str, Any]] = []
        self.dropped = 0
        self.chunk_idx = 0                 # prefill_chunk[i] ordinal
        self.queued_since = float(t_submit)
        self._decode: Optional[List[float]] = None  # [t0, end, n, toks]
        self._max_spans = int(max_spans)

    def add_span(self, name: str, t0: float, dur: float,
                 **args) -> None:
        if len(self.spans) >= self._max_spans:
            self.dropped += 1
            return
        self.spans.append({"name": str(name), "t0": float(t0),
                           "dur": float(dur), "args": args})

    def add_mark(self, name: str, t: float, **args) -> None:
        if len(self.marks) >= self._max_spans:
            self.dropped += 1
            return
        self.marks.append({"name": str(name), "t": float(t),
                           "args": args})

    def flush_decode(self) -> None:
        """Close the open decode window into one ``decode`` span."""
        w = self._decode
        if w is None:
            return
        self._decode = None
        t0, end, n, toks = w
        self.add_span("decode", t0, end - t0, dispatches=int(n),
                      tokens=int(toks))

    def to_dict(self) -> Dict[str, Any]:
        """JSON-able trace payload (what ``slo_violation`` bundles and
        drain postmortems embed)."""
        return {
            "trace_id": self.trace_id,
            "request_id": str(self.request_id),
            "t_submit": self.t_submit,
            "t_finish": self.t_finish,
            "state": self.state,
            "outcome": self.outcome,
            "error": self.error,
            "resumed_from": self.resumed_from,
            "spans": [dict(s) for s in self.spans],
            "marks": [dict(m) for m in self.marks],
            "dropped": self.dropped,
        }


class RequestTracer:
    """The request-plane recorder the scheduler's hooks feed.

    - ``keep``: bounded ring of COMPLETED traces (live traces are held
      until they finish, then rotate through the ring).
    - ``max_spans``: per-trace span/mark cap (overflow counted).
    - ``enabled``: a disarmed tracer makes every hook an immediate
      return — the scheduler additionally skips the calls entirely
      when no tracer is attached.

    Thread-safe: ``begin`` runs on client threads (``submit()``), the
    rest on the engine thread; one lock covers the trace maps.
    """

    def __init__(self, *, keep: int = 256, max_spans: int = 512,
                 enabled: bool = True,
                 clock: Callable[[], float] = time.perf_counter):
        self.enabled = bool(enabled)
        self.keep = int(keep)
        self.max_spans = int(max_spans)
        self.clock = clock
        self._origin = clock()
        self._lock = threading.Lock()
        self._live: Dict[Any, RequestTrace] = {}
        self._done: "deque[RequestTrace]" = deque(maxlen=self.keep)
        self._minted = 0
        self._finished = 0

    # -- lifecycle hooks (the scheduler's call sites) ----------------------

    def begin(self, request_id, *, t_submit: Optional[float] = None,
              trace_id: Optional[str] = None,
              resumed_from: Optional[str] = None) -> str:
        """Open a trace at ``submit()``; returns the trace id. A
        caller-provided ``trace_id`` (a resumed drain snapshot)
        CONTINUES that trace — same id, ``resumed_from`` annotating
        where the first half lives."""
        t = t_submit if t_submit is not None else self.clock()
        with self._lock:
            if trace_id is None:
                self._minted += 1
                trace_id = f"rq-{os.getpid():x}-{self._minted:06x}"
            tr = RequestTrace(trace_id, request_id, t,
                              resumed_from=resumed_from,
                              max_spans=self.max_spans)
            self._live[request_id] = tr
        if resumed_from is not None:
            tr.add_mark("resumed", t, resumed_from=resumed_from)
        return trace_id

    def _get(self, request_id) -> Optional[RequestTrace]:
        return self._live.get(request_id)

    def admitted(self, request_id, t: float, *, mode: str = "direct",
                 matched: int = 0) -> None:
        tr = self._get(request_id)
        if tr is None:
            return
        tr.add_span("queued", tr.queued_since, t - tr.queued_since)
        tr.add_mark("admitted", t, mode=mode, matched=int(matched))
        tr.state = "prefilling" if mode == "chunked" else "decoding"

    def span(self, request_id, name: str, t0: float, dur: float,
             **args) -> None:
        tr = self._get(request_id)
        if tr is not None:
            tr.add_span(name, t0, dur, **args)

    def chunk_span(self, request_id, t0: float, dur: float, *,
                   tokens: int) -> None:
        """One ``prefill_chunk[i]`` span, ``i`` the request's own
        chunk ordinal (not the engine's dispatch index)."""
        tr = self._get(request_id)
        if tr is None:
            return
        tr.add_span(f"prefill_chunk[{tr.chunk_idx}]", t0, dur,
                    tokens=int(tokens))
        tr.chunk_idx += 1

    def mark(self, request_id, name: str, t: Optional[float] = None,
             **args) -> None:
        tr = self._get(request_id)
        if tr is not None:
            tr.add_mark(name, t if t is not None else self.clock(),
                        **args)

    def requeued(self, request_id, t: float) -> None:
        """A deadlock-breaking requeue: back to QUEUED, the next
        ``queued`` span opens here (not at the original submit)."""
        tr = self._get(request_id)
        if tr is None:
            return
        tr.add_mark("requeued", t)
        tr.queued_since = t
        tr.state = "queued"

    def decoding(self, request_id) -> None:
        tr = self._get(request_id)
        if tr is not None:
            tr.state = "decoding"

    def decode_tick(self, request_id, t0: float, t1: float) -> None:
        """Fold one decode dispatch into the request's decode window
        (flushed as a single ``decode`` span at finish)."""
        tr = self._get(request_id)
        if tr is None:
            return
        w = tr._decode
        if w is None:
            tr._decode = [t0, t1, 1, 1]
        else:
            w[1] = max(w[1], t1)
            w[2] += 1
            w[3] += 1

    def finish(self, request_id, outcome: str, *,
               t: Optional[float] = None,
               error: Optional[str] = None, **args) -> None:
        """Terminal transition: flush the decode window, stamp the
        outcome, rotate the trace into the completed ring. Unknown ids
        (an untracked request) are a no-op."""
        with self._lock:
            tr = self._live.pop(request_id, None)
        if tr is None:
            return
        now = t if t is not None else self.clock()
        tr.flush_decode()
        tr.state = "finished"
        tr.outcome = str(outcome)
        tr.error = error
        tr.t_finish = now
        tr.add_mark("finished", now, outcome=str(outcome), **args)
        with self._lock:
            self._finished += 1
            self._done.append(tr)

    def drained(self, request_id, t: float, *,
                snapshot: Optional[str] = None) -> None:
        """The engine snapshotted this request mid-flight: the trace
        ends here with outcome ``drained``; the resumed engine's
        ``begin`` (same trace id, ``resumed_from`` set) continues the
        story on the other side of the kill."""
        self.finish(request_id, "drained", t=t,
                    snapshot=snapshot)

    # -- reading -----------------------------------------------------------

    def live(self) -> List[RequestTrace]:
        with self._lock:
            return list(self._live.values())

    def completed(self) -> List[RequestTrace]:
        with self._lock:
            return list(self._done)

    def trace_dicts(self, request_ids: Optional[Sequence[Any]] = None,
                    ) -> List[Dict[str, Any]]:
        """JSON-able trace payloads — completed then live, oldest
        first; ``request_ids`` filters (ids are compared as strings,
        matching the dict payload)."""
        with self._lock:
            traces = list(self._done) + list(self._live.values())
        if request_ids is not None:
            want = {str(i) for i in request_ids}
            traces = [t for t in traces if str(t.request_id) in want]
        return [t.to_dict() for t in traces]

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            return {"enabled": self.enabled, "minted": self._minted,
                    "live": len(self._live), "completed": len(self._done),
                    "finished": self._finished, "keep": self.keep}

    # -- perfetto export ---------------------------------------------------

    def export_trace(self, path: Optional[str] = None, *,
                     request_ids: Optional[Sequence[Any]] = None,
                     ) -> Dict[str, Any]:
        """The request plane as Chrome-trace JSON — the SAME "JSON
        Array Format" ``StepTimeline.export_trace`` emits (complete
        ``"ph": "X"`` events, µs ``ts``/``dur`` relative to the tracer
        origin), but with ONE TRACK (tid) PER TRACE ID, labeled
        ``<request_id> (<trace_id>)`` via thread-name metadata — so the
        segments of a drained/resumed request, or one handed across
        engines by the fleet router, land on a single track telling the
        request's whole story. Marks ride as zero-duration events.
        Loadable at ui.perfetto.dev / chrome://tracing, side by side
        with the engine timeline when both use the default
        ``perf_counter`` clock."""
        with self._lock:
            traces = list(self._done) + list(self._live.values())
        if request_ids is not None:
            want = {str(i) for i in request_ids}
            traces = [t for t in traces if str(t.request_id) in want]
        pid = os.getpid()
        events: List[Dict[str, Any]] = []

        def us(t: float) -> float:
            return round((t - self._origin) * 1e6, 3)

        # one track (tid) per TRACE ID, not per trace object: a
        # drain/resume or a fleet-router handoff produces several
        # segments with the same trace id, and they must land on ONE
        # perfetto track — the request's whole story, crossing engines
        tids: Dict[str, int] = {}
        labels: Dict[int, str] = {}
        for tr in traces:
            tid = tids.setdefault(tr.trace_id, len(tids))
            # an unfinished trace still shows its open decode window
            spans = list(tr.spans)
            if tr._decode is not None:
                t0, end, n, toks = tr._decode
                spans.append({"name": "decode", "t0": t0,
                              "dur": end - t0,
                              "args": {"dispatches": int(n),
                                       "tokens": int(toks),
                                       "open": True}})
            for s in spans:
                events.append({
                    "name": s["name"], "cat": "request", "ph": "X",
                    "ts": us(s["t0"]),
                    "dur": round(s["dur"] * 1e6, 3),
                    "pid": pid, "tid": tid,
                    "args": {"trace_id": tr.trace_id, **s["args"]},
                })
            for m in tr.marks:
                events.append({
                    "name": m["name"], "cat": "request", "ph": "X",
                    "ts": us(m["t"]), "dur": 0.0,
                    "pid": pid, "tid": tid,
                    "args": {"trace_id": tr.trace_id, **m["args"]},
                })
            label = f"{tr.request_id} ({tr.trace_id})"
            if tr.resumed_from:
                label += f" resumed_from={tr.resumed_from}"
            labels[tid] = label  # last segment wins
        for tid, label in labels.items():
            events.append({
                "name": "thread_name", "ph": "M", "pid": pid,
                "tid": tid, "args": {"name": label},
            })
        trace = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path is not None:
            tmp = f"{path}.tmp-{pid}"
            with open(tmp, "w") as f:
                json.dump(trace, f)
            os.replace(tmp, path)
        return trace


__all__ = [
    "OUTCOMES",
    "RequestTrace",
    "RequestTracer",
]
