"""Comms plane: collective tracing + the wire bandwidth ledger.

Counterpart of ``apex_tpu/telemetry/comms.py``, host Python copied as
is. Every cross-replica byte the port moves goes through the
:class:`~apex_tpu_torch.resilience.guard.Collective` contract
(``all_gather`` / ``broadcast_from`` / ``barrier`` / ``agree_any``):
the fleet router's KV handoff wire and the fleet telemetry's snapshot
gathers.

- :func:`instrument` wraps a ``Collective`` in an
  :class:`InstrumentedCollective` that times every op and publishes
  ``collective_ops{op=,impl=}`` counters, ``collective_bytes{op=}`` /
  ``collective_ms{op=}`` histograms and ``collective:<op>`` timeline
  spans. **Disabled means untouched**: with no tracer armed,
  ``instrument(col) is col``.
- :class:`CommsTracer` keeps the **bandwidth ledger**: per op the
  payload bytes, the analytic wire bytes (:func:`wire_bytes`: an
  all_gather delivers ``payload x n``, a broadcast ``payload``) and the
  wall ms; with ``link_gbps`` it adds the analytic ms and the
  measured/analytic ratio, else those fields are null with a reason.
- A ``collective_slow`` **escalation event** fires when one op's wall
  time exceeds ``slow_factor`` x its own EWMA (after ``min_samples``
  warm samples), latched per excursion; the EWMA folds in healthy
  samples only.

Fault drills (``resilience/faults.py``): every traced op calls
``faults.check("collective")`` (``io:collective=<idx>``),
``collective_slow=<ms>`` delays an op, and
``collective_payload_corrupt=<idx>`` flips one byte of a gathered or
broadcast payload (event ``collective_payload_corrupt``).

Arm it with :func:`enable` or the ``APEX_TPU_COMMS`` environment knob;
flight bundles carry :func:`section`; ``fleet.estimate_clock_offsets``
deposits its offsets into the armed tracer.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from apex_tpu_torch.telemetry import metrics as _metrics
from apex_tpu_torch.telemetry import timeline as _timeline

# the four ops of the Collective contract, in escalation-report order
COLLECTIVE_OPS = ("all_gather", "broadcast_from", "barrier", "agree_any")


def wire_bytes(op: str, payload_bytes: int, n_replicas: int) -> int:
    """Analytic bytes ONE host moves for ``op`` on a ``n_replicas``
    replica set — the ledger's "analytic" column (what the op must
    transfer, independent of how fast the transport did it)."""
    n = max(int(n_replicas), 1)
    if op == "all_gather":
        return int(payload_bytes) * n        # every replica's copy lands
    if op == "agree_any":
        return 4 * n                         # one int32 gathered
    if op == "barrier":
        return 0
    if op == "ppermute":
        return int(payload_bytes)            # ring rotation: one hop out
    if op == "all_to_all":
        # MoE dispatch/combine: each host keeps its own 1/n shard and
        # ships the other (n-1)/n of its payload, per direction
        return int(payload_bytes) * (n - 1) // n
    return int(payload_bytes)                # broadcast_from: src's copy


class CommsTracer:
    """Per-op accounting + escalation state behind instrumented
    collectives. One tracer per registry: the process-global one
    (:func:`enable`) for real runs, private ones for the threaded
    LocalCollective sims (each simulated host passes its own registry,
    the same pattern ``gather_snapshots`` uses for snapshots)."""

    def __init__(self, *, registry=None, timeline=None,
                 slow_factor: float = 4.0, ewma_alpha: float = 0.25,
                 min_samples: int = 5, link_gbps: Optional[float] = None,
                 clock: Callable[[], float] = time.perf_counter):
        if slow_factor <= 1.0:
            raise ValueError(
                f"slow_factor must be > 1, got {slow_factor}")
        if not (0.0 < ewma_alpha <= 1.0):
            raise ValueError(
                f"ewma_alpha must be in (0, 1], got {ewma_alpha}")
        self.registry = (registry if registry is not None
                         else _metrics.registry())
        self.timeline = timeline          # None -> the global timeline
        self.slow_factor = float(slow_factor)
        self.ewma_alpha = float(ewma_alpha)
        self.min_samples = int(min_samples)
        self.link_gbps = link_gbps
        self.clock = clock
        self._lock = threading.Lock()
        self._ops: Dict[str, Dict[str, Any]] = {}
        self.clock_offsets: Optional[Dict[str, Any]] = None
        reg = self.registry
        self._ops_counter = reg.counter(
            "collective_ops", "traced collective ops by op and impl")
        self._bytes_hist = reg.histogram(
            "collective_bytes", "payload bytes per traced collective op",
            buckets=_metrics.PAYLOAD_BYTES_BUCKETS)
        self._ms_hist = reg.histogram(
            "collective_ms", "wall milliseconds per traced collective op",
            buckets=_metrics.LATENCY_MS_BUCKETS)
        self._slow_counter = reg.counter(
            "collective_slow_total",
            "collective_slow escalation events by op")

    # -- recording ---------------------------------------------------------

    def _new_op(self) -> Dict[str, Any]:
        return {"calls": 0, "payload_bytes": 0, "wire_bytes": 0,
                "wall_ms": 0.0, "last_ms": 0.0, "max_ms": 0.0,
                "ewma_ms": None, "slow_latched": False, "slow_events": 0}

    def record(self, op: str, impl: str, payload_bytes: int,
               wire: int, t0: float, dur_s: float) -> None:
        """Account one completed op (the instrumented wrapper's exit
        path; tests drive it directly with synthetic durations)."""
        ms = dur_s * 1e3
        self._ops_counter.inc(op=op, impl=impl)
        if payload_bytes:
            self._bytes_hist.observe(payload_bytes, op=op)
        self._ms_hist.observe(ms, op=op)
        span_args = {"payload_bytes": int(payload_bytes),
                     "wire_bytes": int(wire), "impl": impl}
        if self.timeline is not None:
            self.timeline.record_span(f"collective:{op}", t0, dur_s,
                                      category="collective",
                                      args=span_args)
        else:
            _timeline.record_global_span(f"collective:{op}", t0, dur_s,
                                         category="collective",
                                         args=span_args)
        escalate_from = None
        with self._lock:
            st = self._ops.setdefault(op, self._new_op())
            st["calls"] += 1
            st["payload_bytes"] += int(payload_bytes)
            st["wire_bytes"] += int(wire)
            st["wall_ms"] += ms
            st["last_ms"] = ms
            st["max_ms"] = max(st["max_ms"], ms)
            prev = st["ewma_ms"]
            warmed = prev is not None and st["calls"] > self.min_samples
            if warmed and ms > self.slow_factor * prev:
                # slow sample: the reference EWMA stays put (a slow
                # episode must not raise its own bar) and the episode
                # latch means one event per excursion
                if not st["slow_latched"]:
                    st["slow_latched"] = True
                    st["slow_events"] += 1
                    escalate_from = prev
            else:
                st["ewma_ms"] = (ms if prev is None else
                                 self.ewma_alpha * ms
                                 + (1.0 - self.ewma_alpha) * prev)
                st["slow_latched"] = False
        if escalate_from is not None:
            self._slow_counter.inc(op=op)
            self.registry.event(
                "collective_slow", op=op, impl=impl,
                ms=round(ms, 4), ewma_ms=round(escalate_from, 4),
                factor=self.slow_factor,
                payload_bytes=int(payload_bytes))

    def note_clock_offsets(self, offsets: Dict[str, Any]) -> None:
        """Deposit the latest ``fleet.estimate_clock_offsets`` result
        so bundles carry offsets next to the per-op stats."""
        with self._lock:
            self.clock_offsets = {
                k: offsets.get(k) for k in
                ("offsets_ms", "spread_ms", "rounds", "rtt_ms")}

    # -- reading -----------------------------------------------------------

    def op_stats(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {op: dict(st) for op, st in self._ops.items()}

    def ledger(self) -> List[Dict[str, Any]]:
        """The measured-vs-analytic bandwidth ledger, one row per op:
        measured MB/s from accumulated wire bytes over wall ms; the
        analytic side (expected ms at ``link_gbps``, measured/analytic
        ratio) is a value or null with ``analytic_reason``."""
        rows: List[Dict[str, Any]] = []
        for op, st in sorted(self.op_stats().items()):
            wall_ms = st["wall_ms"]
            row: Dict[str, Any] = {
                "op": op,
                "calls": st["calls"],
                "payload_bytes": st["payload_bytes"],
                "wire_bytes": st["wire_bytes"],
                "wall_ms": round(wall_ms, 4),
                "mean_ms": round(wall_ms / st["calls"], 4),
                "ewma_ms": (round(st["ewma_ms"], 4)
                            if st["ewma_ms"] is not None else None),
                "measured_mbps": (
                    round(st["wire_bytes"] / 1e6 / (wall_ms / 1e3), 4)
                    if wall_ms > 0 and st["wire_bytes"] else None),
                "slow_events": st["slow_events"],
            }
            if self.link_gbps:
                analytic_ms = (st["wire_bytes"] * 8.0
                               / (self.link_gbps * 1e9) * 1e3)
                row["analytic_ms"] = round(analytic_ms, 4)
                row["measured_over_analytic"] = (
                    round(wall_ms / analytic_ms, 4)
                    if analytic_ms > 0 else None)
            else:
                row["analytic_ms"] = None
                row["analytic_reason"] = (
                    "no link_gbps configured (CommsTracer(link_gbps=...)"
                    " enables the analytic column)")
            rows.append(row)
        return rows

    def summary(self) -> Dict[str, Any]:
        """The JSON-able comms story: per-op stats, the ledger, the
        latest clock offsets (or null), and the escalation config."""
        with self._lock:
            offsets = (dict(self.clock_offsets)
                       if self.clock_offsets is not None else None)
        return {
            "ops": self.op_stats(),
            "ledger": self.ledger(),
            "clock_offsets": offsets,
            "slow_factor": self.slow_factor,
            "ewma_alpha": self.ewma_alpha,
            "min_samples": self.min_samples,
            "link_gbps": self.link_gbps,
        }


def _flip_first_byte(out):
    """One flipped byte in a gathered payload — the injected
    silent-corruption drill (``collective_payload_corrupt``)."""
    if isinstance(out, (list, tuple)):
        if not out:
            return list(out)
        return [_flip_first_byte(out[0])] + [np.asarray(a)
                                             for a in out[1:]]
    a = np.array(out, copy=True)
    if a.nbytes:
        a.view(np.uint8).reshape(-1)[0] ^= 0xFF
    return a


class InstrumentedCollective:
    """A ``Collective`` wrapper that times and accounts every op.

    Duck-typed to the guard's 4-method contract (plus ``n_replicas``
    / ``replica_id`` / ``impl_name``), delegating each op to the
    wrapped ``inner`` — results are byte-identical to the raw
    collective (fault clauses aside). Never constructed on the
    disabled path: :func:`instrument` returns the raw object then.
    """

    def __init__(self, inner, tracer: CommsTracer):
        from apex_tpu_torch.resilience import faults as _faults

        self.inner = inner
        self.tracer = tracer
        self._faults = _faults
        self._impl = (inner.impl_name() if hasattr(inner, "impl_name")
                      else type(inner).__name__)

    @property
    def n_replicas(self) -> int:
        return self.inner.n_replicas

    @property
    def replica_id(self) -> int:
        return self.inner.replica_id

    def impl_name(self) -> str:
        return self._impl

    def _traced(self, op: str, payload_bytes: int, fn,
                corruptible: bool = False):
        f = self._faults
        f.check("collective")                    # io:collective=<idx>
        delay = f.collective_delay_s()
        t0 = self.tracer.clock()
        out = fn()
        if delay > 0.0:
            time.sleep(delay)
        dur = self.tracer.clock() - t0
        if corruptible and f.should_corrupt_collective():
            out = _flip_first_byte(out)
            self.tracer.registry.event(
                "collective_payload_corrupt", op=op, impl=self._impl,
                payload_bytes=int(payload_bytes))
        self.tracer.record(op, self._impl, payload_bytes,
                           wire_bytes(op, payload_bytes, self.n_replicas),
                           t0, dur)
        return out

    def all_gather(self, arr):
        arr = np.asarray(arr)
        return self._traced("all_gather", arr.nbytes,
                            lambda: self.inner.all_gather(arr),
                            corruptible=True)

    def broadcast_from(self, src, arrays):
        arrs = [np.asarray(a) for a in arrays]
        nbytes = sum(a.nbytes for a in arrs)
        return self._traced("broadcast_from", nbytes,
                            lambda: self.inner.broadcast_from(src, arrs),
                            corruptible=True)

    def barrier(self) -> None:
        self._traced("barrier", 0, lambda: self.inner.barrier())

    def agree_any(self, flag: bool) -> bool:
        # delegate to the inner impl (whose agree_any rides its own
        # UNtraced all_gather) so one logical op counts once, as itself
        return self._traced("agree_any", 4,
                            lambda: self.inner.agree_any(flag))


# ---------------------------------------------------------------------------
# The process-global tracer (what instrument() consults)
# ---------------------------------------------------------------------------

_GLOBAL: Optional[CommsTracer] = None
_ENV = "APEX_TPU_COMMS"


def _env_enabled() -> bool:
    return os.environ.get(_ENV, "").strip().lower() in (
        "1", "true", "yes", "on")


def enable(**kwargs) -> CommsTracer:
    """Arm the process-global comms tracer (kwargs =
    :class:`CommsTracer`); collectives built AFTER this (or re-passed
    through :func:`instrument`) are traced. Returns the tracer."""
    global _GLOBAL
    _GLOBAL = CommsTracer(**kwargs)
    return _GLOBAL


def disable() -> None:
    """Disarm: :func:`instrument` becomes the identity again (already-
    wrapped collectives keep their tracer — rebuild them to shed it)."""
    global _GLOBAL
    _GLOBAL = None


def get_tracer() -> Optional[CommsTracer]:
    """The armed tracer, auto-created when ``APEX_TPU_COMMS`` is
    truthy, else None — the zero-overhead fast path."""
    global _GLOBAL
    if _GLOBAL is None and _env_enabled():
        _GLOBAL = CommsTracer()
    return _GLOBAL


def enabled() -> bool:
    return get_tracer() is not None


def instrument(collective, *, tracer: Optional[CommsTracer] = None):
    """``collective``, traced — or UNTOUCHED when no tracer is armed.

    The overhead discipline in one identity: with the plane disabled
    this returns the exact object passed in (``instrument(col) is
    col``), so the raw guard/fleet/elastic paths never see a wrapper.
    Armed, it wraps (idempotently — re-instrumenting a wrapped
    collective with the same tracer returns it as-is).
    """
    if collective is None:
        return None
    t = tracer if tracer is not None else get_tracer()
    if t is None:
        return collective
    if isinstance(collective, InstrumentedCollective):
        if collective.tracer is t:
            return collective
        return InstrumentedCollective(collective.inner, t)
    return InstrumentedCollective(collective, t)


def section() -> Dict[str, Any]:
    """The flight bundle's ``comms`` section: the tracer summary, or
    an explicit disabled marker with the reason (the value-or-null-
    with-reason contract — a bundle never silently lacks the plane)."""
    t = get_tracer()
    if t is None:
        return {"enabled": False,
                "reason": "comms tracing not armed "
                          "(telemetry.comms.enable() or APEX_TPU_COMMS=1)"}
    return {"enabled": True, **t.summary()}


__all__ = [
    "COLLECTIVE_OPS",
    "CommsTracer",
    "InstrumentedCollective",
    "disable",
    "enable",
    "enabled",
    "get_tracer",
    "instrument",
    "section",
    "wire_bytes",
]
