"""Fleet front door: a fault-tolerant router over N serving engines.

Counterpart of ``apex_tpu/serving/fleet.py``, host Python over the
port's engines. Everything below the router is in the port already —
the SLO monitor's latched ``should_shed()``, drain snapshots and
``resume_requests``, ``resumed_from`` trace continuity, the prefix
index's ``prefix_match_len`` and the KV cache's ``export_blocks`` /
``import_blocks`` — and the :class:`FleetRouter` uses them across
engines: one ``submit()`` / ``step()`` / ``merge_results()`` /
``introspect()`` surface fronting N
:class:`~apex_tpu_torch.serving.scheduler.ContinuousBatcher` engines.

**Placement** (``submit``): ``"affinity"`` (default) probes every
engine's prefix index and sends a request to the longest cached match
(``fleet_prefix_affinity_hits``), tie-broken and missed by least queue
depth; ``"least_queue"`` and ``"round_robin"`` are the baselines.
Engines whose SLO monitor has latched ``should_shed()`` are passed over
while another lives; when every live engine sheds, the fleet refuses
with a structured result (``reason="shedding"``, ``fleet_shed``).

**Failover** (``step``): the router steps every live engine in turn on
one thread. A step slower than ``stall_after_s`` marks the engine
``stalled`` and hedges: up to ``hedge_max`` of its not-yet-admitted
requests move to a healthy peer (``ContinuousBatcher.take_queued``;
in-flight work stays put, so no stream is duplicated; the old trace
segment closes ``rerouted``). A hard death
(:class:`~apex_tpu_torch.resilience.faults.EngineCrash`, or
``max_step_failures`` consecutive step exceptions: a wedged engine)
fences the engine and recovers its queued and in-flight work: from its
drain snapshot or a fresh one under ``snapshot_dir/<engine>/``, or,
when none is usable (``router_snapshot_missing`` forces it), by replay
from prompt + generated-so-far; both through ``resume_requests`` onto
survivors, with ``resumed_from`` continuing the same trace id, and the
counter-keyed per-request sampler keeps each recovered stream the
uninterrupted one's. Transient step faults (``io:fleet_router``) ride
``resilience.retry``, with ``EngineCrash`` on its give-up list. Note
that a fenced engine is how any exception out of a dispatch ends after
``max_step_failures`` tries: a caller that injects no fault should
hold ``failovers`` empty.

**Elastic membership**: :meth:`FleetRouter.add_engine` (``warm=True``
runs ``ContinuousBatcher.warmup`` before the engine joins) and
:meth:`FleetRouter.remove_engine` (a planned exit through the same
recovery path: ``fleet_requests_rerouted{cause=remove}``, no failover,
no bundle). A recovery with no survivor parks its work in an orphan
list the next ``add_engine`` drains.

**Disaggregated prefill/decode** (``add_engine(role=...)``): a
``prefill`` seat admits and prefills, then hands each stream off; a
``decode`` seat receives streams through the handoff only;
``colocated`` (default) does both. After each step the router takes
every prefill-complete flight off the prefill seats
(``take_prefilled``), exports its blocks to the host
(``KVCache.export_blocks``: ``uint16`` bits for a bf16 pool), hashes
each block into a sha256 manifest, ships the payload over a
``telemetry.comms``-instrumented loopback ``NullCollective`` and
verifies every block against the manifest before
``install_prefilled`` writes it into the decode seat's pool. The wire is
the reference's host numpy path, so a manifest names the same bytes in
both packages. A failed verify re-sends the same export under the
retry; a decode seat that dies mid-handoff is fenced and the stream
re-prefills on a survivor; an orphaned export (``handoff_orphan``)
frees its source blocks dirty (zeroed before reuse) and replays; a
retry-exhausted transfer keeps the stream decoding on its source; and
``fallback_after`` consecutive failures latch colocated fallback
(``reason="handoff_degraded"``) until a probe transfer per step passes.

Telemetry: ``fleet_engines{state=}``, ``fleet_failovers{cause=}``,
``fleet_requests_rerouted{cause=}``, ``fleet_prefix_affinity_hits``,
``fleet_shed``, per-engine ``fleet_engine_up`` /
``fleet_engine_step_seconds`` / ``fleet_engine_queue_depth``,
``fleet_handoffs{outcome=}``, ``fleet_handoff_bytes``,
``fleet_handoff_retries``, ``fleet_handoff_probes{outcome=}``,
``fleet_colocated_fallback{transition=}`` and its ``_latched`` gauge;
the flight triggers ``fleet_engine_lost`` and ``kv_handoff_failed``;
one ``handoff`` span per installed handoff on the request's single
trace (one :class:`~apex_tpu_torch.serving.tracing.RequestTracer`
shared by every engine).

Fault clauses (``resilience/faults.py``): ``engine_crash`` (+
``engine_crash_engine``), ``engine_stall_ms`` (+ ``engine_stall_engine``
/ ``engine_stall_at``), ``router_snapshot_missing``, ``io:fleet_router``,
``kv_transfer_corrupt`` / ``kv_transfer_timeout`` /
``kv_transfer_partial``, ``handoff_orphan`` and ``io:kv_handoff``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from apex_tpu_torch.resilience import faults
from apex_tpu_torch.resilience.retry import retry_call
from apex_tpu_torch.serving import resilience as _sresil
from apex_tpu_torch.serving.scheduler import Request, RequestResult

# the engine lifecycle the fleet_engines{state=} gauge enumerates
ENGINE_STATES = ("warming", "active", "stalled", "draining", "fenced",
                 "removed")

# the disaggregation roles add_engine(role=...) accepts
ENGINE_ROLES = ("prefill", "decode", "colocated")


@dataclasses.dataclass
class EngineHandle:
    """One engine's seat in the fleet: the batcher, its device cache
    state (threaded through every ``step``), and the router-side
    health record. ``index`` is the 0-based JOIN order — the identity
    the ``engine_crash_engine`` / ``engine_stall_engine`` fault knobs
    address, stable across fencing and removal. ``role`` is the
    disaggregation seat (one of ``ENGINE_ROLES``): routing POLICY, not
    capability — every seat is a full ContinuousBatcher, so the
    zero-drop guarantee always outranks the role split."""

    name: str
    batcher: Any                      # scheduler.ContinuousBatcher
    state: Any                        # device KV-cache state
    index: int
    status: str = "active"            # one of ENGINE_STATES
    role: str = "colocated"           # one of ENGINE_ROLES
    last_beat: float = 0.0            # router clock at last good step
    last_step_s: float = 0.0
    step_failures: int = 0            # consecutive; reset on success
    hedged: int = 0                   # requests moved off while stalled
    error: Optional[str] = None       # last step failure, truncated
    handoffs_out: int = 0             # streams shipped off (prefill)
    handoffs_in: int = 0              # streams installed (decode)


class FleetRouter:
    """The multi-engine front door (module docstring).

    Drive it like a batcher: ``submit()`` requests (returns the chosen
    engine's name, or None on a structured refusal), ``step()`` once
    per iteration (steps every live engine, detects stalls, fences and
    recovers the dead), ``merge_results()`` to collect finished
    results with recovered streams stitched back together, and
    ``introspect()`` for the live fleet view. ``fleet_serve_loop``
    wraps the cycle over an arrival schedule.

    ``submit`` is thread-safe (placement reads + the engine's own
    thread-safe ``submit``); ``step`` / membership changes belong to
    one stepping thread — the same discipline as the engine itself.
    """

    def __init__(self, *, registry=None, tracer=None,
                 snapshot_dir: Optional[str] = None,
                 placement: str = "affinity",
                 stall_after_s: float = 1.0,
                 max_step_failures: int = 3,
                 hedge_max: int = 4,
                 step_retries: int = 2,
                 handoff_retries: int = 2,
                 fallback_after: int = 3,
                 retry_base_delay: float = 0.01,
                 clock: Callable[[], float] = time.perf_counter,
                 sleep: Callable[[float], None] = time.sleep):
        from apex_tpu_torch import telemetry

        if placement not in ("affinity", "least_queue", "round_robin"):
            raise ValueError(f"unknown placement {placement!r}")
        self._registry = (registry if registry is not None
                          else telemetry.registry())
        self.tracer = tracer              # ONE tracer across the fleet
        self.snapshot_dir = snapshot_dir
        self.placement = placement
        self.stall_after_s = float(stall_after_s)
        self.max_step_failures = int(max_step_failures)
        self.hedge_max = int(hedge_max)
        self.step_retries = int(step_retries)
        self.handoff_retries = int(handoff_retries)
        self.fallback_after = int(fallback_after)
        self.retry_base_delay = float(retry_base_delay)
        self.clock = clock
        self.sleep = sleep
        self.step_idx = 0
        # failover records (what `fleet_failover_ms` reads): one
        # dict per fence with cause/source/recovered ids/recover_s
        self.failovers: List[Dict[str, Any]] = []
        self._lock = threading.Lock()
        self._engines: Dict[str, EngineHandle] = {}
        self._retired: List[EngineHandle] = []
        self._next_index = 0
        self._rr = 0                      # round_robin cursor
        self._recoveries = 0              # router_snapshot_missing idx
        self._refused: List[RequestResult] = []
        self._orphans: List[Request] = []
        # generated-so-far prefixes of recovered requests, stitched
        # back by merge_results (accumulates across double failovers)
        self._prior: Dict[Any, List[int]] = {}
        # -- disaggregated handoff state --
        self._handoff_seq = 0             # transfer id (orphan drill)
        self._handoff_failures = 0        # consecutive; latch trigger
        self._fallback = False            # colocated-fallback latch
        self._fallback_step: Optional[int] = None
        self._wire_col = None             # lazy loopback collective
        self.handoff_stats: Dict[str, int] = {
            "ok": 0, "failed": 0, "orphan": 0, "dst_crash": 0,
            "export_error": 0, "bytes": 0, "retries": 0}

    # -- membership ----------------------------------------------------------

    def engines(self) -> List[EngineHandle]:
        with self._lock:
            return list(self._engines.values())

    def add_engine(self, name: str, batcher, state, *,
                   role: str = "colocated",
                   warm: bool = False) -> EngineHandle:
        """Seat a new engine. With ``warm=True`` the engine warms up
        HERE (``ContinuousBatcher.warmup``: kernel libraries loaded,
        library handles made), before it enters the placement pool —
        warmup off the hot path, then admit. The reference's
        ``warmup_kwargs`` (its shape buckets) has no counterpart: the
        port compiles no shape buckets. ``role`` picks the disaggregation seat
        (``prefill`` / ``decode`` / ``colocated`` — module docstring).
        The newcomer adopts the fleet tracer (one request plane across
        engines) and immediately absorbs any orphaned work a
        zero-survivor recovery parked."""
        if role not in ENGINE_ROLES:
            raise ValueError(f"unknown engine role {role!r} "
                             f"(one of {ENGINE_ROLES})")
        with self._lock:
            prev = self._engines.get(str(name))
            if prev is not None and prev.status not in ("fenced",
                                                        "removed"):
                raise ValueError(f"engine {name!r} already in the fleet")
            index = self._next_index
            self._next_index += 1
        if self.tracer is not None:
            batcher.tracer = self.tracer
        h = EngineHandle(name=str(name), batcher=batcher, state=state,
                         index=index, status="warming", role=role)
        if warm:
            h.state = batcher.warmup(h.state)
        h.status = "active"
        h.last_beat = self.clock()
        with self._lock:
            if prev is not None:          # a reused seat name retires
                self._retired.append(prev)
            self._engines[h.name] = h
            orphans, self._orphans = self._orphans, []
        self._registry.event("fleet_engine_added", engine=h.name,
                             index=h.index, role=h.role,
                             warmed=bool(warm))
        for req in orphans:
            self._submit_to(h, req)
        if orphans:
            self._registry.counter(
                "fleet_requests_rerouted",
                "requests moved between engines by cause").inc(
                len(orphans), cause="orphan")
        self._publish()
        return h

    def remove_engine(self, name: str) -> Dict[str, Any]:
        """Planned exit under the drain discipline: the engine leaves
        the placement pool, its queued + in-flight work snapshots and
        redistributes onto survivors through the SAME recovery path a
        failover uses (``resume_requests`` — recovered streams stay
        token-identical), and the seat lands in state ``removed``.
        Cause ``remove`` ticks ``fleet_requests_rerouted`` but not
        ``fleet_failovers`` and dumps no bundle: a planned exit is not
        a loss."""
        with self._lock:
            h = self._engines.get(str(name))
        if h is None or h.status in ("fenced", "removed"):
            raise ValueError(f"no live engine {name!r} to remove")
        h.status = "draining"
        recovered, source, path, targets = self._recover(h,
                                                         cause="remove")
        h.status = "removed"
        self._registry.event("fleet_engine_removed", engine=h.name,
                             source=source, snapshot=path,
                             recovered=[str(r.id) for r in recovered])
        self._publish()
        return {"engine": h.name, "source": source, "snapshot": path,
                "recovered": [r.id for r in recovered],
                "targets": targets}

    # -- placement -----------------------------------------------------------

    def _shedding(self, h: EngineHandle) -> bool:
        slo = h.batcher.slo
        return slo is not None and slo.should_shed()

    def _depth(self, h: EngineHandle) -> int:
        b = h.batcher
        return len(b.queue) + len(b.prefilling) + len(b.running)

    def _candidates(self) -> Tuple[List[EngineHandle], bool]:
        """(placement pool, all_shed): live engines minus the shedding
        ones; ``all_shed`` is True when live engines exist but every
        one has a latched shed — the fleet-wide refusal condition."""
        with self._lock:
            live = [h for h in self._engines.values()
                    if h.status in ("active", "stalled")]
        pool = [h for h in live if not self._shedding(h)]
        return pool, bool(live) and not pool

    def _admission_pool(self, pool: List[EngineHandle]
                        ) -> List[EngineHandle]:
        """Role filter for FRESH admissions (and replays, which
        re-enter through prefill): ``decode`` seats receive work only
        through the KV handoff — unless they are the only live seats
        left, because role is policy, not capability, and the
        zero-drop guarantee outranks the split. Under the
        colocated-fallback latch, ``colocated`` seats are preferred so
        prefill seats stop accumulating streams they cannot ship."""
        if self._fallback:
            colo = [h for h in pool if h.role == "colocated"]
            if colo:
                return colo
        front = [h for h in pool if h.role != "decode"]
        return front or pool

    def _place(self, pool: List[EngineHandle],
               prompt: Sequence[int]) -> EngineHandle:
        """Pick one engine from ``pool``. Stalled engines are
        deprioritized (used only when no active engine remains);
        ``affinity`` probes every candidate's prefix index and sends
        the request to the longest cached match, tie-broken (and
        missed entirely) by least queue depth."""
        active = [h for h in pool if h.status == "active"]
        pool = active or pool
        if self.placement == "round_robin":
            pool = sorted(pool, key=lambda h: h.index)
            h = pool[self._rr % len(pool)]
            self._rr += 1
            return h
        by_depth = lambda h: (self._depth(h), h.index)  # noqa: E731
        if self.placement == "affinity":
            scores = [(h.batcher.cache.prefix_match_len(prompt), h)
                      for h in pool]
            best = max(s for s, _ in scores)
            if best > 0:
                self._registry.counter(
                    "fleet_prefix_affinity_hits",
                    "placements routed to a cached prefix").inc()
                return min((h for s, h in scores if s == best),
                           key=by_depth)
        return min(pool, key=by_depth)

    def _submit_to(self, h: EngineHandle, request: Request) -> None:
        h.batcher.submit(request)
        tr = self.tracer
        if tr is not None and tr.enabled:
            tr.mark(request.id, "routed", self.clock(), engine=h.name)

    def submit(self, request: Request) -> Optional[str]:
        """Route one request; returns the chosen engine's name, or
        None on a fleet-wide shed — a STRUCTURED refusal
        (``reason="shedding"``) delivered through ``merge_results``,
        never a silent drop. With no engine seated at all, submitting
        is a programming error and raises."""
        now = self.clock()
        tr = self.tracer
        if tr is not None and tr.enabled:
            request.trace_id = tr.begin(
                request.id, t_submit=now, trace_id=request.trace_id,
                resumed_from=request.resumed_from)
        pool, all_shed = self._candidates()
        if all_shed:
            msg = ("every engine is shedding (latched SLO burn-rate "
                   "alert): fleet refuses admission")
            self._registry.counter(
                "fleet_shed",
                "admissions refused by a fleet-wide SLO shed").inc()
            self._registry.event("fleet_shed", request=str(request.id))
            if tr is not None and tr.enabled:
                tr.finish(request.id, "rejected", t=self.clock(),
                          error=msg)
            with self._lock:
                self._refused.append(RequestResult(
                    id=request.id, tokens=[], ttft_s=None, tpot_s=None,
                    finish_reason="error", error=msg,
                    reason="shedding"))
            return None
        if not pool:
            raise RuntimeError(
                "FleetRouter.submit: no live engine (add_engine first)")
        h = self._place(self._admission_pool(pool), request.prompt)
        self._submit_to(h, request)
        return h.name

    # -- stepping + health ---------------------------------------------------

    def _step_engine(self, h: EngineHandle, idx: int):
        """One engine step under the router's fault sites + retry.
        Every injection fires BEFORE the engine dispatch, so a retried
        attempt re-runs nothing — ``io:fleet_router`` transients are
        absorbed; :class:`~apex_tpu_torch.resilience.faults.EngineCrash` is
        on the give-up allowlist and re-raises from the first attempt
        (a dead engine is fenced, never retried)."""
        def attempt():
            faults.check("fleet_router")
            faults.maybe_engine_crash(idx, h.index)
            stall = faults.engine_stall_s(idx, h.index)
            if stall > 0.0:
                self.sleep(stall)     # alive, just heartbeat-stale
            return h.batcher.step(h.state)

        return retry_call(
            attempt, retries=self.step_retries,
            base_delay=self.retry_base_delay, jitter=0.0,
            retry_on=(faults.FaultError,),
            give_up_on=(faults.EngineCrash,), sleep=self.sleep,
            site="fleet_router")

    def step(self) -> Dict[str, Dict[str, Any]]:
        """One fleet iteration: step every live engine (idle ones are
        skipped), update heartbeats, hedge the stalled, fence and
        recover the dead. Returns ``{engine: step report}``."""
        idx = self.step_idx
        self.step_idx += 1
        reports: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            live = [h for h in self._engines.values()
                    if h.status in ("active", "stalled")]
        for h in live:
            if h.batcher.idle():
                h.status = "active"   # nothing left to be stalled ON
                h.last_beat = self.clock()
                continue
            t0 = self.clock()
            try:
                h.state, rep = self._step_engine(h, idx)
            except faults.EngineCrash as e:
                self._fence(h, idx, cause="crash", error=e)
                continue
            except Exception as e:  # noqa: BLE001 — health accounting
                h.step_failures += 1
                h.error = f"{type(e).__name__}: {str(e)[:200]}"
                self._registry.counter(
                    "fleet_engine_step_errors",
                    "engine step exceptions survived by the router"
                    ).inc(engine=h.name)
                if h.step_failures >= self.max_step_failures:
                    self._fence(h, idx, cause="wedged", error=e)
                continue
            now = self.clock()
            h.step_failures = 0
            h.error = None
            h.last_step_s = now - t0
            h.last_beat = now
            reports[h.name] = rep
            if h.last_step_s > self.stall_after_s:
                # heartbeat stale but the step RETURNED: the engine is
                # slow, not dead — hedge its queue, keep it seated
                if h.status != "stalled":
                    h.status = "stalled"
                    self._registry.event(
                        "fleet_engine_stalled", engine=h.name,
                        step_s=round(h.last_step_s, 6),
                        threshold_s=self.stall_after_s)
                self._hedge(h)
            elif h.status == "stalled":
                h.status = "active"
        if self._fallback:
            self._probe_handoff(idx)
        else:
            self._handoff_phase(idx)
        self._publish()
        return reports

    def _hedge(self, h: EngineHandle) -> None:
        """Bounded hedge for a stalled-but-alive engine: move up to
        ``hedge_max`` NOT-yet-admitted requests to a healthy peer.
        In-flight work stays put — the stream exists in exactly one
        place, so nothing can be duplicated. Each moved trace segment
        closes with outcome ``rerouted`` and continues (same trace id)
        on the peer. With no healthy peer, nothing moves."""
        with self._lock:
            peers = [p for p in self._engines.values()
                     if p is not h and p.status == "active"]
        peers = self._admission_pool(
            [p for p in peers if not self._shedding(p)])
        if not peers:
            return
        moved = h.batcher.take_queued(self.hedge_max)
        if not moved:
            return
        h.hedged += len(moved)
        tr = self.tracer
        now = self.clock()
        self._registry.counter(
            "fleet_requests_rerouted",
            "requests moved between engines by cause").inc(
            len(moved), cause="hedge")
        self._registry.event("fleet_engine_hedged", engine=h.name,
                             moved=[str(r.id) for r, _ in moved])
        for req, _ in moved:
            if tr is not None and tr.enabled:
                tr.finish(req.id, "rerouted", t=now, engine=h.name)
            self._submit_to(self._place(peers, req.prompt), req)

    # -- disaggregated KV handoff --------------------------------------------

    def _wire(self):
        """The handoff wire: a loopback Collective routed through
        ``telemetry.comms.instrument()``, so every shipped payload is
        priced by the wire-bytes model and lands in the comms ledger
        (per-op bytes/ms, timeline spans) whenever the comms plane is
        armed — and is the raw object, untouched, when it is not."""
        if self._wire_col is None:
            from apex_tpu_torch.resilience.guard import NullCollective
            self._wire_col = NullCollective()
        from apex_tpu_torch.telemetry import comms as _comms
        return _comms.instrument(self._wire_col)

    def _ship(self, k: np.ndarray, v: np.ndarray):
        out = self._wire().broadcast_from(0, [k, v])
        return np.asarray(out[0]), np.asarray(out[1])

    @staticmethod
    def _manifest(blocks: Sequence[int], k: np.ndarray, v: np.ndarray,
                  dtype: Optional[str] = None) -> Dict[str, Any]:
        """Per-block sha256 manifest of an exported payload. Hashes
        cover the k+v bytes of each block in payload order; ``root``
        keys the transfer (the idempotent re-send identity). ``dtype``
        names the pool's dtype where the payload's array type cannot
        (a bfloat16 pool ships ``uint16`` bits); default the array's."""
        per = [hashlib.sha256(
            np.ascontiguousarray(k[:, i]).tobytes()
            + np.ascontiguousarray(v[:, i]).tobytes()).hexdigest()
            for i in range(k.shape[1])]
        root = hashlib.sha256(",".join(per).encode()).hexdigest()
        return {"root": root, "blocks": per,
                "src_blocks": [int(b) for b in blocks],
                "shape": list(k.shape),
                "dtype": dtype if dtype is not None else str(k.dtype)}

    @staticmethod
    def _verify_blocks(manifest: Dict[str, Any], k: np.ndarray,
                       v: np.ndarray,
                       log: List[Dict[str, Any]]) -> List[int]:
        """Block-by-block manifest check of a RECEIVED payload;
        returns the corrupt block indices. ``log`` is overwritten with
        the attempt's per-block status (what the ``kv_handoff_failed``
        bundle embeds)."""
        bad: List[int] = []
        entries: List[Dict[str, Any]] = []
        for i, want in enumerate(manifest["blocks"]):
            got = hashlib.sha256(
                np.ascontiguousarray(k[:, i]).tobytes()
                + np.ascontiguousarray(v[:, i]).tobytes()).hexdigest()
            ok = got == want
            entries.append({"block": i, "ok": ok})
            if not ok:
                bad.append(i)
        log[:] = entries
        return bad

    def _transfer_once(self, hid: int, manifest: Dict[str, Any],
                       k: np.ndarray, v: np.ndarray,
                       verify_log: List[Dict[str, Any]]):
        """ONE wire attempt: ship the payload, apply the kv-transfer
        fault clauses to the RECEIVED copy, then verify every block
        against the manifest — verify-before-install, so a corrupt or
        truncated payload never reaches a pool. The raised FaultError
        re-sends the SAME export under the caller's retry: idempotent,
        because the source bytes are immutable for the transfer's
        lifetime and the manifest root names what must arrive."""
        fault = faults.kv_transfer_fault()
        if fault == "timeout":
            raise faults.FaultError(
                f"injected kv transfer timeout (handoff {hid})")
        rk, rv = self._ship(k, v)
        if fault == "corrupt":
            rk = np.array(rk, copy=True)
            if rk.nbytes:
                rk.view(np.uint8).reshape(-1)[0] ^= 0xFF
        elif fault == "partial":
            rk = np.array(rk, copy=True)
            rv = np.array(rv, copy=True)
            rk[:, -1] = 0
            rv[:, -1] = 0
        bad = self._verify_blocks(manifest, rk, rv, verify_log)
        if bad:
            raise faults.FaultError(
                f"kv handoff verify refused install (handoff {hid}, "
                f"manifest {manifest['root'][:12]}): corrupt blocks "
                f"{bad}")
        return rk, rv

    def _handoff_phase(self, idx: int) -> None:
        """Move every prefill-complete stream off the prefill seats.
        A seat with no live decode-capable sink keeps its flights —
        they decode locally on the next engine step (the colocated
        floor; never a stall, never a drop)."""
        with self._lock:
            srcs = [h for h in self._engines.values()
                    if h.status in ("active", "stalled")
                    and h.role == "prefill"]
            sinks = [h for h in self._engines.values()
                     if h.status in ("active", "stalled")
                     and h.role in ("decode", "colocated")]
        for src in srcs:
            if src.status not in ("active", "stalled"):
                continue          # fenced by an earlier handoff crash
            if not any(p.status in ("active", "stalled")
                       for p in sinks):
                continue
            for fl in src.batcher.take_prefilled():
                live = [p for p in sinks
                        if p.status in ("active", "stalled")]
                if not live or self._fallback:
                    src.batcher.running.append(fl)
                    continue
                pool = ([p for p in live if not self._shedding(p)]
                        or live)
                dst = min(pool,
                          key=lambda p: (self._depth(p), p.index))
                self._handoff(src, dst, fl, idx)

    def _handoff(self, src: EngineHandle, dst: EngineHandle, fl,
                 idx: int) -> bool:
        """One stream's handoff: export -> manifest -> wire (retried,
        verify-before-install) -> install on ``dst`` -> free the
        source reservation. Every failure rung keeps the stream alive
        (module docstring ladder); returns True on an installed
        handoff."""
        from apex_tpu_torch.telemetry import flight as _flight

        req = fl.req
        hid = self._handoff_seq
        self._handoff_seq += 1
        t0 = self.clock()
        handoffs = self._registry.counter(
            "fleet_handoffs", "KV handoffs attempted by outcome")
        # export length = filled KV rows: prefill of P tokens plus the
        # decode appends, minus the newest token whose KV row is the
        # NEXT append (scheduler position semantics)
        filled = len(req.prompt) + len(fl.generated) - 1
        try:
            blocks, k, v = src.batcher.cache.export_blocks(
                src.state, fl.seq_id, length=filled)
        except Exception as e:  # noqa: BLE001 — keep the stream local
            handoffs.inc(outcome="export_error")
            self.handoff_stats["export_error"] += 1
            self._registry.event(
                "fleet_handoff_export_error", request=str(req.id),
                src=src.name, error=f"{type(e).__name__}: {e}")
            src.batcher.running.append(fl)
            return False
        manifest = self._manifest(blocks, k, v,
                                  dtype=src.batcher.cache.dtype_name)
        payload_bytes = int(k.nbytes + v.nbytes)
        if faults.should_orphan_handoff():
            # the drill where the handoff is abandoned AFTER export
            # with the payload in flight: the exported blocks are
            # treated as tainted — freed into pending-scrub (dirty-
            # block rule: zeroed before reuse) — and the stream
            # re-prefills on a survivor
            src.batcher.cache.free(fl.seq_id, dirty=True)
            handoffs.inc(outcome="orphan")
            self.handoff_stats["orphan"] += 1
            self._registry.event(
                "fleet_handoff_orphan", request=str(req.id),
                src=src.name, handoff=hid, blocks=len(blocks))
            self._replay_flight(src, fl, cause="handoff_orphan",
                                tag=f"handoff_{hid:06d}")
            return False
        attempts = [0]
        verify_log: List[Dict[str, Any]] = []

        def attempt():
            attempts[0] += 1
            faults.check("kv_handoff")
            faults.maybe_engine_crash(idx, dst.index)
            return self._transfer_once(hid, manifest, k, v, verify_log)

        try:
            rk, rv = retry_call(
                attempt, retries=self.handoff_retries,
                base_delay=self.retry_base_delay, jitter=0.0,
                retry_on=(faults.FaultError, OSError),
                give_up_on=(faults.EngineCrash,), sleep=self.sleep,
                site="kv_handoff")
            dst.state = dst.batcher.install_prefilled(
                dst.state, req, fl.generated, rk, rv,
                t_submit=fl.t_submit, t_first=fl.t_first,
                t_last=fl.t_last)
        except faults.EngineCrash as e:
            # the decode seat died mid-handoff: fence it NOW
            # (EngineCrash is on the give-up allowlist, so fencing is
            # never delayed by backoff), then re-prefill the stream on
            # a survivor through the existing replay path
            self._note_handoff_retries(attempts[0])
            handoffs.inc(outcome="dst_crash")
            self.handoff_stats["dst_crash"] += 1
            self._fence(dst, idx, cause="crash", error=e)
            src.batcher.cache.free(fl.seq_id)
            self._replay_flight(src, fl, cause="handoff_dst_crash",
                                tag=f"handoff_{hid:06d}")
            return False
        except Exception as e:  # noqa: BLE001 — wire exhausted or
            # install refused (e.g. the sink's pool is full): the
            # source still holds valid KV, so the stream stays local
            # and decodes there — colocated degradation, zero drops
            self._note_handoff_retries(attempts[0])
            handoffs.inc(outcome="failed")
            self.handoff_stats["failed"] += 1
            ev = self._registry.event(
                "kv_handoff_failed", request=str(req.id),
                src=src.name, dst=dst.name, handoff=hid,
                attempts=attempts[0], manifest=manifest["root"],
                error=f"{type(e).__name__}: {e}")
            _flight.notify(
                "kv_handoff_failed", error=e, fleet=False,
                extra={"handoff": hid, "request": str(req.id),
                       "src": src.name, "dst": dst.name,
                       "attempts": attempts[0],
                       "manifest": {"root": manifest["root"],
                                    "blocks": manifest["blocks"],
                                    "shape": manifest["shape"]},
                       "verify": list(verify_log), "event": ev})
            tr = self.tracer
            if tr is not None and tr.enabled:
                tr.mark(req.id, "handoff_failed", self.clock(),
                        src=src.name, dst=dst.name,
                        attempts=attempts[0])
            src.batcher.running.append(fl)
            self._registry.counter(
                "fleet_requests_rerouted",
                "requests moved between engines by cause").inc(
                cause="handoff_degraded")
            self._handoff_failures += 1
            if (not self._fallback
                    and self._handoff_failures >= self.fallback_after):
                self._latch_fallback(idx)
            return False
        # verified install succeeded: release the source reservation
        # (clean — export was read-only), leaving the prompt prefix in
        # the source's content-addressed index for future affinity
        src.batcher.cache.free(fl.seq_id)
        now = self.clock()
        self._handoff_failures = 0
        src.handoffs_out += 1
        dst.handoffs_in += 1
        handoffs.inc(outcome="ok")
        self.handoff_stats["ok"] += 1
        self.handoff_stats["bytes"] += payload_bytes
        self._registry.counter(
            "fleet_handoff_bytes",
            "KV payload bytes moved by successful handoffs").inc(
            payload_bytes)
        self._note_handoff_retries(attempts[0])
        tr = self.tracer
        if tr is not None and tr.enabled:
            tr.span(req.id, "handoff", t0, now - t0, src=src.name,
                    dst=dst.name, blocks=len(blocks),
                    bytes=payload_bytes, attempts=attempts[0],
                    manifest=manifest["root"][:12])
            tr.mark(req.id, "routed", now, engine=dst.name)
        return True

    def _note_handoff_retries(self, attempts: int) -> None:
        n = int(attempts) - 1
        if n > 0:
            self.handoff_stats["retries"] += n
            self._registry.counter(
                "fleet_handoff_retries",
                "extra wire attempts spent by KV handoffs").inc(n)

    def _replay_flight(self, src: EngineHandle, fl, *, cause: str,
                       tag: str) -> None:
        """Re-prefill a surrendered flight on a survivor through the
        existing replay path: the replay prompt is
        ``prompt + generated`` and ``max_new_tokens`` shrinks by what
        was already generated — the counter-based per-request PRNG
        makes the recovered stream token-identical — with the same
        trace id continuing the request's single track and
        ``resumed_from`` naming the handoff. ``merge_results``
        stitches the prior tokens back. Affinity usually lands the
        replay on the source itself (its prompt prefix is still in
        the index), where the prefix cache makes the re-prefill
        nearly free."""
        req = fl.req
        prior = [int(t) for t in fl.generated]
        replay = Request(
            id=req.id, prompt=[int(t) for t in req.prompt] + prior,
            max_new_tokens=int(req.max_new_tokens) - len(prior),
            eos_id=req.eos_id, deadline_ms=req.deadline_ms,
            temperature=req.temperature, top_k=req.top_k,
            top_p=req.top_p, seed=req.seed, trace_id=req.trace_id,
            resumed_from=tag)
        tr = self.tracer
        now = self.clock()
        if tr is not None and tr.enabled:
            tr.finish(req.id, "rerouted", t=now, engine=src.name,
                      cause=cause)
        with self._lock:
            self._prior[req.id] = (self._prior.get(req.id, [])
                                   + prior)
            pool = [p for p in self._engines.values()
                    if p.status in ("active", "stalled")]
        self._registry.counter(
            "fleet_requests_rerouted",
            "requests moved between engines by cause").inc(cause=cause)
        if pool:
            open_pool = self._admission_pool(
                [p for p in pool if not self._shedding(p)] or pool)
            self._submit_to(self._place(open_pool, replay.prompt),
                            replay)
        else:
            with self._lock:
                self._orphans.append(replay)

    def _latch_fallback(self, idx: int) -> None:
        """``fallback_after`` consecutive transfer failures close the
        colocated-fallback latch: handoffs stop (prefill seats keep
        their streams and decode them locally), fresh admissions
        prefer colocated seats, and every fleet step runs ONE healthy
        probe transfer through the same wire+verify path — the first
        clean probe auto-unlatches."""
        self._fallback = True
        self._fallback_step = idx
        self._registry.counter(
            "fleet_colocated_fallback",
            "colocated-fallback latch transitions").inc(
            transition="latched")
        self._registry.event(
            "fleet_colocated_fallback", transition="latched",
            reason="handoff_degraded", router_step=idx,
            consecutive_failures=self._handoff_failures)

    def _probe_handoff(self, idx: int) -> None:
        """One health probe per latched fleet step: a synthetic
        one-block payload through the SAME fault sites, wire, and
        manifest verify a real handoff uses. A clean probe reopens
        the latch; a failed one leaves the fleet colocated."""
        with self._lock:
            live = [h for h in self._engines.values()
                    if h.status in ("active", "stalled")]
        src = (next((h for h in live if h.role == "prefill"), None)
               or (live[0] if live else None))
        if src is None:
            return
        c = src.batcher.cache
        shape = (c.num_layers, 1, c.block_size, c.kv_heads, c.head_dim)
        # non-zero probe bytes: a zeroed-tail (partial) wire must not
        # hash clean and unlatch a still-degraded fleet
        k = np.ones(shape, np.float32)
        v = np.ones(shape, np.float32)
        manifest = self._manifest([0], k, v)
        probes = self._registry.counter(
            "fleet_handoff_probes",
            "colocated-fallback health probes by outcome")
        try:
            faults.check("kv_handoff")
            self._transfer_once(-1, manifest, k, v, [])
        except Exception:  # noqa: BLE001 — still degraded, stay latched
            probes.inc(outcome="failed")
            return
        probes.inc(outcome="ok")
        self._fallback = False
        self._fallback_step = None
        self._handoff_failures = 0
        self._registry.counter(
            "fleet_colocated_fallback",
            "colocated-fallback latch transitions").inc(
            transition="unlatched")
        self._registry.event(
            "fleet_colocated_fallback", transition="unlatched",
            router_step=idx)

    # -- failover ------------------------------------------------------------

    def _fence(self, h: EngineHandle, idx: int, *, cause: str,
               error: Optional[BaseException]) -> None:
        """Fence a dead (``crash``) or wedged engine and recover its
        work onto survivors. The ``fleet_engine_lost`` bundle embeds
        the engine's LAST introspect plus the structured recovery
        plan — the postmortem opens with the victim's final state and
        where every request went."""
        from apex_tpu_torch.telemetry import flight as _flight

        h.status = "fenced"
        if error is not None:
            h.error = f"{type(error).__name__}: {str(error)[:200]}"
        try:
            last_intro = h.batcher.introspect()
        except Exception:  # noqa: BLE001 — a wedged engine may not even
            last_intro = None
        t0 = self.clock()
        recovered, source, path, targets = self._recover(h, cause=cause)
        recover_s = self.clock() - t0
        self._registry.counter(
            "fleet_failovers",
            "engines fenced and recovered by cause").inc(cause=cause)
        plan = {"engine": h.name, "cause": cause, "source": source,
                "snapshot": path,
                "recovered": [str(r.id) for r in recovered],
                "targets": targets}
        ev = self._registry.event(
            "fleet_engine_lost", engine=h.name, cause=cause,
            router_step=idx, source=source, snapshot=path,
            recovered=[str(r.id) for r in recovered])
        _flight.notify("fleet_engine_lost", error=error, fleet=False,
                       extra={"engine": h.name, "cause": cause,
                              "last_introspect": last_intro,
                              "plan": plan, "event": ev})
        self.failovers.append({
            "engine": h.name, "cause": cause, "router_step": idx,
            "source": source, "snapshot": path,
            "recovered": [r.id for r in recovered],
            "recover_s": recover_s, "t": self.clock()})
        self._publish()

    def _recover(self, h: EngineHandle, *, cause: str):
        """Recover a fenced/draining engine's queued + in-flight work;
        returns ``(requests, source, snapshot_path, targets)``.

        The decision table: a committed
        drain snapshot is reused as-is; otherwise one is saved NOW
        under ``snapshot_dir/<engine>/`` (retry-wrapped — transient
        disk errors back off, :class:`SnapshotError` gives up at once:
        deterministic); if no snapshot is usable (no dir, save failed,
        or ``router_snapshot_missing`` forced it) the payload is built
        IN MEMORY from the engine's live entries and the work replays
        from prompt + generated-so-far. Both branches funnel through
        :func:`resume_requests`, so the recovered stream is
        token-identical either way (counter-based PRNG). Each dead
        trace segment closes as ``drained``; the survivor's ``begin``
        continues the same trace id with ``resumed_from`` set."""
        fail_idx = self._recoveries
        self._recoveries += 1
        path: Optional[str] = None
        payload: Optional[Dict[str, Any]] = None
        source = "snapshot"
        if not faults.should_skip_router_snapshot(fail_idx):
            if h.batcher.drained_snapshot is not None:
                path = h.batcher.drained_snapshot
            elif self.snapshot_dir is not None:
                try:
                    path = retry_call(
                        _sresil.save_snapshot, h.batcher,
                        os.path.join(self.snapshot_dir, h.name),
                        step=h.batcher.step_idx,
                        reason=f"fleet recovery ({cause})",
                        retries=self.step_retries,
                        base_delay=self.retry_base_delay, jitter=0.0,
                        retry_on=(OSError,),
                        give_up_on=(_sresil.SnapshotError,),
                        sleep=self.sleep, site="fleet_snapshot")
                except Exception:  # noqa: BLE001 — degrade to replay
                    path = None
            if path is not None:
                try:
                    payload = _sresil.load_snapshot(path)
                except _sresil.SnapshotError:
                    payload, path = None, None
        if payload is None:
            source = "replay"
            payload = {"format": _sresil.SNAPSHOT_FORMAT,
                       "step": h.batcher.step_idx,
                       "requests": h.batcher._snapshot_entries()}
        requests, prior = _sresil.resume_requests(payload)
        # fence the seat against stragglers: a late submit() to this
        # batcher now refuses with the structured `draining` reason
        h.batcher.draining = True
        tr = self.tracer
        now = self.clock()
        for req in requests:
            if tr is not None and tr.enabled:
                tr.drained(req.id, now, snapshot=path)
        with self._lock:
            for rid, toks in prior.items():
                self._prior[rid] = self._prior.get(rid, []) + list(toks)
            pool = [p for p in self._engines.values()
                    if p is not h and p.status in ("active", "stalled")]
        targets: Dict[str, Optional[str]] = {}
        for req in requests:
            if pool:
                # recovery overrides shed deprioritization: refusing
                # already-accepted work would BE the silent drop
                open_pool = self._admission_pool(
                    [p for p in pool if not self._shedding(p)] or pool)
                t = self._place(open_pool, req.prompt)
                self._submit_to(t, req)
                targets[str(req.id)] = t.name
            else:
                with self._lock:
                    self._orphans.append(req)
                targets[str(req.id)] = None
        if requests:
            self._registry.counter(
                "fleet_requests_rerouted",
                "requests moved between engines by cause").inc(
                len(requests), cause=cause)
        return requests, source, path, targets

    # -- results + views -----------------------------------------------------

    def merge_results(self) -> List[RequestResult]:
        """Drain every engine (fenced seats included — results that
        finished before a death must still reach the caller) plus the
        router's own structured refusals, stitching recovered streams
        back together: each resumed result's tokens become
        ``prior + tokens``, so the caller sees the FULL stream,
        token-identical to an uninterrupted run."""
        with self._lock:
            out, self._refused = self._refused, []
            handles = list(self._engines.values()) + list(self._retired)
        for h in handles:
            out.extend(h.batcher.drain())
        merged = _sresil.merge_results(out, self._prior)
        with self._lock:
            for r in merged:
                self._prior.pop(r.id, None)
        return merged

    def idle(self) -> bool:
        with self._lock:
            if self._orphans:
                return False
            live = [h for h in self._engines.values()
                    if h.status in ("warming", "active", "stalled")]
        return all(h.batcher.idle() for h in live)

    def introspect(self) -> Dict[str, Any]:
        """The live fleet view (``fleet_engine_lost`` bundles embed the
        victim's last one):
        per-engine health + nested engine introspects, the failover
        log, and the router's routing posture."""
        now = self.clock()
        with self._lock:
            handles = list(self._engines.values())
            orphans = len(self._orphans)
            refused = len(self._refused)
        engines: Dict[str, Any] = {}
        for h in handles:
            try:
                intro = h.batcher.introspect()
            except Exception:  # noqa: BLE001 — a dead engine may not
                intro = None
            engines[h.name] = {
                "status": h.status, "index": h.index,
                "role": h.role,
                "heartbeat_age_s": round(now - h.last_beat, 6),
                "last_step_s": round(h.last_step_s, 6),
                "step_failures": h.step_failures,
                "hedged": h.hedged, "error": h.error,
                "handoffs_out": h.handoffs_out,
                "handoffs_in": h.handoffs_in,
                "shedding": (self._shedding(h)
                             if h.status in ("active", "stalled")
                             else False),
                "engine": intro,
            }
        return {"step": self.step_idx, "placement": self.placement,
                "stall_after_s": self.stall_after_s,
                "engines": engines, "orphans": orphans,
                "refused_pending": refused,
                "handoff": {
                    **{k: int(n)
                       for k, n in self.handoff_stats.items()},
                    "fallback": {
                        "latched": self._fallback,
                        "since_step": self._fallback_step,
                        "consecutive_failures": self._handoff_failures,
                    }},
                "failovers": [dict(f) for f in self.failovers]}

    def _publish(self) -> None:
        reg = self._registry
        with self._lock:
            handles = (list(self._engines.values())
                       + list(self._retired))
        counts = {s: 0 for s in ENGINE_STATES}
        for h in handles:
            counts[h.status] = counts.get(h.status, 0) + 1
        g = reg.gauge("fleet_engines", "engines by lifecycle state")
        for state, n in counts.items():
            g.set(n, state=state)
        up = reg.gauge("fleet_engine_up",
                       "1 while the engine is serving traffic")
        step_s = reg.gauge("fleet_engine_step_seconds",
                           "wall seconds of the engine's last step")
        depth = reg.gauge("fleet_engine_queue_depth",
                          "requests queued on the engine")
        for h in handles:
            up.set(1.0 if h.status in ("active", "stalled") else 0.0,
                   engine=h.name)
            step_s.set(h.last_step_s, engine=h.name)
            depth.set(len(h.batcher.queue), engine=h.name)
        reg.gauge(
            "fleet_colocated_fallback_latched",
            "1 while the colocated-fallback latch is closed").set(
            1.0 if self._fallback else 0.0)


def fleet_serve_loop(router: FleetRouter, requests: Sequence[Request],
                     *, arrivals: Optional[Sequence[float]] = None,
                     clock: Callable[[], float] = time.perf_counter,
                     sleep: Callable[[float], None] = time.sleep):
    """Drive the fleet over an arrival schedule until every request
    resolves (finished, recovered-and-finished, or structurally
    refused); returns the merged results. The fleet analog of
    ``serve_loop`` — same arrival semantics, but the router (not one
    engine) owns admission, and a mid-run engine death resolves
    through failover instead of ending the loop."""
    order = sorted(range(len(requests)),
                   key=lambda i: arrivals[i] if arrivals else 0.0)
    t0 = clock()
    results: List[RequestResult] = []
    i = 0
    while i < len(order) or not router.idle():
        if not any(h.status in ("active", "stalled")
                   for h in router.engines()):
            raise RuntimeError(
                "fleet_serve_loop: no serviceable engine left and "
                "work is still pending")
        now = clock() - t0
        while (i < len(order)
               and (not arrivals or arrivals[order[i]] <= now)):
            router.submit(requests[order[i]])
            i += 1
        if router.idle():
            if i < len(order):
                sleep(max(0.0, min(arrivals[order[i]] - now, 0.001)))
            continue
        router.step()
        results.extend(router.merge_results())
    results.extend(router.merge_results())
    return results


__all__ = [
    "ENGINE_ROLES",
    "ENGINE_STATES",
    "EngineHandle",
    "FleetRouter",
    "fleet_serve_loop",
]
