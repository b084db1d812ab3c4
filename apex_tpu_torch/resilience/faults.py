"""Deterministic fault injection: the ``APEX_TPU_FAULTS`` grammar.

Counterpart of ``apex_tpu/resilience/faults.py``. The grammar is the
reference's, clause for clause and under the same environment knob, so
one clause string means the same thing in both packages: every clause
parses into the same field, including those whose sites (training
arrays, checkpoints, collectives, the fleet router) the port has not
ported yet; their decisions come with their sites. The port decides for
the call-indexed sites (:func:`check`), the serving sites
(:func:`maybe_sigterm`, :func:`should_pool_exhaust`,
:func:`maybe_decode_exception`, :func:`maybe_prefill_chunk_exception`,
:func:`nonfinite_lane_at`, :func:`should_snapshot_corrupt`,
:func:`should_weight_swap_mismatch`), the fleet router's
(:func:`maybe_engine_crash`, :func:`engine_stall_s`,
:func:`should_skip_router_snapshot`, :func:`kv_transfer_fault`,
:func:`should_orphan_handoff`), the comms plane's
(:func:`collective_delay_s`, :func:`should_corrupt_collective`) and the
MoE router-collapse drill's decision (:func:`should_collapse_router`,
whose site comes with the MoE train step).

Injection is *site + counter* based: components call
``faults.check("site")`` at their fault points, and the active
:class:`FaultInjector` raises at the call indices the plan names.
Sites wired into the port: ``record_write`` / ``record_fsync``
(``records.write_record``), ``serving_snapshot``
(``serving.resilience.save_snapshot``), ``fleet_router`` and
``kv_handoff`` (``serving.fleet``), ``collective``
(``telemetry.comms``), ``decode_step`` and
``prefill_chunk`` (the scheduler's dispatches).

Env knob grammar (semicolon-separated clauses)::

    APEX_TPU_FAULTS="nan_grads=3,4;nan_leaf=2;io:device_put=0,1;
                     io_permanent:record_write=5;truncate=12;crash=7"

- ``nan_grads=<steps>``          poison the flat gradient at these steps
- ``nan_leaf=<i>``               which leaf to poison (default: element 0)
- ``io:<site>=<indices>``        transient ``FaultError`` at these call
                                 indices of ``site`` (0-based)
- ``io_permanent:<site>=<k>``    every call of ``site`` from index ``k``
                                 on raises (a dead disk / dead transport)
- ``truncate=<steps>``           truncate the checkpoint payload written
                                 at these steps AFTER it is finalized
                                 (simulated on-disk corruption)
- ``crash=<steps>``              ``SimulatedCrash`` from
                                 ``maybe_crash`` at these steps
- ``data_stall_ms=<ms>``         sleep ``ms`` inside the
                                 ``PrefetchLoader`` worker's
                                 host->device transfer — the consumer
                                 blocks in its ``data_wait`` span, so
                                 the goodput drill can assert the
                                 stalled seconds land in the ledger's
                                 ``data_wait`` bucket, not
                                 ``unattributed``
- ``ckpt_stall_ms=<ms>``         sleep ``ms`` inside the checkpoint
                                 payload write — inside the timed save,
                                 so the stall lands in
                                 ``checkpoint_save``

Distributed sites (the guard/quorum tier, docs/resilience.md):

- ``bit_flip=<steps>``           flip ONE bit of the flat master at
                                 these steps (silent data corruption)
- ``bit_flip_replica=<r>``       only on replica/process ``r``
                                 (default: every replica)
- ``bit_flip_leaf=<i>``          which parameter leaf takes the flip
                                 (default: element 0 of the buffer)
- ``crash_before_commit=<steps>`` ``SimulatedCrash`` inside a host's
                                 quorum-checkpoint save, after the step
                                 dir is claimed but before the host's
                                 shard lands — the coordinator must
                                 time out, refuse the commit, and the
                                 partial host-set must never be resumed
- ``sigterm=<steps>``            deliver a REAL ``SIGTERM`` to this
                                 process at these steps (exercises the
                                 async-signal preemption path)

Elastic-resharding sites (resilience/elastic.py, docs/resilience.md
"Elastic resume"):

- ``shard_truncate=<steps>``     truncate one host's ELASTIC shard
                                 payload AFTER the coordinator's
                                 commit lands — a committed-but-rotten
                                 range the restore path must refuse
- ``shard_truncate_host=<h>``    which host's shard the coordinator
                                 truncates (default: host 0)
- ``world_mismatch=<steps>``     the coordinator records an
                                 inconsistent layout manifest (claimed
                                 world != the committed ranges) — the
                                 restore planner must detect it
- ``range_fetch_timeout=<idx>``  the elastic restore's peer fetch at
                                 these 0-based fetch indices times out;
                                 the planner must fall back to disk

Comms-plane sites (telemetry/comms.py instrumented collectives,
docs/observability.md "Comms & sharding plane"):

- ``io:collective=<idx>``        transient ``FaultError`` raised out of
                                 the traced collective op at these
                                 0-based call indices (every traced op
                                 counts — barriers included)
- ``collective_slow=<ms>``       add a ``ms`` delay to traced
                                 collective ops — the deterministic
                                 slow-interconnect drill behind the
                                 ``collective_slow`` EWMA escalation
- ``collective_slow_at=<idx>``   restrict the injected delay to these
                                 0-based traced-op indices (default:
                                 every op once ``collective_slow`` is
                                 set — set late indices so the EWMA
                                 warms up on healthy ops first)
- ``collective_payload_corrupt=<idx>`` flip ONE byte of the result of
                                 the payload-carrying traced op
                                 (all_gather / broadcast_from) at
                                 these 0-based payload-op indices —
                                 silent wire corruption the consumer
                                 (guard fingerprints, elastic verify)
                                 must catch

Serving sites (``serving/scheduler.py``):

- ``serving_pool_exhausted=<steps>`` admission control at these engine
                                 steps behaves as if the KV pool were
                                 empty — the scheduler must shed load
                                 to the queue, keep in-flight decodes
                                 running, and dump a flight bundle
- ``decode_step_exception=<steps>`` the decode dispatch at these
                                 engine steps raises ``FaultError`` —
                                 the scheduler's binary-split isolation
                                 retries the batch; a step-level fault
                                 fails every sub-dispatch too, so the
                                 whole batch quarantines (blocks freed,
                                 ``serving_quarantine`` bundle, queue
                                 keeps serving). ``io:decode_step``
                                 injects by CALL index instead — a
                                 single transient index is absorbed by
                                 the retry with ZERO quarantines
- ``decode_nonfinite=<steps>``   poison ONE batch lane's cached K/V
                                 with NaN before the decode dispatch at
                                 these engine steps — the lane's logits
                                 come out nonfinite through the REAL
                                 attention path and the engine must
                                 quarantine only that sequence
- ``decode_nonfinite_lane=<i>``  which in-flight lane takes the NaN
                                 (default: lane 0)
- ``prefill_chunk_exception=<idx>`` the chunk-prefill dispatch number
                                 ``idx`` (0-based, per engine; the
                                 binary-split retries re-check the
                                 SAME index) raises ``FaultError`` —
                                 the whole chunk batch quarantines
                                 and the engine keeps serving.
                                 ``io:prefill_chunk`` injects by CALL
                                 index instead: one transient index
                                 is absorbed by the split retry with
                                 zero quarantines
- ``serving_snapshot_corrupt=<idx>`` truncate the serving drain
                                 snapshot payload AFTER it is finalized
                                 at these 0-based save indices — the
                                 committed-but-rotten snapshot
                                 ``latest_snapshot`` must refuse
- ``weight_swap_mismatch=<idx>`` force ``swap_weights`` validation to
                                 report a signature mismatch at these
                                 0-based swap indices — drills the
                                 structured-rejection path end to end

Fleet-router sites (the reference's ``serving/fleet.py``):

- ``engine_crash=<steps>``       :class:`EngineCrash` out of the
                                 router's per-engine step dispatch at
                                 these ROUTER steps — a router-visible
                                 hard engine death the router must
                                 fence (never retry) and recover from
- ``engine_crash_engine=<i>``    which engine (0-based join order)
                                 ``engine_crash`` kills (default: 0)
- ``engine_stall_ms=<ms>``       sleep ``ms`` inside the target
                                 engine's step dispatch — its
                                 heartbeat goes stale while the engine
                                 stays ALIVE; the router must hedge
                                 its queued work, not fence it
- ``engine_stall_engine=<i>``    which engine stalls (default: 0)
- ``engine_stall_at=<steps>``    restrict the stall to these router
                                 steps (default: every step)
- ``router_snapshot_missing=<idx>`` the router's recovery number
                                 ``idx`` (0-based, per router) finds
                                 NO usable drain snapshot — forcing
                                 the replay-from-prompt+generated
                                 recovery path
- ``io:fleet_router``            transient ``FaultError`` at the
                                 router's per-engine step site (call
                                 indexed) — absorbed by the router's
                                 ``resilience.retry`` backoff

KV-handoff sites (the reference's disaggregated prefill/decode):

- ``kv_transfer_corrupt=<idx>``  flip ONE byte of the received KV
                                 payload at these 0-based transfer
                                 attempts (each attempt advances the
                                 counter) — the per-block sha256
                                 verify must refuse the install and
                                 the retry re-sends the SAME manifest
- ``kv_transfer_timeout=<idx>``  the transfer attempt raises a
                                 transient ``FaultError`` before any
                                 bytes move (a hung wire) — absorbed
                                 by the handoff's ``resilience.retry``
                                 backoff
- ``kv_transfer_partial=<idx>``  zero the received payload's tail
                                 block at these transfer attempts — a
                                 torn transfer the block-by-block
                                 verify must catch BEFORE install
- ``handoff_orphan=<idx>``       abandon handoff number ``idx``
                                 after export (as if the decode
                                 target died holding the payload) —
                                 the source's exported blocks must be
                                 freed and scrubbed under the
                                 dirty-block rule and the request
                                 re-prefilled on a survivor
- ``io:kv_handoff=<idx>``        transient ``FaultError`` at the
                                 handoff transfer site (call indexed)
                                 — the generic transient-wire drill,
                                 absorbed by the same retry policy

MoE workload-plane sites (the reference's ``MeshTrainStep``):

- ``moe_router_collapse=<steps>`` zero every MoE gate kernel in the
                                 flat master BEFORE the train-step
                                 dispatch at these steps — all router
                                 logits tie, top-k's deterministic
                                 tie-break routes EVERY token to
                                 experts 0..k-1. The Switch aux loss
                                 stays at its balanced value (uniform
                                 probs), so the drill proves the
                                 ``moe_expert_load`` histogram + the
                                 ``moe_imbalance`` EWMA latch are the
                                 detector, not the loss
- ``moe_expert_dead=<idx>``      zero expert ``idx``'s down-projection
                                 (``w2``) in the flat master before
                                 every dispatch while the plan is
                                 active — the expert still receives
                                 its tokens and contributes nothing
                                 (a dead shard host); loss degrades
                                 while routing stays balanced
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
from typing import Any, Dict, FrozenSet, Optional

ENV_KNOB = "APEX_TPU_FAULTS"


class FaultError(OSError):
    """An injected I/O failure (an ``OSError`` so the same retry
    policies that absorb real transient I/O absorb injected ones)."""


class SimulatedCrash(RuntimeError):
    """An injected process death (kill-and-resume tests raise and catch
    this where a real run would be SIGKILLed / preempted)."""


class EngineCrash(RuntimeError):
    """An injected router-visible hard engine death (the
    ``engine_crash`` clause). Deliberately NOT an ``OSError``: the
    fleet router's transient-retry policy must never retry it — a dead
    engine is fenced and its work recovered, immediately."""


def _int_set(val: str) -> FrozenSet[int]:
    return frozenset(int(v) for v in val.split(",") if v.strip() != "")


@dataclasses.dataclass
class FaultInjector:
    """A deterministic fault plan. All counters are call-order based;
    two identical runs inject at identical points. Every clause parses
    into its field; the decisions are those of the sites the port has:
    the call-indexed ``io:`` / ``io_permanent:`` sites, the serving and
    fleet sites and the comms plane's."""

    nan_grad_steps: FrozenSet[int] = frozenset()
    nan_leaf: Optional[int] = None          # None -> poison element 0
    # site -> 0-based call indices that raise a transient FaultError
    io_errors: Dict[str, FrozenSet[int]] = dataclasses.field(
        default_factory=dict)
    # site -> first call index from which EVERY call raises
    io_permanent_from: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    truncate_steps: FrozenSet[int] = frozenset()
    crash_steps: FrozenSet[int] = frozenset()
    # distributed sites
    bit_flip_steps: FrozenSet[int] = frozenset()
    bit_flip_replica: Optional[int] = None   # None -> every replica
    bit_flip_leaf: Optional[int] = None      # None -> buffer element 0
    crash_before_commit_steps: FrozenSet[int] = frozenset()
    sigterm_steps: FrozenSet[int] = frozenset()
    # elastic-resharding sites (resilience/elastic.py)
    shard_truncate_steps: FrozenSet[int] = frozenset()
    shard_truncate_host: int = 0
    world_mismatch_steps: FrozenSet[int] = frozenset()
    range_fetch_timeout: FrozenSet[int] = frozenset()
    # comms-plane sites (telemetry/comms.py instrumented collectives)
    collective_slow_ms: float = 0.0
    collective_slow_at: FrozenSet[int] = frozenset()
    collective_corrupt_indices: FrozenSet[int] = frozenset()
    # serving sites (serving/scheduler.py, serving/resilience.py)
    pool_exhausted_steps: FrozenSet[int] = frozenset()
    decode_exception_steps: FrozenSet[int] = frozenset()
    prefill_chunk_exception_indices: FrozenSet[int] = frozenset()
    decode_nonfinite_steps: FrozenSet[int] = frozenset()
    decode_nonfinite_lane: int = 0
    snapshot_corrupt_indices: FrozenSet[int] = frozenset()
    weight_swap_mismatch_indices: FrozenSet[int] = frozenset()
    # fleet-router sites
    engine_crash_steps: FrozenSet[int] = frozenset()
    engine_crash_engine: int = 0
    engine_stall_ms: float = 0.0
    engine_stall_engine: int = 0
    engine_stall_at: FrozenSet[int] = frozenset()
    router_snapshot_missing: FrozenSet[int] = frozenset()
    # kv-handoff sites
    kv_transfer_corrupt: FrozenSet[int] = frozenset()
    kv_transfer_timeout: FrozenSet[int] = frozenset()
    kv_transfer_partial: FrozenSet[int] = frozenset()
    handoff_orphan: FrozenSet[int] = frozenset()
    # MoE workload-plane sites (mesh/mesh.py MeshTrainStep)
    moe_router_collapse_steps: FrozenSet[int] = frozenset()
    moe_expert_dead: Optional[int] = None
    # goodput-drill stall sites (telemetry/goodput.py run ledger)
    data_stall_ms: float = 0.0
    ckpt_stall_ms: float = 0.0

    def __post_init__(self):
        self._counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    # -- site/counter I/O faults ------------------------------------------

    def count(self, site: str) -> int:
        """Calls of ``site`` seen so far."""
        with self._lock:
            return self._counts.get(site, 0)

    def check(self, site: str) -> None:
        """Record one call of ``site``; raise if the plan says so."""
        with self._lock:
            idx = self._counts.get(site, 0)
            self._counts[site] = idx + 1
        perm = self.io_permanent_from.get(site)
        if perm is not None and idx >= perm:
            raise FaultError(
                f"injected permanent I/O failure at {site}[{idx}]")
        if idx in self.io_errors.get(site, frozenset()):
            raise FaultError(
                f"injected transient I/O failure at {site}[{idx}]")

    # -- serving sites -----------------------------------------------------

    def should_pool_exhaust(self, step: int) -> bool:
        """True when the serving scheduler's admission control at
        engine step ``step`` must behave as if the KV pool were empty
        (the deterministic shed-load drill)."""
        return int(step) in self.pool_exhausted_steps

    def maybe_decode_exception(self, step: int) -> None:
        """Raise a :class:`FaultError` out of the serving decode
        dispatch at planned engine steps — the deterministic stand-in
        for a dead device / crashed compile mid-serve."""
        if int(step) in self.decode_exception_steps:
            raise FaultError(
                f"injected decode-step exception at engine step "
                f"{int(step)}")

    def maybe_prefill_chunk_exception(self, index: int) -> None:
        """Raise a :class:`FaultError` out of the serving chunk-prefill
        dispatch number ``index`` (0-based, per engine). The scheduler
        passes the TOP-LEVEL dispatch index down through its
        binary-split retries, so a planned index fails every
        sub-dispatch — the whole chunk batch quarantines, mirroring
        ``decode_step_exception``."""
        if int(index) in self.prefill_chunk_exception_indices:
            raise FaultError(
                f"injected prefill-chunk exception at dispatch "
                f"{int(index)}")

    def nonfinite_lane_at(self, step: int) -> Optional[int]:
        """In-flight lane whose cached K/V the serving engine poisons
        with NaN before the decode dispatch at ``step`` (the lane's
        logits then come out nonfinite through the real attention
        path), or None off-plan."""
        if int(step) in self.decode_nonfinite_steps:
            return int(self.decode_nonfinite_lane)
        return None

    def should_snapshot_corrupt(self, index: int) -> bool:
        """True when the serving drain snapshot save number ``index``
        (0-based, per engine) must be truncated AFTER finalize — the
        committed-but-rotten snapshot the loader must refuse."""
        return int(index) in self.snapshot_corrupt_indices

    def should_weight_swap_mismatch(self, index: int) -> bool:
        """True when ``swap_weights`` call number ``index`` (0-based,
        per engine) must report a forced signature mismatch."""
        return int(index) in self.weight_swap_mismatch_indices

    # -- comms-plane sites -------------------------------------------------

    def collective_delay_s(self) -> float:
        """Seconds of injected delay for THIS traced collective op
        (each call advances the 0-based traced-op index;
        ``collective_slow_at`` empty means every op once
        ``collective_slow_ms`` is set). 0.0 off-plan."""
        with self._lock:
            idx = self._counts.get("collective_slow", 0)
            self._counts["collective_slow"] = idx + 1
        if self.collective_slow_ms <= 0.0:
            return 0.0
        if self.collective_slow_at and idx not in self.collective_slow_at:
            return 0.0
        return self.collective_slow_ms / 1e3

    def should_corrupt_collective(self) -> bool:
        """True when THIS payload-carrying traced op (all_gather /
        broadcast_from; each call advances the 0-based payload-op
        index) must have one result byte flipped."""
        with self._lock:
            idx = self._counts.get("collective_corrupt", 0)
            self._counts["collective_corrupt"] = idx + 1
        return idx in self.collective_corrupt_indices

    # -- fleet-router sites ------------------------------------------------

    def maybe_engine_crash(self, step: int, engine: int) -> None:
        """Raise :class:`EngineCrash` out of the fleet router's step
        dispatch for engine ``engine`` (0-based join order) at planned
        ROUTER steps — the deterministic hard-death drill behind the
        router's fence-and-recover path."""
        if (int(step) in self.engine_crash_steps
                and int(engine) == self.engine_crash_engine):
            raise EngineCrash(
                f"injected engine crash: engine {int(engine)} at "
                f"router step {int(step)}")

    def engine_stall_s(self, step: int, engine: int) -> float:
        """Seconds of injected stall for engine ``engine``'s step
        dispatch at router step ``step`` (``engine_stall_at`` empty
        means every step once ``engine_stall_ms`` is set). The engine
        stays alive — its heartbeat just goes stale, so the router
        must hedge, not fence. 0.0 off-plan."""
        if (self.engine_stall_ms <= 0.0
                or int(engine) != self.engine_stall_engine):
            return 0.0
        if self.engine_stall_at and int(step) not in self.engine_stall_at:
            return 0.0
        return self.engine_stall_ms / 1e3

    def should_skip_router_snapshot(self, index: int) -> bool:
        """True when the fleet router's recovery number ``index``
        (0-based, per router) must behave as if NO drain snapshot were
        usable — forcing the replay-from-prompt+generated path."""
        return int(index) in self.router_snapshot_missing

    # -- kv-handoff sites --------------------------------------------------

    def kv_transfer_fault(self) -> Optional[str]:
        """Fault planned for THIS KV handoff transfer attempt (each
        call advances the 0-based transfer-attempt index): one of
        ``"corrupt"`` (flip one received byte — verify must refuse),
        ``"timeout"`` (raise before any bytes move), ``"partial"``
        (zero the received tail block — verify must refuse), or None
        off-plan. Retries advance the counter too, so a single planned
        index is absorbed by one idempotent re-send."""
        with self._lock:
            idx = self._counts.get("kv_transfer", 0)
            self._counts["kv_transfer"] = idx + 1
        if idx in self.kv_transfer_corrupt:
            return "corrupt"
        if idx in self.kv_transfer_timeout:
            return "timeout"
        if idx in self.kv_transfer_partial:
            return "partial"
        return None

    def should_orphan_handoff(self) -> bool:
        """True when THIS handoff (each call advances the 0-based
        handoff index) must be abandoned after export — as if the
        decode target died holding the payload. The router must free
        and scrub the exported source blocks under the dirty-block
        rule and re-prefill the request on a survivor."""
        with self._lock:
            idx = self._counts.get("handoff_orphan", 0)
            self._counts["handoff_orphan"] = idx + 1
        return idx in self.handoff_orphan

    # -- MoE workload-plane sites ------------------------------------------

    def should_collapse_router(self, step: int) -> bool:
        """True when the MoE train step at ``step`` must zero every
        gate kernel before dispatch — the deterministic router-collapse
        drill behind the ``moe_imbalance`` latch."""
        return int(step) in self.moe_router_collapse_steps

    # -- the input pipeline's stall site -----------------------------------

    def data_stall_s(self) -> float:
        """Seconds the ``PrefetchLoader`` worker sleeps a transfer: a
        stalled input pipeline, which the consumer sees as its
        ``data_wait`` span. 0.0 off-plan."""
        return max(0.0, self.data_stall_ms) / 1e3

    # -- the preemption drill ---------------------------------------------

    def maybe_sigterm(self, step: int) -> None:
        """Deliver a REAL SIGTERM to this process at planned steps —
        the deterministic stand-in for the scheduler's preemption
        notice, exercising the actual async-signal path
        (resilience/guard.py PreemptionHandler)."""
        if int(step) in self.sigterm_steps:
            import os as _os
            import signal as _signal

            _os.kill(_os.getpid(), _signal.SIGTERM)

    # -- env knob ----------------------------------------------------------

    @classmethod
    def from_env(cls, spec: str) -> "FaultInjector":
        """Parse the ``APEX_TPU_FAULTS`` grammar (module docstring)."""
        kw: Dict[str, Any] = {"io_errors": {}, "io_permanent_from": {}}
        for clause in spec.split(";"):
            clause = clause.strip()
            if not clause:
                continue
            key, _, val = clause.partition("=")
            key = key.strip()
            if key == "nan_grads":
                kw["nan_grad_steps"] = _int_set(val)
            elif key == "nan_leaf":
                kw["nan_leaf"] = int(val)
            elif key == "truncate":
                kw["truncate_steps"] = _int_set(val)
            elif key == "crash":
                kw["crash_steps"] = _int_set(val)
            elif key == "bit_flip":
                kw["bit_flip_steps"] = _int_set(val)
            elif key == "bit_flip_replica":
                kw["bit_flip_replica"] = int(val)
            elif key == "bit_flip_leaf":
                kw["bit_flip_leaf"] = int(val)
            elif key == "crash_before_commit":
                kw["crash_before_commit_steps"] = _int_set(val)
            elif key == "sigterm":
                kw["sigterm_steps"] = _int_set(val)
            elif key == "shard_truncate":
                kw["shard_truncate_steps"] = _int_set(val)
            elif key == "shard_truncate_host":
                kw["shard_truncate_host"] = int(val)
            elif key == "world_mismatch":
                kw["world_mismatch_steps"] = _int_set(val)
            elif key == "range_fetch_timeout":
                kw["range_fetch_timeout"] = _int_set(val)
            elif key == "collective_slow":
                kw["collective_slow_ms"] = float(val)
            elif key == "collective_slow_at":
                kw["collective_slow_at"] = _int_set(val)
            elif key == "collective_payload_corrupt":
                kw["collective_corrupt_indices"] = _int_set(val)
            elif key == "serving_pool_exhausted":
                kw["pool_exhausted_steps"] = _int_set(val)
            elif key == "decode_step_exception":
                kw["decode_exception_steps"] = _int_set(val)
            elif key == "prefill_chunk_exception":
                kw["prefill_chunk_exception_indices"] = _int_set(val)
            elif key == "decode_nonfinite":
                kw["decode_nonfinite_steps"] = _int_set(val)
            elif key == "decode_nonfinite_lane":
                kw["decode_nonfinite_lane"] = int(val)
            elif key == "serving_snapshot_corrupt":
                kw["snapshot_corrupt_indices"] = _int_set(val)
            elif key == "weight_swap_mismatch":
                kw["weight_swap_mismatch_indices"] = _int_set(val)
            elif key == "engine_crash":
                kw["engine_crash_steps"] = _int_set(val)
            elif key == "engine_crash_engine":
                kw["engine_crash_engine"] = int(val)
            elif key == "engine_stall_ms":
                kw["engine_stall_ms"] = float(val)
            elif key == "engine_stall_engine":
                kw["engine_stall_engine"] = int(val)
            elif key == "engine_stall_at":
                kw["engine_stall_at"] = _int_set(val)
            elif key == "router_snapshot_missing":
                kw["router_snapshot_missing"] = _int_set(val)
            elif key == "kv_transfer_corrupt":
                kw["kv_transfer_corrupt"] = _int_set(val)
            elif key == "kv_transfer_timeout":
                kw["kv_transfer_timeout"] = _int_set(val)
            elif key == "kv_transfer_partial":
                kw["kv_transfer_partial"] = _int_set(val)
            elif key == "handoff_orphan":
                kw["handoff_orphan"] = _int_set(val)
            elif key == "moe_router_collapse":
                kw["moe_router_collapse_steps"] = _int_set(val)
            elif key == "moe_expert_dead":
                kw["moe_expert_dead"] = int(val)
            elif key == "data_stall_ms":
                kw["data_stall_ms"] = float(val)
            elif key == "ckpt_stall_ms":
                kw["ckpt_stall_ms"] = float(val)
            elif key.startswith("io:"):
                kw["io_errors"][key[len("io:"):]] = _int_set(val)
            elif key.startswith("io_permanent:"):
                kw["io_permanent_from"][key[len("io_permanent:"):]] = int(val)
            else:
                raise ValueError(
                    f"unknown {ENV_KNOB} clause {clause!r} (see "
                    "apex_tpu_torch/resilience/faults.py for the grammar)")
        return cls(**kw)


# -- module-level active plan ----------------------------------------------

_ACTIVE: Optional[FaultInjector] = None
_ENV_CACHE: tuple = (None, None)          # (spec string, parsed injector)


def install(injector: Optional[FaultInjector]) -> None:
    """Install (or clear, with None) the process-wide fault plan."""
    global _ACTIVE
    _ACTIVE = injector


def active() -> Optional[FaultInjector]:
    """The installed injector, else one parsed from ``APEX_TPU_FAULTS``
    (cached per spec string), else None — the no-faults fast path."""
    if _ACTIVE is not None:
        return _ACTIVE
    spec = os.environ.get(ENV_KNOB)
    if not spec:
        return None
    global _ENV_CACHE
    if _ENV_CACHE[0] != spec:
        _ENV_CACHE = (spec, FaultInjector.from_env(spec))
    return _ENV_CACHE[1]


@contextlib.contextmanager
def inject(**kwargs):
    """``with faults.inject(nan_grad_steps={3}, ...):`` — install a plan
    for the block, restoring whatever was active before."""
    prev = _ACTIVE
    install(FaultInjector(**kwargs))
    try:
        yield _ACTIVE
    finally:
        install(prev)


def check(site: str) -> None:
    inj = active()
    if inj is not None:
        inj.check(site)


def maybe_sigterm(step: int) -> None:
    inj = active()
    if inj is not None:
        inj.maybe_sigterm(step)


def should_pool_exhaust(step: int) -> bool:
    inj = active()
    return inj is not None and inj.should_pool_exhaust(step)


def maybe_decode_exception(step: int) -> None:
    inj = active()
    if inj is not None:
        inj.maybe_decode_exception(step)


def maybe_prefill_chunk_exception(index: int) -> None:
    inj = active()
    if inj is not None:
        inj.maybe_prefill_chunk_exception(index)


def nonfinite_lane_at(step: int) -> Optional[int]:
    inj = active()
    return None if inj is None else inj.nonfinite_lane_at(step)


def should_snapshot_corrupt(index: int) -> bool:
    inj = active()
    return inj is not None and inj.should_snapshot_corrupt(index)


def should_weight_swap_mismatch(index: int) -> bool:
    inj = active()
    return inj is not None and inj.should_weight_swap_mismatch(index)


def collective_delay_s() -> float:
    inj = active()
    return 0.0 if inj is None else inj.collective_delay_s()


def should_corrupt_collective() -> bool:
    inj = active()
    return inj is not None and inj.should_corrupt_collective()


def maybe_engine_crash(step: int, engine: int) -> None:
    inj = active()
    if inj is not None:
        inj.maybe_engine_crash(step, engine)


def engine_stall_s(step: int, engine: int) -> float:
    inj = active()
    return 0.0 if inj is None else inj.engine_stall_s(step, engine)


def should_skip_router_snapshot(index: int) -> bool:
    inj = active()
    return inj is not None and inj.should_skip_router_snapshot(index)


def kv_transfer_fault() -> Optional[str]:
    inj = active()
    return None if inj is None else inj.kv_transfer_fault()


def should_orphan_handoff() -> bool:
    inj = active()
    return inj is not None and inj.should_orphan_handoff()


def should_collapse_router(step: int) -> bool:
    inj = active()
    return inj is not None and inj.should_collapse_router(step)


def data_stall_s() -> float:
    inj = active()
    return 0.0 if inj is None else inj.data_stall_s()


__all__ = [
    "ENV_KNOB", "EngineCrash", "FaultError", "FaultInjector",
    "SimulatedCrash", "active", "check", "collective_delay_s",
    "data_stall_s", "engine_stall_s", "inject", "install",
    "kv_transfer_fault", "maybe_decode_exception", "maybe_engine_crash",
    "maybe_prefill_chunk_exception", "maybe_sigterm", "nonfinite_lane_at",
    "should_collapse_router", "should_corrupt_collective",
    "should_orphan_handoff", "should_pool_exhaust",
    "should_skip_router_snapshot", "should_snapshot_corrupt",
    "should_weight_swap_mismatch",
]
