"""Crash flight recorder: a bounded black box dumped on failure.

Counterpart of ``apex_tpu/telemetry/flight.py``. The recorder keeps the
cheap tail of a run — the recent structured telemetry events (it is a
sink of the metrics registry) and the timeline ring the process already
holds — and on a trigger dumps one
self-contained ``flightrec_*.json`` bundle through
``records.write_record`` (O_EXCL claim, fsync, directory fsync), then
prunes the kind to the newest ``keep``.

The triggers the port fires (all host-local, ``fleet=False``):
``serving_pool_exhausted``, ``serving_request_error``,
``serving_quarantine``, ``serving_drain``, ``serving_weight_swap`` (a
rejected swap), ``slo_violation`` (``telemetry/slo.py``; the bundle
embeds the offending requests' traces and ``introspect()``), and the
fleet router's (``serving/fleet.py``): ``fleet_engine_lost`` (a fenced
engine; ``extra`` embeds the victim's last ``introspect()`` and the
recovery plan: snapshot or replay, the snapshot path, each recovered
request's target engine) and ``kv_handoff_failed`` (a KV handoff whose
wire retries ran out or whose install was refused; ``extra`` carries
the sha256 manifest's root and per-block hashes and the last attempt's
per-block verify log).

Each bundle carries the registry snapshot, the timeline slice, the
device memory from ``torch.cuda.memory_stats()`` (nulls with
``devmem_reason`` where there is no CUDA device) and the comms plane
(``telemetry.comms.section()``). A fleet-safe trigger (``fleet=True``)
over an attached or passed multi-replica collective gathers and merges
every replica's snapshot (``telemetry.fleet.FleetAggregator``) into
``fleet``; otherwise ``fleet`` is None and ``fleet_unavailable`` says
why, in the reference's words. The planes the port has not ported carry
the reference's disabled markers with a reason: ``compile_plane``
(eager PyTorch compiles nothing) and ``goodput``; with no consistency
guard and no checkpoint manager in the port, ``state_digests`` is empty
and ``last_checkpoint`` None. A failing dump never raises
(:func:`notify` swallows everything).
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, Optional

FLIGHT_KIND = "flightrec"

# the reasons the unported planes' sections carry
COMPILE_REASON = ("eager PyTorch compiles nothing: no compile tracker "
                  "in the port")
GOODPUT_REASON = "the goodput ledger is not ported (telemetry/goodput.py)"

# torch.cuda.memory_stats() keys behind the reference's devmem keys
_STATS_KEYS = (
    ("allocated_bytes.all.current", "bytes_in_use"),
    ("allocated_bytes.all.peak", "peak_bytes_in_use"),
    ("allocation.all.allocated", "num_allocs"),
)


def device_memory_stats(device=None) -> Dict[str, Any]:
    """The CUDA allocator's stats of ``device`` (default: the current
    CUDA device) under the reference's devmem keys. Always the full key
    set: values, or nulls with ``devmem_reason`` saying why."""
    out: Dict[str, Any] = {key: None for _, key in _STATS_KEYS}
    # the CUDA allocator reports no largest allocation
    out.update(bytes_limit=None, largest_alloc_bytes=None)
    out["device_kind"] = None
    out["devmem_reason"] = None
    import torch

    if not torch.cuda.is_available():
        out["devmem_reason"] = "no CUDA device in this process"
        return out
    dev = torch.device("cuda") if device is None else torch.device(device)
    out["device_kind"] = torch.cuda.get_device_name(dev)
    out["bytes_limit"] = int(torch.cuda.get_device_properties(dev)
                             .total_memory)
    stats = torch.cuda.memory_stats(dev)
    for src, key in _STATS_KEYS:
        v = stats.get(src)
        if v is not None:
            out[key] = int(v)
    if out["bytes_in_use"] is None:
        out["devmem_reason"] = ("torch.cuda.memory_stats() reports no "
                                "allocation on this device yet")
    return out


class FlightRecorder:
    """The black box: bounded rings + the atomic bundle dump.

    Attach it to the metrics registry as a SINK
    (``registry().add_sink(recorder)`` — :func:`enable` does this) and
    every structured event lands in the ``recent_events`` ring.

    - ``last_steps``: how many host-loop steps of timeline spans the
      bundle's perfetto slice covers.
    - ``timeline``: a :class:`~apex_tpu_torch.telemetry.StepTimeline`; None
      means the process-global timeline at dump time.
    - ``collective``: a replica-set collective (the fleet snapshot in
      the bundle, when the trigger is fleet-safe).
    - ``keep``: keep-last-k pruning of ``flightrec`` records.
    """

    def __init__(self, *, last_steps: int = 64, event_capacity: int = 256,
                 timeline=None, collective=None, keep: int = 5,
                 straggler_factor: float = 2.0):
        self.last_steps = int(last_steps)
        self.keep = int(keep)
        self.timeline = timeline
        self.collective = collective
        self._aggregator = None
        self._straggler_factor = float(straggler_factor)
        self.events: "deque[Dict[str, Any]]" = deque(
            maxlen=int(event_capacity))
        self.dumps = 0
        self.last_dump: Optional[str] = None
        self.last_trigger: Optional[str] = None
        self._lock = threading.Lock()

    # -- sink protocol (registry.add_sink) ---------------------------------

    def write_event(self, event: Dict[str, Any]) -> None:
        self.events.append(dict(event))

    def write_snapshot(self, snap: Dict[str, Any]) -> None:
        pass                                   # rings hold events only

    def close(self) -> None:
        pass

    # -- the dump -----------------------------------------------------------

    def _fleet_snapshot(self, collective):
        from apex_tpu_torch.telemetry.fleet import FleetAggregator

        if self._aggregator is None or \
                self._aggregator.collective is not collective:
            self._aggregator = FleetAggregator(
                collective, straggler_factor=self._straggler_factor)
        # publishes the fleet/straggler gauges BEFORE the local
        # snapshot below is taken, so the bundle's registry carries them
        return self._aggregator.aggregate()

    def _trace_slice(self, timeline):
        from apex_tpu_torch.telemetry import timeline as _timeline

        tl = timeline if timeline is not None else _timeline.get_timeline()
        if tl is None or not tl.enabled:
            return None
        return tl.export_trace(last_steps=self.last_steps)

    def _devmem(self):
        # one direct poll, so every bundle carries the memory plane —
        # values, or nulls with devmem_reason
        try:
            return {"polls": 0, "watermark_bytes": None,
                    "last": device_memory_stats()}
        except Exception as e:  # noqa: BLE001
            return {"error": f"{type(e).__name__}: {e}"}

    def _compile_plane(self):
        return {"recent_events": [], "tracker": None,
                "reason": COMPILE_REASON}

    def _comms(self):
        # the comms plane: per-op stats + bandwidth ledger + clock
        # offsets when the tracer is armed, else the explicit disabled
        # marker with its reason (comms.section's contract)
        from apex_tpu_torch.telemetry import comms as _comms

        try:
            return _comms.section()
        except Exception as e:  # noqa: BLE001
            return {"error": f"{type(e).__name__}: {e}"}

    def _goodput(self):
        return {"enabled": False, "goodput_reason": GOODPUT_REASON}

    def dump(self, trigger: str, *, error: Optional[BaseException] = None,
             fleet: bool = True, collective=None,
             extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Write one postmortem bundle; returns the record path (None
        when the disk write failed — ``write_record`` never raises).

        ``fleet=True`` gathers + merges the fleet snapshot over the
        attached (or passed) collective — only safe when every replica
        reaches this dump; host-local triggers pass ``fleet=False`` and
        the bundle records why the fleet view is absent.
        """
        from apex_tpu_torch import records, telemetry
        from apex_tpu_torch.resilience import faults

        with self._lock:
            col = collective if collective is not None else self.collective
            fleet_snap = None
            fleet_unavailable = None
            if not fleet:
                fleet_unavailable = ("host-local trigger: peers not at "
                                     "this dump point, no collective "
                                     "issued")
            elif col is None or col.n_replicas <= 1:
                fleet_unavailable = ("no multi-replica collective "
                                     "attached (single-host bundle)")
            else:
                try:
                    fleet_snap = self._fleet_snapshot(col)
                except Exception as e:  # noqa: BLE001
                    fleet_unavailable = f"{type(e).__name__}: {e}"
            bundle = {
                "trigger": str(trigger),
                "wall_time": time.time(),
                "pid": os.getpid(),
                "replica_id": getattr(col, "replica_id", 0),
                "n_replicas": getattr(col, "n_replicas", 1),
                "error": (f"{type(error).__name__}: {error}"
                          if error is not None else None),
                # AFTER the fleet aggregation so the straggler gauges
                # it published are in this registry snapshot
                "telemetry": telemetry.snapshot_detail(),
                "fleet": fleet_snap,
                **({"fleet_unavailable": fleet_unavailable}
                   if fleet_unavailable else {}),
                "trace": self._trace_slice(self.timeline),
                "devmem": self._devmem(),
                "compile_plane": self._compile_plane(),
                "comms": self._comms(),
                "goodput": self._goodput(),
                "recent_events": list(self.events),
                "state_digests": [],
                "last_checkpoint": None,
                "faults": os.environ.get(faults.ENV_KNOB) or None,
                "extra": extra,
            }
            path = records.write_record(FLIGHT_KIND, bundle)
            records.prune_records(FLIGHT_KIND, keep=self.keep)
            self.dumps += 1
            self.last_dump = path
            self.last_trigger = str(trigger)
        # after the bundle is durable: one event names it (lands in the
        # registry + sinks + this recorder's own ring for the NEXT dump)
        try:
            telemetry.registry().event("flight_dump", trigger=str(trigger),
                                       path=path)
        except Exception:  # noqa: BLE001
            pass
        return path


# ---------------------------------------------------------------------------
# The process-global recorder (what the runtime triggers notify)
# ---------------------------------------------------------------------------

_GLOBAL: Optional[FlightRecorder] = None


def enable(**kwargs) -> FlightRecorder:
    """Arm the process-global flight recorder (kwargs =
    :class:`FlightRecorder`); attaches it to the metrics registry as an
    event sink. Re-arming replaces the previous recorder."""
    global _GLOBAL
    from apex_tpu_torch.telemetry import metrics as _metrics

    disable()
    _GLOBAL = FlightRecorder(**kwargs)
    _metrics.registry().add_sink(_GLOBAL)
    return _GLOBAL


def disable() -> None:
    global _GLOBAL
    if _GLOBAL is not None:
        try:
            from apex_tpu_torch.telemetry import metrics as _metrics

            _metrics.registry().remove_sink(_GLOBAL)
        except Exception:  # noqa: BLE001
            pass
        _GLOBAL = None


def get_recorder() -> Optional[FlightRecorder]:
    return _GLOBAL


def notify(trigger: str, *, recorder: Optional[FlightRecorder] = None,
           error: Optional[BaseException] = None, fleet: bool = True,
           collective=None,
           extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
    """Dump a bundle on ``recorder`` (or the global one); a no-op
    returning None when nothing is armed, and NEVER raises — the
    trigger sites sit on failure paths that must stay on course."""
    rec = recorder if recorder is not None else _GLOBAL
    if rec is None:
        return None
    try:
        return rec.dump(trigger, error=error, fleet=fleet,
                        collective=collective, extra=extra)
    except Exception:  # noqa: BLE001 — the black box must not crash the run
        return None


__all__ = [
    "FLIGHT_KIND",
    "device_memory_stats",
    "FlightRecorder",
    "disable",
    "enable",
    "get_recorder",
    "notify",
]
