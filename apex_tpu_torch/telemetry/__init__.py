"""Telemetry: the metrics registry, the step timeline, the SLO monitor,
the crash flight recorder, the comms plane and the fleet view (the host
planes of ``apex_tpu/telemetry/`` that the serving scheduler and the
fleet router reach).

- :mod:`~apex_tpu_torch.telemetry.metrics` — the process-global
  registry (counters, gauges, histograms with labeled series,
  structured events, sinks);
- :mod:`~apex_tpu_torch.telemetry.timeline` — :class:`StepTimeline`
  spans and perfetto export;
- :mod:`~apex_tpu_torch.telemetry.slo` — windowed SLO targets with
  burn-rate alerting and the admission shed signal;
- :mod:`~apex_tpu_torch.telemetry.flight` — the flight recorder's
  postmortem bundles;
- :mod:`~apex_tpu_torch.telemetry.comms` — collective tracing and the
  wire bandwidth ledger;
- :mod:`~apex_tpu_torch.telemetry.fleet` — cross-host snapshot gathers,
  merges, straggler detection, clock offsets and the merged trace.

The reference's compile plane (its ``jax.monitoring`` bridge) has no
counterpart: eager PyTorch compiles nothing. Its cost model, device
memory ledger, sharding, MoE and goodput planes are not ported;
:func:`snapshot_detail` carries each as a null with its reason, and the
mesh planner's published layout (``mesh.planner.publish_plan``) where
there is one.
"""

from __future__ import annotations

from typing import Any, Dict

from apex_tpu_torch.telemetry import comms, fleet, flight, metrics, slo, timeline
from apex_tpu_torch.telemetry.comms import CommsTracer, InstrumentedCollective
from apex_tpu_torch.telemetry.fleet import (
    FleetAggregator,
    gather_snapshots,
    merge_snapshots,
)
from apex_tpu_torch.telemetry.flight import FlightRecorder
from apex_tpu_torch.telemetry.metrics import (
    Counter,
    Gauge,
    Histogram,
    InMemorySink,
    JsonlSink,
    LATENCY_MS_BUCKETS,
    MetricsRegistry,
    PAYLOAD_BYTES_BUCKETS,
    StdoutSink,
    TOKEN_COUNT_BUCKETS,
    registry,
)
from apex_tpu_torch.telemetry.slo import (
    SLOMonitor,
    SLOTarget,
    SlidingWindowQuantile,
)
from apex_tpu_torch.telemetry.timeline import (
    Span,
    StepTimeline,
    disable,
    enable,
    get_timeline,
)


def snapshot() -> Dict[str, Any]:
    """The process-global registry's snapshot (one JSON-able dict)."""
    return metrics.registry().snapshot()


def snapshot_detail() -> Dict[str, Any]:
    """The ``telemetry`` block a flight bundle carries, in the
    reference's keys: the registry snapshot, the global timeline's
    per-phase breakdown, and each plane the port lacks as a null with
    its reason."""
    reg = metrics.registry()
    snap = reg.snapshot()
    tl = timeline.get_timeline()
    mfu = snap.get("gauges", {}).get("mfu")
    out: Dict[str, Any] = {
        "registry": snap,
        "step_timeline": tl.summary() if tl.enabled else None,
        "mfu": mfu,
    }
    if mfu is None:
        out["mfu_reason"] = (reg.get_info("mfu_reason")
                             or "no step cost published in this process")
    out["devmem"] = None
    out["devmem_reason"] = (
        "no device-memory ledger in the port (the flight bundle's "
        "devmem section polls torch.cuda.memory_stats)")
    out["sharding"] = None
    out["sharding_reason"] = "sharding introspection is not ported"
    plan = reg.get_info("layout_plan")
    if plan:
        out["layout_plan"] = plan
    else:
        out["layout_plan"] = None
        out["layout_plan_reason"] = (
            "no layout plan published in this process "
            "(mesh.planner.publish_plan)")
    out["goodput"] = None
    out["goodput_reason"] = flight.GOODPUT_REASON
    return out


def reset() -> None:
    """Fresh registry, disabled global timeline, disarmed flight
    recorder and comms tracer (tests)."""
    flight.disable()
    comms.disable()
    metrics.reset()
    timeline.disable()


__all__ = [
    "CommsTracer",
    "Counter",
    "FleetAggregator",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "InMemorySink",
    "InstrumentedCollective",
    "JsonlSink",
    "LATENCY_MS_BUCKETS",
    "MetricsRegistry",
    "PAYLOAD_BYTES_BUCKETS",
    "SLOMonitor",
    "SLOTarget",
    "SlidingWindowQuantile",
    "Span",
    "StdoutSink",
    "StepTimeline",
    "TOKEN_COUNT_BUCKETS",
    "comms",
    "disable",
    "enable",
    "fleet",
    "flight",
    "gather_snapshots",
    "get_timeline",
    "merge_snapshots",
    "metrics",
    "registry",
    "reset",
    "slo",
    "snapshot",
    "snapshot_detail",
    "timeline",
]
