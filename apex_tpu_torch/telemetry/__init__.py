"""Telemetry: the metrics registry, the step timeline, the SLO monitor
and the crash flight recorder (the host planes of ``apex_tpu/telemetry/``
that the serving scheduler reaches).

- :mod:`~apex_tpu_torch.telemetry.metrics` — the process-global
  registry (counters, gauges, histograms with labeled series,
  structured events, sinks);
- :mod:`~apex_tpu_torch.telemetry.timeline` — :class:`StepTimeline`
  spans and perfetto export;
- :mod:`~apex_tpu_torch.telemetry.slo` — windowed SLO targets with
  burn-rate alerting and the admission shed signal;
- :mod:`~apex_tpu_torch.telemetry.flight` — the flight recorder's
  postmortem bundles.

The reference's compile plane (its ``jax.monitoring`` bridge) has no
counterpart: eager PyTorch compiles nothing. Its cost model, device
memory ledger, sharding, comms, fleet, MoE and goodput planes are not
ported; :func:`snapshot_detail` carries each as a null with its reason.
"""

from __future__ import annotations

from typing import Any, Dict

from apex_tpu_torch.telemetry import flight, metrics, slo, timeline
from apex_tpu_torch.telemetry.flight import FlightRecorder
from apex_tpu_torch.telemetry.metrics import (
    Counter,
    Gauge,
    Histogram,
    InMemorySink,
    JsonlSink,
    MetricsRegistry,
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
    out["layout_plan"] = None
    out["layout_plan_reason"] = "the mesh planner is not ported"
    out["goodput"] = None
    out["goodput_reason"] = flight.GOODPUT_REASON
    return out


def reset() -> None:
    """Fresh registry, disabled global timeline, disarmed flight
    recorder (tests)."""
    flight.disable()
    metrics.reset()
    timeline.disable()


__all__ = [
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "InMemorySink",
    "JsonlSink",
    "MetricsRegistry",
    "SLOMonitor",
    "SLOTarget",
    "SlidingWindowQuantile",
    "Span",
    "StdoutSink",
    "StepTimeline",
    "TOKEN_COUNT_BUCKETS",
    "disable",
    "enable",
    "flight",
    "get_timeline",
    "metrics",
    "registry",
    "reset",
    "slo",
    "snapshot",
    "snapshot_detail",
    "timeline",
]
