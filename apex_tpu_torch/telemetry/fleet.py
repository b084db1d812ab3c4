"""Fleet telemetry: cross-host snapshot aggregation + straggler
detection.

Counterpart of ``apex_tpu/telemetry/fleet.py``, host Python over a
:class:`~apex_tpu_torch.resilience.guard.Collective` (the card gives it
nothing to measure):

- :func:`gather_snapshots` collects every host's
  ``telemetry.snapshot_detail()`` in two fixed-shape gathers (lengths,
  then the right-padded utf-8 payloads). A snapshot past ``max_bytes``
  (default 4 MiB) gathers as a structured stub plus one
  ``fleet_snapshot_truncated`` event on its host.
- :func:`merge_snapshots` folds them into one fleet snapshot: counters
  summed, gauges per host with min/max/mean, histograms bucket-merged,
  step-phase summaries side by side. The goodput plane is not ported
  (the roadmap's A 10): a port host's snapshot carries none, and the
  merge drops it as the reference drops a host whose ledger is
  disarmed.
- :class:`FleetAggregator`: a per-host EWMA of each watched phase's
  mean (``step`` and ``data_wait``), the slowest/fastest spread, and a
  ``fleet_straggler`` event and gauges when a host's EWMA passes
  ``straggler_factor`` x the fleet median (with no goodput ledger to
  charge the spread to, as the reference does with one disarmed).
- :func:`estimate_clock_offsets` reads every host's clock at shared
  barrier releases, and :func:`export_fleet_trace` merges every host's
  ``export_trace()`` onto one perfetto timeline, one process track per
  host, shifted to the shared instant, with ``fleet_straggler`` /
  ``collective_slow`` / ``collective_payload_corrupt`` flight-ring events
  as instants.

Every collective here must be called by all replicas; a one-replica
collective (or None) short-circuits to the local snapshot.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

# phases watched for stragglers by default: the fused-step dispatch and
# the input-pipeline wait — the two that gate a lockstep fleet
DEFAULT_STRAGGLER_PHASES: Tuple[str, ...] = ("step", "data_wait")

# one host's snapshot payload past this rides as a stub + a
# fleet_snapshot_truncated event — every host allocates the padded
# gather buffer at the fleet MAX, so one fat registry taxes them all
DEFAULT_SNAPSHOT_CAP_BYTES = 4 << 20

# flight-ring events annotated as perfetto instants on merged traces
TRACE_INSTANT_EVENTS = ("fleet_straggler", "collective_slow",
                        "collective_payload_corrupt")


def local_snapshot() -> Dict[str, Any]:
    """This process's ``telemetry.snapshot_detail()`` (one JSON-able
    dict: registry + step-timeline summary + mfu-or-null)."""
    from apex_tpu_torch import telemetry

    return telemetry.snapshot_detail()


def _gather_blobs(collective, data: bytes) -> List[bytes]:
    """Every replica's variable-length payload, on every replica: two
    fixed-shape gathers (the Collective contract wants identical
    shapes everywhere), lengths first, then the payloads right-padded
    to the fleet max."""
    lens = collective.all_gather(np.asarray([len(data)], np.int64))
    max_len = max(int(lens.max()), 1)
    buf = np.zeros((max_len,), np.uint8)
    buf[: len(data)] = np.frombuffer(data, np.uint8)
    gathered = collective.all_gather(buf)
    out = []
    for r in range(collective.n_replicas):
        n = int(np.asarray(lens)[r, 0])
        out.append(bytes(bytearray(np.asarray(gathered)[r, :n])))
    return out


def _truncation_stub(n_bytes: int, max_bytes: int,
                     replica_id: int) -> Dict[str, Any]:
    """The structured stand-in an oversized snapshot gathers as: still
    a valid snapshot_detail shape (empty registry), explicitly marked
    so the merge and its consumers see the cap, not a quiet gap."""
    return {
        "truncated": True,
        "original_bytes": int(n_bytes),
        "max_bytes": int(max_bytes),
        "replica_id": int(replica_id),
        "registry": {"counters": {}, "gauges": {}, "histograms": {}},
        "step_timeline": None,
        "mfu": None,
    }


def gather_snapshots(collective,
                     snapshot: Optional[Dict[str, Any]] = None, *,
                     max_bytes: Optional[int] = DEFAULT_SNAPSHOT_CAP_BYTES,
                     registry=None) -> List[Dict[str, Any]]:
    """Every host's telemetry snapshot, by replica id, on EVERY host.

    ``snapshot`` overrides the local ``telemetry.snapshot_detail()``
    (the LocalCollective sim passes one per simulated host — the
    process-global registry can't be three hosts at once). A collective
    op: all replicas must call it; with no collective (or one replica)
    it degrades to ``[snapshot]`` with zero collectives issued.

    A snapshot past ``max_bytes`` (None disables the cap) is replaced
    by a structured stub and announced with ONE
    ``fleet_snapshot_truncated`` event + counter on the oversized host
    — the fleet still gathers (the other hosts' views are intact), and
    nothing is silently dropped.
    """
    if snapshot is None:
        snapshot = local_snapshot()
    if collective is None or collective.n_replicas <= 1:
        return [dict(snapshot)]
    data = json.dumps(snapshot, sort_keys=True).encode("utf-8")
    if max_bytes is not None and len(data) > max_bytes:
        from apex_tpu_torch.telemetry import metrics as _metrics

        reg = registry if registry is not None else _metrics.registry()
        rid = getattr(collective, "replica_id", 0)
        reg.counter("fleet_snapshot_truncated_total",
                    "snapshots replaced by a stub at the gather cap"
                    ).inc()
        reg.event("fleet_snapshot_truncated",
                  original_bytes=len(data), max_bytes=int(max_bytes),
                  replica=int(rid))
        data = json.dumps(
            _truncation_stub(len(data), max_bytes, rid),
            sort_keys=True).encode("utf-8")
    return [json.loads(b.decode("utf-8"))
            for b in _gather_blobs(collective, data)]


# ---------------------------------------------------------------------------
# Merge
# ---------------------------------------------------------------------------


def _merge_histograms(series: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Bucket-merge one histogram series across hosts. Buckets are the
    fixed ``le`` grids from metrics.Histogram — cumulative counts at
    the same upper bound simply add; a bound only some hosts carry
    (different bucket config) sums over the hosts that have it."""
    buckets: Dict[str, float] = {}
    total_sum = 0.0
    total_count = 0
    for s in series:
        for le, c in (s.get("buckets") or {}).items():
            buckets[le] = buckets.get(le, 0) + c
        total_sum += s.get("sum", 0.0)
        total_count += s.get("count", 0)

    def _le_key(le: str) -> float:
        return float("inf") if le == "+Inf" else float(le)

    return {"buckets": {le: buckets[le]
                        for le in sorted(buckets, key=_le_key)},
            "sum": total_sum, "count": total_count}


def merge_snapshots(per_host: Sequence[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold per-host ``snapshot_detail`` dicts into one fleet snapshot.

    Counters sum (a fleet-total event count is meaningful); gauges are
    last-write-wins per host so summing would lie — they stay per-host
    with min/max/mean derived; histograms bucket-merge; the step-phase
    summaries (and mfu) sit side by side keyed by replica id. Hosts
    whose timeline was disabled contribute ``None`` — the merge never
    demands telemetry a host didn't collect.
    """
    counters: Dict[str, float] = {}
    gauges: Dict[str, Dict[str, Any]] = {}
    hist_series: Dict[str, List[Dict[str, Any]]] = {}
    timelines: Dict[str, Any] = {}
    mfu: Dict[str, Any] = {}
    info: Dict[str, Any] = {}
    goodputs: Dict[str, Dict[str, Any]] = {}
    for r, snap in enumerate(per_host):
        reg = snap.get("registry") or {}
        for name, v in (reg.get("counters") or {}).items():
            counters[name] = counters.get(name, 0.0) + v
        for name, v in (reg.get("gauges") or {}).items():
            gauges.setdefault(name, {"per_host": {}})["per_host"][
                str(r)] = v
        for name, v in (reg.get("histograms") or {}).items():
            hist_series.setdefault(name, []).append(v)
        if reg.get("info"):
            info[str(r)] = reg["info"]
        timelines[str(r)] = snap.get("step_timeline")
        mfu[str(r)] = snap.get("mfu")
        gp = snap.get("goodput")
        if isinstance(gp, dict) and gp.get("enabled"):
            goodputs[str(r)] = gp
    for g in gauges.values():
        vals = list(g["per_host"].values())
        g["min"] = min(vals)
        g["max"] = max(vals)
        g["mean"] = sum(vals) / len(vals)
    return {
        "n_hosts": len(per_host),
        "counters": counters,
        "gauges": gauges,
        "histograms": {name: _merge_histograms(s)
                       for name, s in hist_series.items()},
        "step_timelines": timelines,
        "mfu": mfu,
        **({"info": info} if info else {}),
        **({"goodput": _merge_goodput(goodputs)} if goodputs else {}),
    }


def _merge_goodput(per_host: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """The fleet-merged run ledger: per-host goodput with min/max/mean
    fraction, cause-bucket seconds summed fleet-wide, and the
    straggler seconds each ledger attributed. Hosts whose ledger was
    disarmed simply drop out (the merge never demands telemetry a host
    didn't collect)."""
    fractions = [float(g.get("goodput_fraction") or 0.0)
                 for g in per_host.values()]
    seconds_total: Dict[str, float] = {}
    tokens = 0.0
    for g in per_host.values():
        tokens += float(g.get("tokens_trained_total") or 0.0)
        for c, v in (g.get("seconds") or {}).items():
            seconds_total[c] = round(
                seconds_total.get(c, 0.0) + float(v), 6)
    return {
        "n_hosts": len(per_host),
        "per_host": {
            r: {"goodput_fraction": g.get("goodput_fraction"),
                "wall_seconds": g.get("wall_seconds"),
                "straggler_wait_seconds":
                    (g.get("seconds") or {}).get("straggler_wait", 0.0),
                "restarts": g.get("restarts")}
            for r, g in per_host.items()},
        "fraction_min": min(fractions),
        "fraction_max": max(fractions),
        "fraction_mean": round(sum(fractions) / len(fractions), 6),
        "seconds_total": seconds_total,
        "straggler_wait_seconds_total": seconds_total.get(
            "straggler_wait", 0.0),
        "tokens_trained_total": tokens,
    }


# ---------------------------------------------------------------------------
# Straggler detection
# ---------------------------------------------------------------------------


def phase_means_by_host(per_host: Sequence[Dict[str, Any]],
                        phase: str) -> Dict[int, float]:
    """``{replica_id: mean_ms}`` of one timeline phase, over the hosts
    that actually timed it (disabled timelines drop out silently)."""
    out: Dict[int, float] = {}
    for r, snap in enumerate(per_host):
        tl = snap.get("step_timeline")
        if not tl:
            continue
        p = (tl.get("phases") or {}).get(phase)
        if p and p.get("count"):
            out[r] = float(p["mean_ms"])
    return out


class FleetAggregator:
    """Gather + merge + straggler detection, one call per aggregation
    boundary (``aggregate()``), over a guard-style collective.

    Per watched phase the aggregator keeps a per-host EWMA of the
    phase's windowed mean (``ewma_alpha`` — one noisy window doesn't
    flag a host; a persistently slow one converges fast). A host whose
    EWMA exceeds ``straggler_factor`` x the fleet MEDIAN EWMA is a
    straggler: reported in the returned fleet snapshot's
    ``straggler`` section, published as gauges
    (``fleet_phase_ms{phase=,host=}``, ``fleet_straggler_spread``
    slowest/fastest ratio, ``fleet_stragglers`` count) and as one
    ``fleet_straggler`` event per flagged (host, phase). The median —
    not the mean — anchors the test so one dying host cannot drag the
    reference toward itself.
    """

    def __init__(self, collective=None, *, straggler_factor: float = 2.0,
                 ewma_alpha: float = 0.25,
                 phases: Sequence[str] = DEFAULT_STRAGGLER_PHASES,
                 registry=None):
        if straggler_factor <= 1.0:
            raise ValueError(
                f"straggler_factor must be > 1, got {straggler_factor}")
        if not (0.0 < ewma_alpha <= 1.0):
            raise ValueError(
                f"ewma_alpha must be in (0, 1], got {ewma_alpha}")
        self.collective = collective
        self.straggler_factor = float(straggler_factor)
        self.ewma_alpha = float(ewma_alpha)
        self.phases = tuple(phases)
        self._registry = registry
        self._ewma: Dict[Tuple[str, int], float] = {}
        self.last_fleet: Optional[Dict[str, Any]] = None

    # -- ewma --------------------------------------------------------------

    def _ewma_update(self, phase: str, host: int, value: float) -> float:
        key = (phase, host)
        prev = self._ewma.get(key)
        cur = (value if prev is None
               else self.ewma_alpha * value
               + (1.0 - self.ewma_alpha) * prev)
        self._ewma[key] = cur
        return cur

    def straggler_report(self, per_host: Sequence[Dict[str, Any]]
                         ) -> Dict[str, Any]:
        """Pure derivation (plus EWMA state update): per-phase EWMAs,
        median, slowest/fastest spread, and the flagged hosts."""
        phases: Dict[str, Any] = {}
        n_stragglers = 0
        for phase in self.phases:
            means = phase_means_by_host(per_host, phase)
            ewmas = {h: self._ewma_update(phase, h, v)
                     for h, v in sorted(means.items())}
            entry: Dict[str, Any] = {
                "per_host_ewma_ms": {str(h): round(v, 4)
                                     for h, v in ewmas.items()},
            }
            if ewmas:
                vals = list(ewmas.values())
                median = float(np.median(vals))
                lo, hi = min(vals), max(vals)
                entry["median_ms"] = round(median, 4)
                entry["spread"] = round(hi / lo, 4) if lo > 0 else None
                flagged = []
                if median > 0 and len(ewmas) > 1:
                    for h, v in ewmas.items():
                        if v > self.straggler_factor * median:
                            flagged.append({"host": str(h),
                                            "ewma_ms": round(v, 4),
                                            "ratio_to_median":
                                                round(v / median, 4)})
                entry["stragglers"] = flagged
                n_stragglers += len(flagged)
            phases[phase] = entry
        return {"factor": self.straggler_factor,
                "ewma_alpha": self.ewma_alpha,
                "n_stragglers": n_stragglers,
                "phases": phases}

    # -- publish -----------------------------------------------------------

    def _publish(self, straggler: Dict[str, Any]) -> None:
        from apex_tpu_torch.telemetry import metrics as _metrics

        reg = (self._registry if self._registry is not None
               else _metrics.registry())
        phase_g = reg.gauge("fleet_phase_ms",
                            "per-host EWMA of a watched phase's mean "
                            "duration over the fleet")
        spread_g = reg.gauge("fleet_straggler_spread",
                             "slowest/fastest per-host EWMA ratio of a "
                             "watched phase")
        count_g = reg.gauge("fleet_stragglers",
                            "hosts currently past the straggler "
                            "threshold, all watched phases")
        for phase, entry in straggler["phases"].items():
            for h, v in entry.get("per_host_ewma_ms", {}).items():
                phase_g.set(v, phase=phase, host=h)
            spread_g.set(entry.get("spread") or 1.0, phase=phase)
            for s in entry.get("stragglers", ()):
                reg.event("fleet_straggler", phase=phase, host=s["host"],
                          ewma_ms=s["ewma_ms"],
                          ratio_to_median=s["ratio_to_median"],
                          factor=self.straggler_factor)
        count_g.set(straggler["n_stragglers"])

    # -- the boundary ------------------------------------------------------

    def aggregate(self, snapshot: Optional[Dict[str, Any]] = None, *,
                  publish: bool = True) -> Dict[str, Any]:
        """One aggregation boundary: gather every host's snapshot,
        merge, update straggler EWMAs, publish the fleet gauges/events
        into the LOCAL registry (every host derives the identical
        report from the identical gather, so any host can alert), and
        return the fleet snapshot. Collective: all replicas call it."""
        t0 = time.perf_counter()
        per_host = gather_snapshots(self.collective, snapshot)
        fleet = merge_snapshots(per_host)
        fleet["straggler"] = self.straggler_report(per_host)
        fleet["aggregation_ms"] = round(
            (time.perf_counter() - t0) * 1e3, 4)
        if publish:
            self._publish(fleet["straggler"])
        self.last_fleet = fleet
        return fleet


# ---------------------------------------------------------------------------
# Clock offsets + the fleet-merged trace
# ---------------------------------------------------------------------------


def estimate_clock_offsets(collective, *, rounds: int = 5,
                           clock=time.perf_counter,
                           registry=None) -> Dict[str, Any]:
    """Per-host clock offsets measured over the collective itself.

    Each round every host brackets one ``barrier()`` with its local
    clock and takes the midpoint: the barrier RELEASE is one shared
    fleet instant, so the midpoints are every host's clock read at
    (approximately) the same moment, and arrival skew cancels to first
    order. The per-round midpoints are gathered (one fixed-shape
    float64 collective) and host ``r``'s offset vs host 0 is the
    median over rounds of ``mid[r] - mid[0]`` — the median absorbs the
    occasional round where one host's barrier wake-up was late.

    Returns (and publishes as ``fleet_clock_offset_ms{host=}`` /
    ``fleet_clock_offset_spread_ms`` gauges, and deposits into the
    armed comms tracer)::

        {"n_hosts", "rounds", "anchor", "anchor_wall",
         "offsets_ms": {host: ms vs host 0}, "local_offset_ms",
         "spread_ms", "rtt_ms"}

    ``anchor`` is THIS host's local clock at the (median) shared
    instant — what :func:`export_fleet_trace` shifts this host's spans
    against; ``anchor_wall`` is the matching ``time.time()`` reading
    (dates the flight ring's wall-clock events onto the same axis).
    ``rtt_ms`` (the median barrier round-trip) bounds the estimate's
    uncertainty. A collective op: all replicas must call it; a single
    replica short-circuits with zero collectives issued.
    """
    n = getattr(collective, "n_replicas", 1) if collective else 1
    if collective is None or n <= 1:
        return {"n_hosts": 1, "rounds": 0, "anchor": clock(),
                "anchor_wall": time.time(), "offsets_ms": {"0": 0.0},
                "local_offset_ms": 0.0, "spread_ms": 0.0, "rtt_ms": 0.0}
    collective.barrier()          # align arrival before measuring
    mids, rtts = [], []
    for _ in range(int(rounds)):
        t0 = clock()
        collective.barrier()
        t1 = clock()
        mids.append((t0 + t1) / 2.0)
        rtts.append(t1 - t0)
    anchor_wall = time.time()
    gathered = np.asarray(collective.all_gather(
        np.asarray(mids, np.float64)))            # (n_hosts, rounds)
    deltas = gathered - gathered[0:1, :]          # vs host 0, per round
    med = np.median(deltas, axis=1)               # (n_hosts,)
    offsets_ms = {str(r): round(float(med[r]) * 1e3, 6)
                  for r in range(n)}
    rid = int(getattr(collective, "replica_id", 0))
    out = {
        "n_hosts": n,
        "rounds": int(rounds),
        "anchor": float(np.median(np.asarray(mids))),
        "anchor_wall": anchor_wall,
        "offsets_ms": offsets_ms,
        "local_offset_ms": offsets_ms[str(rid)],
        "spread_ms": round(float(med.max() - med.min()) * 1e3, 6),
        "rtt_ms": round(float(np.median(np.asarray(rtts))) * 1e3, 6),
    }
    from apex_tpu_torch.telemetry import comms as _comms
    from apex_tpu_torch.telemetry import metrics as _metrics

    reg = registry if registry is not None else _metrics.registry()
    g = reg.gauge("fleet_clock_offset_ms",
                  "per-host clock offset vs host 0 (barrier midpoint)")
    for h, v in offsets_ms.items():
        g.set(v, host=h)
    reg.gauge("fleet_clock_offset_spread_ms",
              "max-min per-host clock offset").set(out["spread_ms"])
    tracer = _comms.get_tracer()
    if tracer is not None:
        tracer.note_clock_offsets(out)
    return out


def export_fleet_trace(collective, path: Optional[str] = None, *,
                       timeline=None, offsets: Optional[Dict] = None,
                       rounds: int = 5, clock=time.perf_counter,
                       instant_events=None) -> Dict[str, Any]:
    """Every host's ``export_trace()`` merged onto ONE perfetto
    timeline, offset-corrected — the fleet's "where did the step go"
    view on a single time axis.

    Each host shifts its events so ``ts`` is relative to the shared
    barrier instant from :func:`estimate_clock_offsets` (pass a
    pre-computed ``offsets`` to reuse one estimation across exports —
    it must be THIS host's result, the anchor is host-local), the
    shifted traces ride the same two-fixed-shape-gather transport as
    snapshots, and the merge gives each host its own ``pid`` (replica
    id) with a ``process_name`` metadata track — so ui.perfetto.dev
    shows one process track per host, aligned. Flight-ring events in
    :data:`TRACE_INSTANT_EVENTS` (straggler flags, slow collectives)
    land as ``"ph": "i"`` instants on an ``events`` track, dated via
    the wall-clock anchor. All ``ts`` are normalized so the earliest
    event sits at 0 (``otherData.ts_shift_us`` records the shift).

    A collective op: all replicas must call it (every host gets the
    full merged dict back; ``path`` writes it tmp→rename — pass it on
    one host or give each host its own path). Hosts whose timeline is
    disabled contribute only their metadata track.
    """
    from apex_tpu_torch.telemetry import flight as _flight
    from apex_tpu_torch.telemetry import timeline as _timeline

    tl = timeline if timeline is not None else _timeline.get_timeline()
    if offsets is None:
        offsets = estimate_clock_offsets(collective, rounds=rounds,
                                         clock=clock)
    anchor, anchor_wall = offsets["anchor"], offsets["anchor_wall"]
    events: List[Dict[str, Any]] = []
    tids_used = 0
    if tl is not None and tl.enabled:
        local = tl.export_trace()
        shift_us = (tl.origin - anchor) * 1e6
        for e in local["traceEvents"]:
            e = dict(e)
            e.pop("pid", None)              # the merge owns pids
            if "ts" in e:
                e["ts"] = round(e["ts"] + shift_us, 3)
            events.append(e)
            tids_used = max(tids_used, int(e.get("tid", 0)) + 1)
    src = instant_events
    if src is None:
        rec = _flight.get_recorder()
        src = list(rec.events) if rec is not None else []
    instant_tid = None
    for ev in src:
        if ev.get("event") not in TRACE_INSTANT_EVENTS:
            continue
        wall = ev.get("wall_time")
        if wall is None:
            continue
        if instant_tid is None:
            instant_tid = tids_used
            events.append({"name": "thread_name", "ph": "M",
                           "tid": instant_tid,
                           "args": {"name": "events"}})
        args = {k: v for k, v in ev.items()
                if k not in ("event", "wall_time")
                and isinstance(v, (str, int, float, bool, type(None)))}
        events.append({
            "name": ev["event"], "cat": "events", "ph": "i", "s": "p",
            "ts": round((wall - anchor_wall) * 1e6, 3),
            "tid": instant_tid, "args": args,
        })
    rid = int(getattr(collective, "replica_id", 0)) if collective else 0
    payload = {"host": rid,
               "offset_ms": offsets["offsets_ms"].get(str(rid), 0.0),
               "events": events}
    data = json.dumps(payload, sort_keys=True).encode("utf-8")
    if collective is not None and \
            getattr(collective, "n_replicas", 1) > 1:
        per_host = [json.loads(b.decode("utf-8"))
                    for b in _gather_blobs(collective, data)]
    else:
        per_host = [payload]
    merged: List[Dict[str, Any]] = []
    for r, host in enumerate(per_host):
        for e in host["events"]:
            e = dict(e)
            e["pid"] = r
            merged.append(e)
        merged.append({"name": "process_name", "ph": "M", "pid": r,
                       "args": {"name": f"host {host.get('host', r)}"}})
        merged.append({"name": "process_sort_index", "ph": "M",
                       "pid": r, "args": {"sort_index": r}})
    # perfetto dislikes negative ts: slide everything so min ts == 0
    ts_values = [e["ts"] for e in merged if "ts" in e]
    ts_shift = -min(ts_values) if ts_values and min(ts_values) < 0 \
        else 0.0
    if ts_shift:
        for e in merged:
            if "ts" in e:
                e["ts"] = round(e["ts"] + ts_shift, 3)
    trace = {
        "traceEvents": merged,
        "displayTimeUnit": "ms",
        "otherData": {
            "n_hosts": len(per_host),
            "clock_offsets_ms": offsets["offsets_ms"],
            "clock_offset_spread_ms": offsets["spread_ms"],
            "clock_offset_rounds": offsets["rounds"],
            "ts_shift_us": round(ts_shift, 3),
        },
    }
    if path is not None:
        tmp = f"{path}.tmp-{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(trace, f)
        os.replace(tmp, path)
    return trace


__all__ = [
    "DEFAULT_SNAPSHOT_CAP_BYTES",
    "DEFAULT_STRAGGLER_PHASES",
    "FleetAggregator",
    "TRACE_INSTANT_EVENTS",
    "estimate_clock_offsets",
    "export_fleet_trace",
    "gather_snapshots",
    "local_snapshot",
    "merge_snapshots",
    "phase_means_by_host",
]
