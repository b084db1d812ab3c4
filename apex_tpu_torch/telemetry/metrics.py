"""Process-global metrics registry: counters, gauges, histograms.

Counterpart of ``apex_tpu/telemetry/metrics.py``, host Python copied
as is: :class:`Counter` (monotonic float), :class:`Gauge`
(last-write-wins float) and :class:`Histogram` (fixed-bucket cumulative
counts with sum and count), each with labeled series
(``counter.inc(action="rollback")`` bumps ``name{action="rollback"}``);
:meth:`MetricsRegistry.snapshot` as one JSON-able dict; structured
events counted under ``telemetry_events{event=...}`` and forwarded to
every sink; the three sinks (:class:`InMemorySink`, :class:`JsonlSink`
on the records writer's ``O_CREAT|O_EXCL`` + fsync protocol,
:class:`StdoutSink`); the count-scale :data:`TOKEN_COUNT_BUCKETS`; and
the refusal of a histogram re-registered with a conflicting bucket
grid; the collective-latency and payload-size grids
(:data:`LATENCY_MS_BUCKETS`, :data:`PAYLOAD_BYTES_BUCKETS`) the comms
plane observes into. The reference's Prometheus text exposition waits
for its users (the tools). Nothing here touches a tensor.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

# seconds-scale latencies from sub-ms host ops to multi-second
# checkpoint writes; the last bucket is +Inf implicitly
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

# count-scale quantities (tokens per chunk, queue depths, batch
# sizes). Observing a count into the seconds-scale grid above lands
# EVERYTHING in +Inf and the histogram reads as one useless spike —
# use this grid (or your own) for anything that isn't a duration;
# `MetricsRegistry.histogram` now refuses conflicting re-registration
# so the mismatch fails loudly instead of silently mis-bucketing.
TOKEN_COUNT_BUCKETS: Tuple[float, ...] = (
    1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192)

# millisecond-scale latencies (collective ops): values observed here are
# already in ms, unlike the seconds-scale default grid
LATENCY_MS_BUCKETS: Tuple[float, ...] = (
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0,
    50.0, 100.0, 250.0, 1000.0, 5000.0)

# payload sizes in bytes, 64 B to 256 MB — the grid
# ``collective_bytes{op=}`` rides
PAYLOAD_BYTES_BUCKETS: Tuple[float, ...] = (
    64, 256, 1024, 4096, 16384, 65536, 262144, 1048576, 4194304,
    16777216, 67108864, 268435456)


def _series_key(labels: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _series_name(name: str, key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return name
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return f"{name}{{{inner}}}"


class _Metric:
    """Shared labeled-series machinery; subclasses define the series
    payload and how an operation mutates it."""

    kind = "metric"

    def __init__(self, name: str, help: str, lock: threading.RLock):
        self.name = name
        self.help = help
        self._lock = lock
        self._series: Dict[Tuple[Tuple[str, str], ...], Any] = {}

    def _get(self, labels: Dict[str, Any]):
        key = _series_key(labels)
        s = self._series.get(key)
        if s is None:
            with self._lock:
                s = self._series.setdefault(key, self._new_series())
        return s

    def _new_series(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def series(self) -> Dict[str, Any]:
        """``{series_name: snapshot_value}`` for every labeled child."""
        with self._lock:
            return {_series_name(self.name, k): self._snap(v)
                    for k, v in self._series.items()}

    def _snap(self, s):
        return s


class Counter(_Metric):
    """Monotonically increasing float, optionally labeled."""

    kind = "counter"

    def _new_series(self):
        return [0.0]

    def inc(self, n: float = 1.0, **labels) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease (n={n})")
        s = self._get(labels)
        with self._lock:
            s[0] += n

    def value(self, **labels) -> float:
        return self._get(labels)[0]

    def _snap(self, s):
        return s[0]


class _BoundGauge:
    """One pre-resolved labeled gauge series: hot loops pay a list
    store per :meth:`set` instead of per-call label sorting + dict
    lookup (:meth:`Gauge.bind`)."""

    __slots__ = ("_s", "_lock")

    def __init__(self, s, lock):
        self._s = s
        self._lock = lock

    def set(self, v: float) -> None:
        with self._lock:
            self._s[0] = float(v)

    def value(self) -> float:
        return self._s[0]


class Gauge(_Metric):
    """Last-write-wins float, optionally labeled."""

    kind = "gauge"

    def _new_series(self):
        return [0.0]

    def set(self, v: float, **labels) -> None:
        s = self._get(labels)
        with self._lock:
            s[0] = float(v)

    def bind(self, **labels) -> _BoundGauge:
        """Resolve one labeled series once; the returned handle's
        ``set`` skips the label machinery (per-step publishers)."""
        return _BoundGauge(self._get(labels), self._lock)

    def inc(self, n: float = 1.0, **labels) -> None:
        s = self._get(labels)
        with self._lock:
            s[0] += n

    def dec(self, n: float = 1.0, **labels) -> None:
        self.inc(-n, **labels)

    def value(self, **labels) -> float:
        return self._get(labels)[0]

    def _snap(self, s):
        return s[0]


class Histogram(_Metric):
    """Fixed-bucket histogram (cumulative counts, prometheus-style
    ``le`` upper bounds plus implicit ``+Inf``), with sum and count."""

    kind = "histogram"

    def __init__(self, name: str, help: str, lock: threading.RLock,
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, lock)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError(f"histogram {name} needs at least one bucket")
        self.buckets = bs

    def _new_series(self):
        # [counts per bucket ..., +Inf count, sum, count]
        return [0] * (len(self.buckets) + 1) + [0.0, 0]

    def observe(self, v: float, **labels) -> None:
        v = float(v)
        s = self._get(labels)
        i = len(self.buckets)              # +Inf slot
        for j, b in enumerate(self.buckets):
            if v <= b:
                i = j
                break
        with self._lock:
            s[i] += 1
            s[-2] += v
            s[-1] += 1

    def _snap(self, s):
        buckets = {str(b): sum(s[: i + 1])
                   for i, b in enumerate(self.buckets)}
        buckets["+Inf"] = sum(s[: len(self.buckets) + 1])
        return {"buckets": buckets, "sum": s[-2], "count": s[-1]}


# ---------------------------------------------------------------------------
# Sinks
# ---------------------------------------------------------------------------


class InMemorySink:
    """Collects events and snapshots in lists — the test sink."""

    def __init__(self):
        self.events: List[Dict[str, Any]] = []
        self.snapshots: List[Dict[str, Any]] = []

    def write_event(self, event: Dict[str, Any]) -> None:
        self.events.append(event)

    def write_snapshot(self, snap: Dict[str, Any]) -> None:
        self.snapshots.append(snap)

    def close(self) -> None:
        pass


class StdoutSink:
    """One-line JSON protocol: ``telemetry {...}`` per event/snapshot,
    greppable out of any log stream."""

    def __init__(self, stream=None, prefix: str = "telemetry"):
        self._stream = stream
        self.prefix = prefix

    def _emit(self, obj: Dict[str, Any]) -> None:
        stream = self._stream if self._stream is not None else sys.stdout
        print(f"{self.prefix} {json.dumps(obj, sort_keys=True)}",
              file=stream, flush=True)

    def write_event(self, event: Dict[str, Any]) -> None:
        self._emit({"type": "event", **event})

    def write_snapshot(self, snap: Dict[str, Any]) -> None:
        self._emit({"type": "snapshot", "snapshot": snap})

    def close(self) -> None:
        pass


class JsonlSink:
    """Durable JSONL event/snapshot log riding the ``records.py``
    atomic-claim writer protocol:

    - the file name is **claimed** with ``O_CREAT|O_EXCL`` (an
      exists-then-open check is a TOCTOU race across processes);
      same-second collisions fall back to a strictly-increasing
      ``time.monotonic_ns()`` disambiguator;
    - after the claim the records DIRECTORY is fsync'd (fault site
      ``record_fsync``) — the claim is a directory entry, and a crash
      right after the first write could otherwise lose the whole file
      even though the data hit the platter;
    - every line is flushed and (with ``fsync=True``) fsync'd, so the
      telemetry trail survives exactly the preemption kills the
      resilience layer is built for.

    The default directory is ``records.RECORDS_DIR`` so telemetry logs
    land next to the bench records they explain.
    """

    def __init__(self, directory: Optional[str] = None,
                 name: str = "telemetry", fsync: bool = True):
        self._directory = directory
        self.name = str(name)
        self.fsync = bool(fsync)
        self.path: Optional[str] = None
        self._fd = None
        self._lock = threading.Lock()

    def _claim(self):
        from apex_tpu_torch.resilience import faults

        directory = self._directory
        if directory is None:
            from apex_tpu_torch import records

            directory = records.RECORDS_DIR
        faults.check("record_write")
        os.makedirs(directory, exist_ok=True)
        stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        base = f"{self.name}_{stamp}"
        path = os.path.join(directory, f"{base}.jsonl")
        while True:
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY,
                             0o644)
                break
            except FileExistsError:
                path = os.path.join(
                    directory, f"{base}.{time.monotonic_ns()}.jsonl")
        try:
            # the claim is a directory entry: fsync the directory too,
            # or a crash right after the first append can erase the
            # file the caller was told exists (same fault site as
            # records.write_record so one knob covers both writers)
            faults.check("record_fsync")
            dfd = os.open(directory, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except BaseException:
            os.close(fd)
            try:
                os.unlink(path)          # never leave an unfsynced claim
            except OSError:
                pass
            raise
        self._fd = os.fdopen(fd, "w")
        self.path = path

    def _write(self, obj: Dict[str, Any]) -> None:
        with self._lock:
            if self._fd is None:
                self._claim()
            self._fd.write(json.dumps(obj, sort_keys=True) + "\n")
            self._fd.flush()
            if self.fsync:
                os.fsync(self._fd.fileno())

    def write_event(self, event: Dict[str, Any]) -> None:
        self._write({"type": "event", **event})

    def write_snapshot(self, snap: Dict[str, Any]) -> None:
        self._write({"type": "snapshot", "snapshot": snap})

    def close(self) -> None:
        with self._lock:
            if self._fd is not None:
                self._fd.close()
                self._fd = None


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


class MetricsRegistry:
    """Name -> instrument map with get-or-create accessors, structured
    events, info blobs, and pluggable sinks. Thread-safe (one RLock
    shared with every instrument)."""

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, _Metric] = {}
        self._info: Dict[str, Any] = {}
        self._sinks: List[Any] = []

    # -- instruments -------------------------------------------------------

    def _instrument(self, cls, name, help, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, self._lock, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"not {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._instrument(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._instrument(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Optional[Sequence[float]] = None) -> Histogram:
        """Get-or-create. ``buckets=None`` means "no opinion": a new
        histogram gets :data:`DEFAULT_BUCKETS`, an existing one is
        returned as-is (readers never pin a grid). EXPLICIT buckets on
        an already-registered histogram must match its grid exactly —
        a silent mismatch would route observations into the wrong
        buckets (the classic failure: a token COUNT observed into the
        seconds-scale default grid lands every sample in +Inf), so it
        raises instead."""
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = Histogram(name, help, self._lock,
                              buckets=(buckets if buckets is not None
                                       else DEFAULT_BUCKETS))
                self._metrics[name] = m
            elif not isinstance(m, Histogram):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"not histogram")
            elif buckets is not None:
                want = tuple(sorted(float(b) for b in buckets))
                if want != m.buckets:
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"buckets {m.buckets}; conflicting grid {want} "
                        "would silently mis-bucket observations")
            return m

    # -- info blobs --------------------------------------------------------

    def set_info(self, name: str, value: Any) -> None:
        """Attach a JSON-able structured value (e.g. the backend-probe
        verdict) that rides every snapshot under ``info``."""
        json.dumps(value)                # fail fast on non-JSON-able
        with self._lock:
            self._info[str(name)] = value

    def get_info(self, name: str, default: Any = None) -> Any:
        with self._lock:
            return self._info.get(str(name), default)

    # -- events ------------------------------------------------------------

    def event(self, name: str, **fields) -> Dict[str, Any]:
        """Record a discrete structured occurrence: counts it under
        ``telemetry_events{event=name}`` and forwards it to every sink.
        Sinks must never take the publisher down — a dead disk under a
        JsonlSink degrades to the counter, not to an exception."""
        ev = {"event": str(name), "wall_time": time.time(), **fields}
        self.counter("telemetry_events",
                     "structured events by name").inc(event=name)
        for sink in list(self._sinks):
            try:
                sink.write_event(ev)
            except Exception:  # noqa: BLE001 — sinks are best-effort
                pass
        return ev

    # -- sinks -------------------------------------------------------------

    def add_sink(self, sink) -> None:
        with self._lock:
            if sink not in self._sinks:
                self._sinks.append(sink)

    def remove_sink(self, sink) -> None:
        with self._lock:
            if sink in self._sinks:
                self._sinks.remove(sink)

    @property
    def sinks(self) -> List[Any]:
        return list(self._sinks)

    # -- snapshot ----------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """Everything, one JSON-able dict: per-kind series maps plus
        the info blobs."""
        out: Dict[str, Any] = {"counters": {}, "gauges": {},
                               "histograms": {}}
        with self._lock:
            for m in self._metrics.values():
                out[m.kind + "s"].update(m.series())
            if self._info:
                out["info"] = dict(self._info)
        return out

    def flush(self) -> Dict[str, Any]:
        """Push one snapshot through every sink; returns the snapshot."""
        snap = self.snapshot()
        for sink in list(self._sinks):
            try:
                sink.write_snapshot(snap)
            except Exception:  # noqa: BLE001
                pass
        return snap

    def reset(self) -> None:
        """Drop every metric, info blob, and sink (tests)."""
        with self._lock:
            for sink in self._sinks:
                try:
                    sink.close()
                except Exception:  # noqa: BLE001
                    pass
            self._metrics.clear()
            self._info.clear()
            self._sinks.clear()


_REGISTRY = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-global registry every subsystem publishes to."""
    return _REGISTRY


def snapshot() -> Dict[str, Any]:
    return _REGISTRY.snapshot()


def reset() -> None:
    _REGISTRY.reset()


__all__ = [
    "Counter",
    "DEFAULT_BUCKETS",
    "LATENCY_MS_BUCKETS",
    "PAYLOAD_BYTES_BUCKETS",
    "TOKEN_COUNT_BUCKETS",
    "Gauge",
    "Histogram",
    "InMemorySink",
    "JsonlSink",
    "MetricsRegistry",
    "StdoutSink",
    "registry",
    "reset",
    "snapshot",
]
