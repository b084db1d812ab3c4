"""SLO plane: sliding-window percentiles and multi-window burn-rate
alerting for the serving tier.

Counterpart of ``apex_tpu/telemetry/slo.py``, host Python copied as is:
:class:`SlidingWindowQuantile` (exact quantiles over a trailing time
window), :class:`SLOTarget` objectives and :class:`SLOMonitor`, which
publishes ``slo_burn_rate{slo=,window=}``, ``slo_window_value{slo=}``
and ``slo_alert_active{slo=}`` at every check, fires one ``slo_alert``
event and ``slo_violation`` flight bundle per violation episode (the
bundle embeds the offending requests' traces and the engine's
``introspect()``, wired by :meth:`SLOMonitor.attach`), one
``slo_recovered`` event when the short window recovers, and answers
:meth:`SLOMonitor.should_shed`, the admission hook the scheduler
consults.
"""

from __future__ import annotations

import bisect
import dataclasses
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# (long_s, short_s, burn_threshold) pairs — the SRE-workbook fast/slow
# pages scaled to serving-loop timescales; tests and smokes pass their
# own (seconds-scale) windows
DEFAULT_WINDOWS: Tuple[Tuple[float, float, float], ...] = (
    (60.0, 5.0, 14.4), (300.0, 30.0, 6.0))


@dataclasses.dataclass(frozen=True)
class SLOTarget:
    """One objective: samples observed under ``name`` are GOOD when
    they sit on the right side of ``objective`` (``kind="le"``: at or
    below — latencies, queue depths; ``kind="ge"``: at or above —
    goodput/success indicators). ``budget`` is the allowed bad
    fraction (burn rate 1.0 = consuming exactly the budget);
    ``percentile`` is what :meth:`SLOMonitor.summary` reports for
    latency-style targets."""

    name: str
    objective: float
    budget: float = 0.01
    kind: str = "le"
    percentile: float = 0.99

    def __post_init__(self):
        if self.kind not in ("le", "ge"):
            raise ValueError(f"slo {self.name!r}: kind must be 'le' or "
                             f"'ge', got {self.kind!r}")
        if not 0.0 < self.budget <= 1.0:
            raise ValueError(f"slo {self.name!r}: budget must be in "
                             f"(0, 1], got {self.budget}")

    def ok(self, value: float) -> bool:
        return (value <= self.objective if self.kind == "le"
                else value >= self.objective)


class SlidingWindowQuantile:
    """Exact quantiles over a trailing time window.

    A deque of ``(t, value)`` pruned on both observe and read;
    ``capacity`` bounds memory under sample floods (oldest drop first
    — the window is then effectively shorter, reported via
    :meth:`count` vs what the caller expected). Quantile reads sort a
    snapshot of the window — O(n log n) per read, and reads happen per
    monitor ``check()``, not per observation."""

    def __init__(self, window_s: float, *, capacity: int = 8192):
        if window_s <= 0:
            raise ValueError(f"window_s must be > 0, got {window_s}")
        self.window_s = float(window_s)
        self._samples: "deque[Tuple[float, float]]" = deque(
            maxlen=int(capacity))
        self._lock = threading.Lock()

    def _prune(self, now: float) -> None:
        cutoff = now - self.window_s
        s = self._samples
        while s and s[0][0] < cutoff:
            s.popleft()

    def observe(self, value: float, t: float) -> None:
        with self._lock:
            self._samples.append((float(t), float(value)))
            self._prune(t)

    def count(self, now: float) -> int:
        with self._lock:
            self._prune(now)
            return len(self._samples)

    def quantile(self, q: float, now: float) -> Optional[float]:
        """The ``q``-quantile (0..1) of the window at ``now``; None on
        an empty window. Linear interpolation between order
        statistics (numpy's default), so small windows don't step."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"q must be in [0, 1], got {q}")
        with self._lock:
            self._prune(now)
            vals = sorted(v for _, v in self._samples)
        if not vals:
            return None
        if len(vals) == 1:
            return vals[0]
        pos = q * (len(vals) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(vals) - 1)
        frac = pos - lo
        return vals[lo] * (1.0 - frac) + vals[hi] * frac


class _TargetState:
    """Per-target sample ring + alert latch (monitor-internal)."""

    __slots__ = ("target", "samples", "est", "violators", "alerting",
                 "alerts")

    def __init__(self, target: SLOTarget, window_s: float,
                 capacity: int):
        self.target = target
        # (t, value, ok) — one ring serves every window (pruned to the
        # longest; shorter windows bisect into it)
        self.samples: "deque[Tuple[float, float, bool]]" = deque(
            maxlen=capacity)
        self.est = SlidingWindowQuantile(window_s, capacity=capacity)
        # newest offending request ids (what the violation bundle
        # names and embeds traces for)
        self.violators: "deque[Tuple[str, float]]" = deque(maxlen=16)
        self.alerting = False
        self.alerts = 0


class SLOMonitor:
    """Windowed SLO targets with burn-rate alerting (module
    docstring).

    - ``targets``: :class:`SLOTarget` list; observations under
      unconfigured names are dropped (publishers need no knowledge of
      which objectives are armed).
    - ``windows``: ``(long_s, short_s, burn_threshold)`` pairs; an
      alert needs BOTH windows of one pair past the threshold.
    - ``min_samples``: the short window must hold at least this many
      samples before it can alert (one unlucky request is not an SLO
      violation).
    - ``clock``: share the engine's clock (tests drive fake time).
    - ``registry``: where gauges/events publish (default: the
      process-global registry).
    """

    def __init__(self, targets: Sequence[SLOTarget], *,
                 windows: Sequence[Tuple[float, float, float]] =
                 DEFAULT_WINDOWS,
                 registry=None, min_samples: int = 5,
                 capacity: int = 8192, check_every: int = 4,
                 info_every: int = 16, shed: bool = True,
                 clock: Callable[[], float] = time.perf_counter):
        from apex_tpu_torch.telemetry import metrics as _metrics

        if not targets:
            raise ValueError("SLOMonitor needs at least one target")
        self.windows = tuple((float(lo), float(sh), float(th))
                             for lo, sh, th in windows)
        if not self.windows:
            raise ValueError("SLOMonitor needs at least one window")
        for lo, sh, th in self.windows:
            if not 0 < sh <= lo:
                raise ValueError(
                    f"window pair must satisfy 0 < short <= long, got "
                    f"({lo}, {sh})")
        self.min_samples = int(min_samples)
        self.check_every = max(int(check_every), 1)
        self.info_every = max(int(info_every), 1)
        # shed=False: observe-only — alerts/bundles still fire but
        # should_shed() stays False. Shedding on a LATENCY objective
        # makes queued requests' latency worse (positive feedback:
        # shed -> age -> violate -> shed), so admission-side shedding
        # belongs to targets a router can actually relieve (queue
        # depth, goodput) or to a front door that reroutes the load.
        self.shed = bool(shed)
        self.clock = clock
        self._registry = (registry if registry is not None
                          else _metrics.registry())
        horizon = max(lo for lo, _, _ in self.windows)
        self._state: Dict[str, _TargetState] = {}
        for t in targets:
            if t.name in self._state:
                raise ValueError(f"duplicate SLO target {t.name!r}")
            self._state[t.name] = _TargetState(t, horizon,
                                               int(capacity))
        self._horizon = horizon
        self._lock = threading.Lock()
        self._ticks = 0
        self._checks = 0
        self._alerts_total = 0
        self._last_check: Optional[Dict[str, Any]] = None
        # pre-resolved gauge cells (Gauge.bind) keyed (metric, target,
        # window) — per-check publishing is a list store, not a label
        # sort (the <2% engine-step overhead budget)
        self._cells: Dict[Tuple[str, ...], Any] = {}
        # wired by the engine (scheduler.attach): callables producing
        # the offending requests' trace dicts and a live introspection
        # snapshot for the violation bundle
        self._trace_provider: Optional[Callable] = None
        self._introspect_provider: Optional[Callable] = None

    @classmethod
    def serving_default(cls, *, ttft_p99_s: float = 0.5,
                        tpot_p99_s: float = 0.1,
                        queue_depth: int = 64, **kw) -> "SLOMonitor":
        """The serving tier's canonical four targets: TTFT p99, TPOT
        p99, per-request goodput (1.0 = finished ok, 0.0 = error /
        deadline), queue depth."""
        return cls([
            SLOTarget("ttft_p99", ttft_p99_s),
            SLOTarget("tpot_p99", tpot_p99_s),
            SLOTarget("goodput", 1.0, kind="ge", budget=0.02,
                      percentile=0.5),
            SLOTarget("queue_depth", float(queue_depth), budget=0.05),
        ], **kw)

    def attach(self, *, trace_provider: Optional[Callable] = None,
               introspect_provider: Optional[Callable] = None) -> None:
        """Wire the violation bundle's evidence sources: a
        ``trace_provider(request_ids) -> [trace dicts]`` (the
        scheduler's RequestTracer) and an ``introspect_provider() ->
        dict`` (the scheduler's ``introspect``)."""
        if trace_provider is not None:
            self._trace_provider = trace_provider
        if introspect_provider is not None:
            self._introspect_provider = introspect_provider

    # -- observation -------------------------------------------------------

    def observe(self, name: str, value: float, *,
                request_id: Any = None,
                t: Optional[float] = None) -> None:
        """Record one sample for target ``name`` (no-op when the name
        is not configured — publishers stay decoupled from which
        objectives are armed)."""
        st = self._state.get(name)
        if st is None:
            return
        now = t if t is not None else self.clock()
        v = float(value)
        ok = st.target.ok(v)
        with self._lock:
            st.samples.append((now, v, ok))
        st.est.observe(v, now)
        if not ok and request_id is not None:
            st.violators.append((str(request_id), v))

    def observe_request(self, request_id, *,
                        ttft_s: Optional[float] = None,
                        tpot_s: Optional[float] = None,
                        ok: bool = True,
                        t: Optional[float] = None) -> None:
        """One finished request routed to the canonical targets
        (``ttft_p99`` / ``tpot_p99`` / ``goodput``) — the scheduler's
        single call site at result push."""
        now = t if t is not None else self.clock()
        if ttft_s is not None:
            self.observe("ttft_p99", ttft_s, request_id=request_id,
                         t=now)
        if tpot_s is not None:
            self.observe("tpot_p99", tpot_s, request_id=request_id,
                         t=now)
        self.observe("goodput", 1.0 if ok else 0.0,
                     request_id=request_id, t=now)

    # -- checking ----------------------------------------------------------

    def tick(self, *, now: Optional[float] = None,
             step: Optional[int] = None) -> Optional[Dict[str, Any]]:
        """Per-engine-step entry point: runs :meth:`check` every
        ``check_every``-th call (rate limiting for hot loops)."""
        self._ticks += 1
        if self._ticks % self.check_every:
            return None
        return self.check(now=now, step=step)

    def check(self, *, now: Optional[float] = None,
              step: Optional[int] = None) -> Dict[str, Any]:
        """Evaluate every target against every window pair, publish
        the burn-rate gauges, fire/clear alerts, and return the check
        summary (also mirrored into ``info["slo_window"]``)."""
        t = now if now is not None else self.clock()
        reg = self._registry
        self._checks += 1

        def cell(metric: str, help: str, **labels):
            key = (metric,) + tuple(sorted(labels.items()))
            c = self._cells.get(key)
            if c is None:
                c = reg.gauge(metric, help).bind(**labels)
                self._cells[key] = c
            return c

        out: Dict[str, Any] = {"targets": {}, "alerting": []}
        fires: List[Tuple[str, _TargetState, Dict[str, Any],
                          Optional[float]]] = []
        for name, st in self._state.items():
            tgt = st.target
            with self._lock:
                samples = list(st.samples)
            times = [s[0] for s in samples]
            pairs = []
            firing = None
            for long_s, short_s, thr in self.windows:
                n_lo = bisect.bisect_right(times, t - long_s)
                n_sh = bisect.bisect_right(times, t - short_s)
                w_lo, w_sh = samples[n_lo:], samples[n_sh:]
                bad_lo = sum(1 for _, _, ok in w_lo if not ok)
                bad_sh = sum(1 for _, _, ok in w_sh if not ok)
                frac_lo = bad_lo / len(w_lo) if w_lo else 0.0
                frac_sh = bad_sh / len(w_sh) if w_sh else 0.0
                burn_lo = frac_lo / tgt.budget
                burn_sh = frac_sh / tgt.budget
                cell("slo_burn_rate",
                     "error-budget burn rate per SLO and window (1.0 "
                     "= consuming exactly the budget)",
                     slo=name, window=f"{long_s:g}s").set(burn_lo)
                cell("slo_burn_rate", "", slo=name,
                     window=f"{short_s:g}s").set(burn_sh)
                pair = {"long_s": long_s, "short_s": short_s,
                        "threshold": thr,
                        "burn_long": round(burn_lo, 4),
                        "burn_short": round(burn_sh, 4),
                        "samples_long": len(w_lo),
                        "samples_short": len(w_sh)}
                pairs.append(pair)
                if (firing is None and burn_lo > thr and burn_sh > thr
                        and len(w_sh) >= self.min_samples):
                    firing = pair
            pctl = st.est.quantile(tgt.percentile, t)
            cell("slo_window_value",
                 "current windowed percentile (latency SLOs) or bad "
                 "fraction over the longest window",
                 slo=name).set(pctl if pctl is not None else 0.0)
            was = st.alerting
            st.alerting = firing is not None
            cell("slo_alert_active",
                 "1 while the SLO's burn-rate alert is latched",
                 slo=name).set(1.0 if st.alerting else 0.0)
            if st.alerting and not was:
                st.alerts += 1
                self._alerts_total += 1
                fires.append((name, st, firing, pctl))
            elif was and not st.alerting:
                reg.event("slo_recovered", slo=name, step=step)
            out["targets"][name] = {
                "objective": tgt.objective, "kind": tgt.kind,
                "budget": tgt.budget,
                "percentile": tgt.percentile,
                "window_value": pctl,
                "windows": pairs,
                "alerting": st.alerting,
                "alerts": st.alerts,
            }
            if st.alerting:
                out["alerting"].append(name)
        out["alerts_total"] = self._alerts_total
        prev = self._last_check
        self._last_check = out
        # the info mirror costs a json.dumps validation — refresh it
        # on alert-set changes and every `info_every`-th check, not
        # per step (summary()/introspect() always read _last_check)
        if (fires or prev is None
                or out["alerting"] != prev.get("alerting")
                or self._checks % self.info_every == 0):
            try:
                reg.set_info("slo_window", out)
            except (TypeError, ValueError):  # non-JSON-able — never fatal
                pass
        # fire AFTER the summary is stored, so the violation bundle's
        # embedded introspect()/summary() shows the alerting state the
        # alert describes, not the previous window
        for name, st, pair, pctl in fires:
            self._fire(name, st, pair, pctl, t, step)
        return out

    def _fire(self, name: str, st: _TargetState,
              pair: Dict[str, Any], pctl: Optional[float],
              t: float, step: Optional[int]) -> None:
        """One violation episode begins: ``slo_alert`` event +
        ``slo_violation`` flight bundle embedding the offending
        requests' traces and a live introspection snapshot."""
        from apex_tpu_torch.telemetry import flight as _flight

        reg = self._registry
        ids = [rid for rid, _ in st.violators]
        ev = reg.event("slo_alert", slo=name,
                       objective=st.target.objective,
                       window_value=pctl, step=step,
                       burn_long=pair["burn_long"],
                       burn_short=pair["burn_short"],
                       threshold=pair["threshold"],
                       long_s=pair["long_s"], short_s=pair["short_s"],
                       requests=ids)
        traces = None
        if self._trace_provider is not None:
            try:
                traces = self._trace_provider(ids)
            except Exception:  # noqa: BLE001 — evidence is best-effort
                traces = None
        intro = None
        if self._introspect_provider is not None:
            try:
                intro = self._introspect_provider()
            except Exception:  # noqa: BLE001
                intro = None
        _flight.notify(
            "slo_violation", fleet=False,
            error=RuntimeError(
                f"SLO {name!r} burn rate "
                f"{pair['burn_long']:.2f}/{pair['burn_short']:.2f} over "
                f"{pair['long_s']:g}s/{pair['short_s']:g}s windows "
                f"(threshold {pair['threshold']:g})"),
            extra={"slo": name, "event": ev, "requests": ids,
                   "violating_values": [v for _, v in st.violators],
                   "traces": traces, "introspect": intro})

    # -- the admission hook ------------------------------------------------

    def should_shed(self) -> bool:
        """True while any target's burn-rate alert is latched (and
        shedding is enabled) — the load-shedding signal the scheduler
        consults at admission (and the one a multi-engine router
        routes on)."""
        return self.shed and any(st.alerting
                                 for st in self._state.values())

    def alerting(self) -> List[str]:
        return [n for n, st in self._state.items() if st.alerting]

    def summary(self) -> Dict[str, Any]:
        """The newest check result (or a skeleton before the first
        check) — what ``introspect()`` and telemetry_dump render."""
        if self._last_check is not None:
            return self._last_check
        return {"targets": {n: {"objective": st.target.objective,
                                "kind": st.target.kind,
                                "budget": st.target.budget,
                                "alerting": False}
                            for n, st in self._state.items()},
                "alerting": [], "alerts_total": 0}


__all__ = [
    "DEFAULT_WINDOWS",
    "SLOMonitor",
    "SLOTarget",
    "SlidingWindowQuantile",
]
