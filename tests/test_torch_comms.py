"""apex_tpu_torch's comms plane, collectives and retry against apex_tpu's.

Mirrors tests/test_comms.py (its sharding cases aside: the port has no
sharding plane) and the retry cases of tests/test_resilience.py. Each
case runs the same ops, schedules and fault clauses through both
packages' ``telemetry.comms``, ``resilience.guard`` collectives and
``resilience.retry`` and holds the port to the reference: the same
results, op accounting, ledger rows (synthetic durations exactly,
measured ones by their structure), escalation events, counters and
backoff schedules. Replica sets are the threaded ``LocalCollective`` of
each package.
"""

import importlib
import json
import random
import threading
import time

import numpy as np
import pytest

from apex_tpu import telemetry as ref_telemetry
from apex_tpu.resilience import faults as ref_faults
from apex_tpu.resilience import guard as ref_guard
from apex_tpu.telemetry import comms as ref_comms
from apex_tpu.telemetry import fleet as ref_fleet
from apex_tpu.telemetry import metrics as ref_metrics

from apex_tpu_torch import telemetry
from apex_tpu_torch.resilience import faults, guard
from apex_tpu_torch.telemetry import comms
from apex_tpu_torch.telemetry import fleet as port_fleet
from apex_tpu_torch.telemetry import metrics as tmetrics

# the modules (each package's ``resilience.retry`` attribute is the
# decorator of the same name)
ref_retry = importlib.import_module("apex_tpu.resilience.retry")
port_retry = importlib.import_module("apex_tpu_torch.resilience.retry")

# (telemetry, comms, guard, faults, metrics, fleet) of each package
PORT = (telemetry, comms, guard, faults, tmetrics, port_fleet)
REF = (ref_telemetry, ref_comms, ref_guard, ref_faults, ref_metrics,
       ref_fleet)
BOTH = pytest.mark.parametrize("pkg", [PORT, REF], ids=["port", "ref"])


@pytest.fixture(autouse=True)
def fresh_telemetry():
    for tel, _, _, flt, _, _ in (PORT, REF):
        tel.reset()
        flt.install(None)
    yield
    for tel, _, _, flt, _, _ in (PORT, REF):
        flt.install(None)
        tel.reset()


def run_fleet(group, fn):
    """``fn(rid, handle)`` on one thread per simulated host of
    ``group`` (a LocalCollective); surfaces any thread's error."""
    n = group.n_replicas
    handles = group.handles()
    out, errs = [None] * n, [None] * n

    def loop(r):
        try:
            out[r] = fn(r, handles[r])
        except BaseException as e:  # noqa: BLE001
            errs[r] = e

    ts = [threading.Thread(target=loop, args=(r,), daemon=True)
          for r in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    for e in errs:
        if e is not None:
            raise e
    return out


def private_tracer(pkg, **kw):
    tel, cm, _, _, met, _ = pkg
    return cm.CommsTracer(registry=met.MetricsRegistry(),
                          timeline=tel.StepTimeline(capacity=256), **kw)


def drop_timing(stats):
    return {op: {k: v for k, v in st.items()
                 if k not in ("wall_ms", "last_ms", "max_ms", "ewma_ms")}
            for op, st in stats.items()}


def counters(tracer):
    return tracer.registry.snapshot()["counters"]


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------


class TestCollectives:
    def test_null_collective_echoes(self):
        x = np.arange(6, dtype=np.float32)
        for g in (guard, ref_guard):
            col = g.NullCollective()
            assert (col.n_replicas, col.replica_id) == (1, 0)
            assert col.all_gather(x).shape == (1, 6)
            [y] = col.broadcast_from(0, [x])
            assert np.array_equal(y, x)
            col.barrier()
            assert col.agree_any(True) and not col.agree_any(False)
            assert col.impl_name() == "NullCollective"

    def test_local_collective_gathers_and_broadcasts(self):
        def host(r, h):
            got = h.all_gather(np.full(3, r, np.int32))
            [b] = h.broadcast_from(1, [np.full(2, 10 * r, np.float32)])
            return got.tolist(), b.tolist(), h.agree_any(r == 2), \
                h.impl_name()

        got = run_fleet(guard.LocalCollective(3), host)
        want = run_fleet(ref_guard.LocalCollective(3), host)
        assert got == want
        assert got[0][0] == [[0] * 3, [1] * 3, [2] * 3]
        assert got[2][1] == [10.0, 10.0] and got[0][2] is True
        assert got[0][3] == "LocalCollective"


# ---------------------------------------------------------------------------
# instrument(): disabled means untouched
# ---------------------------------------------------------------------------


class TestInstrumentIdentity:
    def test_disabled_returns_the_exact_object(self):
        col = guard.NullCollective()
        assert comms.instrument(col) is col and not comms.enabled()

    def test_none_stays_none(self):
        assert comms.instrument(None) is None

    def test_enable_wraps_and_rewrap_is_idempotent(self):
        comms.enable()
        col = guard.NullCollective()
        wrapped = comms.instrument(col)
        assert isinstance(wrapped, comms.InstrumentedCollective)
        assert wrapped.inner is col and comms.instrument(wrapped) is wrapped
        assert (wrapped.n_replicas, wrapped.replica_id) == (1, 0)

    def test_rewrap_with_new_tracer_swaps_not_nests(self):
        t1, t2 = private_tracer(PORT), private_tracer(PORT)
        w1 = comms.instrument(guard.NullCollective(), tracer=t1)
        w2 = comms.instrument(w1, tracer=t2)
        assert w2 is not w1 and w2.inner is w1.inner and w2.tracer is t2

    def test_reset_disarms(self):
        comms.enable()
        assert comms.enabled()
        telemetry.reset()
        assert not comms.enabled()
        assert comms.section() == ref_comms.section()

    def test_env_knob_arms(self, monkeypatch):
        monkeypatch.setenv("APEX_TPU_COMMS", "1")
        comms.disable()
        try:
            assert comms.enabled()
            assert isinstance(comms.instrument(guard.NullCollective()),
                              comms.InstrumentedCollective)
        finally:
            monkeypatch.delenv("APEX_TPU_COMMS")
            comms.disable()

    def test_results_byte_identical_to_raw(self):
        col = comms.instrument(guard.NullCollective(),
                               tracer=private_tracer(PORT))
        x = np.arange(32, dtype=np.float32)
        assert np.array_equal(col.all_gather(x),
                              guard.NullCollective().all_gather(x))
        assert col.agree_any(True) is True and col.agree_any(False) is False


# ---------------------------------------------------------------------------
# op accounting
# ---------------------------------------------------------------------------


class TestOpAccounting:
    def _ops(self, pkg):
        tr = private_tracer(pkg)
        col = pkg[1].instrument(pkg[2].NullCollective(), tracer=tr)
        x = np.ones(256, np.float32)
        col.all_gather(x)
        col.broadcast_from(0, [x, x])
        col.barrier()
        col.agree_any(False)
        return tr

    def test_null_collective_ops_and_bytes(self):
        got, want = self._ops(PORT), self._ops(REF)
        assert drop_timing(got.op_stats()) == drop_timing(want.op_stats())
        assert counters(got) == counters(want)
        st = got.op_stats()
        assert [st[op]["payload_bytes"] for op in comms.COLLECTIVE_OPS] == \
            [1024, 2048, 0, 4]
        spans = got.timeline.spans()
        assert sorted(s.name for s in spans) == sorted(
            f"collective:{op}" for op in comms.COLLECTIVE_OPS)
        assert all(s.category == "collective" for s in spans)
        assert {s.name: s.args for s in spans} == \
            {s.name: s.args for s in want.timeline.spans()}
        ev = [e for e in got.timeline.export_trace()["traceEvents"]
              if e.get("name") == "collective:all_gather"]
        assert ev[0]["args"]["payload_bytes"] == 1024

    def test_local_collective_threaded_per_host_accounting(self):
        def host_for(pkg):
            def host(r, handle):
                tr = private_tracer(pkg)
                col = pkg[1].instrument(handle, tracer=tr)
                got = col.all_gather(np.full(64, r, np.float32))
                col.barrier()
                vote = col.agree_any(r == 1)
                return (np.asarray(got)[:, 0].tolist(), vote,
                        col.impl_name(), drop_timing(tr.op_stats()),
                        counters(tr))
            return host

        got = run_fleet(guard.LocalCollective(3), host_for(PORT))
        want = run_fleet(ref_guard.LocalCollective(3), host_for(REF))
        assert got == want
        rows, vote, impl, st, _ = got[0]
        assert rows == [0.0, 1.0, 2.0] and vote is True
        assert impl == "LocalCollective"
        assert st["all_gather"]["wire_bytes"] == 64 * 4 * 3
        assert st["agree_any"]["wire_bytes"] == 4 * 3

    def test_histograms_observe_bytes_and_ms(self):
        out = []
        for pkg in (PORT, REF):
            tr = private_tracer(pkg)
            col = pkg[1].instrument(pkg[2].NullCollective(), tracer=tr)
            col.all_gather(np.ones(1024, np.float32))
            col.barrier()
            h = tr.registry.snapshot()["histograms"]
            out.append((h['collective_bytes{op="all_gather"}'],
                        sorted(h),
                        h['collective_ms{op="barrier"}']["count"],
                        list(h['collective_ms{op="barrier"}']["buckets"])))
        assert out[0] == out[1]
        assert out[0][0]["sum"] == 4096.0
        assert 'collective_bytes{op="barrier"}' not in out[0][1]


# ---------------------------------------------------------------------------
# the analytic wire model and the ledger
# ---------------------------------------------------------------------------


class TestWireBytes:
    CASES = [("all_gather", 1000, 4), ("broadcast_from", 1000, 4),
             ("barrier", 0, 4), ("agree_any", 4, 4),
             ("all_to_all", 1000, 4), ("all_to_all", 1000, 2),
             ("all_to_all", 1024, 8), ("all_to_all", 1000, 1),
             ("all_gather", 100, 0), ("ppermute", 64, 8)]

    @pytest.mark.parametrize("op,payload,n", CASES)
    def test_analytic_model(self, op, payload, n):
        assert comms.wire_bytes(op, payload, n) == \
            ref_comms.wire_bytes(op, payload, n)

    def test_values(self):
        assert [comms.wire_bytes(*c) for c in self.CASES[:4]] == \
            [4000, 1000, 0, 16]


class TestLedger:
    def _drive(self, pkg, link=None):
        tr = private_tracer(pkg, link_gbps=link)
        for _ in range(2):
            tr.record("all_gather", "X", 1_000_000,
                      pkg[1].wire_bytes("all_gather", 1_000_000, 4),
                      t0=0.0, dur_s=0.010)
        tr.record("barrier", "X", 0, 0, t0=0.0, dur_s=0.001)
        return tr

    def test_measured_column_math(self):
        got = self._drive(PORT).ledger()
        assert got == self._drive(REF).ledger()
        row = got[0]
        assert (row["op"], row["calls"], row["payload_bytes"],
                row["wire_bytes"]) == ("all_gather", 2, 2_000_000,
                                       8_000_000)
        assert row["mean_ms"] == pytest.approx(10.0)
        assert row["measured_mbps"] == pytest.approx(400.0)

    def test_analytic_column_null_with_reason_without_link(self):
        rows = self._drive(PORT).ledger()
        assert rows[1]["analytic_ms"] is None
        assert "link_gbps" in rows[1]["analytic_reason"]
        assert rows[1]["measured_mbps"] is None

    def test_analytic_column_with_link(self):
        got = self._drive(PORT, link=8.0).ledger()
        assert got == self._drive(REF, link=8.0).ledger()
        assert got[0]["analytic_ms"] == pytest.approx(8.0)
        assert got[0]["measured_over_analytic"] == pytest.approx(2.5)
        assert "analytic_reason" not in got[0]

    def test_summary_carries_the_whole_story(self):
        out = []
        for pkg in (PORT, REF):
            tr = private_tracer(pkg)
            tr.record("barrier", "X", 0, 0, t0=0.0, dur_s=0.001)
            assert tr.summary()["clock_offsets"] is None
            tr.note_clock_offsets({"offsets_ms": {"0": 0.0},
                                   "spread_ms": 0.0, "rounds": 3,
                                   "rtt_ms": 0.1, "junk": 1})
            out.append(tr.summary())
        assert out[0] == out[1]
        assert out[0]["clock_offsets"]["rounds"] == 3
        assert "junk" not in out[0]["clock_offsets"]
        json.dumps(out[0])

    @pytest.mark.parametrize("kw,match", [({"slow_factor": 1.0},
                                           "slow_factor"),
                                          ({"ewma_alpha": 0.0},
                                           "ewma_alpha")])
    def test_knob_validation(self, kw, match):
        with pytest.raises(ValueError, match=match):
            comms.CommsTracer(registry=tmetrics.MetricsRegistry(), **kw)


# ---------------------------------------------------------------------------
# the collective_slow escalation
# ---------------------------------------------------------------------------


class TestSlowEscalation:
    def drive(self, pkg, ms_seq, op="barrier", **kw):
        tr = private_tracer(pkg, **kw)
        sink = pkg[4].InMemorySink()
        tr.registry.add_sink(sink)
        for ms in ms_seq:
            tr.record(op, "X", 0, 0, t0=0.0, dur_s=ms / 1e3)
        evs = [{k: v for k, v in e.items() if k != "wall_time"}
               for e in sink.events if e["event"] == "collective_slow"]
        return tr.op_stats(), evs, counters(tr)

    def both(self, ms_seq, **kw):
        got = self.drive(PORT, ms_seq, **kw)
        assert got == self.drive(REF, ms_seq, **kw)
        return got

    def test_latch_one_event_per_excursion(self):
        st, evs, c = self.both([1.0] * 6 + [50.0] * 3 + [1.0] * 2 + [50.0],
                               slow_factor=4.0, min_samples=5)
        assert st["barrier"]["slow_events"] == 2 and len(evs) == 2
        assert evs[0]["op"] == "barrier" and evs[0]["ms"] >= 50.0
        assert c['collective_slow_total{op="barrier"}'] == 2.0

    def test_slow_sample_never_raises_its_own_bar(self):
        st, _, _ = self.both([1.0] * 3 + [100.0] * 2, slow_factor=4.0,
                             min_samples=2, ewma_alpha=1.0)
        assert st["barrier"]["ewma_ms"] == pytest.approx(1.0)
        assert st["barrier"]["slow_events"] == 1

    def test_no_escalation_inside_warmup(self):
        st, _, _ = self.both([1.0] * 5 + [500.0], slow_factor=4.0,
                             min_samples=10)
        assert st["barrier"]["slow_events"] == 0

    def test_per_op_state_is_independent(self):
        out = []
        for pkg in (PORT, REF):
            tr = private_tracer(pkg, min_samples=2)
            for op, seq in (("barrier", [1.0] * 3 + [50.0]),
                            ("all_gather", [50.0] * 4)):
                for ms in seq:
                    tr.record(op, "X", 0, 0, t0=0.0, dur_s=ms / 1e3)
            st = tr.op_stats()
            out.append((st["barrier"]["slow_events"],
                        st["all_gather"]["slow_events"]))
        assert out[0] == out[1] == (1, 0)


# ---------------------------------------------------------------------------
# the collective fault clauses
# ---------------------------------------------------------------------------


class TestFaultClauses:
    def test_from_env_grammar(self):
        spec = ("collective_slow=25;collective_slow_at=2,4;"
                "collective_payload_corrupt=1")
        got = faults.FaultInjector.from_env(spec)
        want = ref_faults.FaultInjector.from_env(spec)
        for f in ("collective_slow_ms", "collective_slow_at",
                  "collective_corrupt_indices"):
            assert getattr(got, f) == getattr(want, f)
        assert got.collective_slow_at == frozenset({2, 4})

    def test_delay_applies_at_planned_indices_only(self):
        for flt in (faults, ref_faults):
            inj = flt.FaultInjector.from_env(
                "collective_slow=40;collective_slow_at=1")
            assert [inj.collective_delay_s() for _ in range(3)] == \
                [0.0, 0.040, 0.0]

    def test_empty_at_set_means_every_op(self):
        inj = faults.FaultInjector.from_env("collective_slow=10")
        assert all(inj.collective_delay_s() == pytest.approx(0.010)
                   for _ in range(3))

    def test_injected_delay_lands_in_the_measured_ms(self):
        tr = private_tracer(PORT)
        col = comms.instrument(guard.NullCollective(), tracer=tr)
        with faults.inject(collective_slow_ms=30.0):
            col.barrier()
        assert tr.op_stats()["barrier"]["last_ms"] >= 30.0

    def test_io_collective_raises_out_of_the_op(self):
        for pkg in (PORT, REF):
            tr = private_tracer(pkg)
            col = pkg[1].instrument(pkg[2].NullCollective(), tracer=tr)
            pkg[3].install(pkg[3].FaultInjector.from_env("io:collective=1"))
            col.barrier()
            with pytest.raises(pkg[3].FaultError, match="collective"):
                col.barrier()
            assert tr.op_stats()["barrier"]["calls"] == 1

    def test_corrupt_flips_one_byte_and_events(self):
        out = []
        for pkg in (PORT, REF):
            tr = private_tracer(pkg)
            sink = pkg[4].InMemorySink()
            tr.registry.add_sink(sink)
            col = pkg[1].instrument(pkg[2].NullCollective(), tracer=tr)
            x = np.ones(16, np.float32)
            pkg[3].install(pkg[3].FaultInjector.from_env(
                "collective_payload_corrupt=1"))
            clean = np.asarray(col.all_gather(x))
            bad = np.asarray(col.all_gather(x))
            diff = (bad.view(np.uint8).reshape(-1)
                    != clean.view(np.uint8).reshape(-1))
            evs = [(e["op"], e["payload_bytes"]) for e in sink.events
                   if e["event"] == "collective_payload_corrupt"]
            out.append((np.array_equal(clean[0], x), int(diff.sum()), evs,
                        bad.tobytes()))
        assert out[0] == out[1]
        assert out[0][:3] == (True, 1, [("all_gather", 64)])

    def test_broadcast_is_corruptible_barrier_is_not(self):
        for pkg in (PORT, REF):
            col = pkg[1].instrument(pkg[2].NullCollective(),
                                    tracer=private_tracer(pkg))
            pkg[3].install(pkg[3].FaultInjector.from_env(
                "collective_payload_corrupt=0"))
            col.barrier()
            [k, v] = col.broadcast_from(0, [np.ones(8, np.float32),
                                            np.ones(8, np.float32)])
            assert not np.array_equal(k, np.ones(8, np.float32))
            assert np.array_equal(v, np.ones(8, np.float32))


# ---------------------------------------------------------------------------
# clock offsets and the merged trace (telemetry/fleet.py)
# ---------------------------------------------------------------------------


class TestClockOffsets:
    def test_single_host_short_circuits(self):
        got = port_fleet.estimate_clock_offsets(guard.NullCollective())
        want = ref_fleet.estimate_clock_offsets(ref_guard.NullCollective())
        for k in ("n_hosts", "rounds", "offsets_ms", "local_offset_ms",
                  "spread_ms", "rtt_ms"):
            assert got[k] == want[k]
        assert set(got) == set(want)

    def test_recovers_injected_skew(self):
        skew = [0.0, 0.25, -0.1]

        def host(r, handle):
            reg = tmetrics.MetricsRegistry()
            return port_fleet.estimate_clock_offsets(
                handle, rounds=5, registry=reg,
                clock=lambda: time.perf_counter() + skew[r]), reg

        for r, (out, reg) in enumerate(run_fleet(guard.LocalCollective(3),
                                                 host)):
            assert out["n_hosts"] == 3
            for h in range(3):
                assert out["offsets_ms"][str(h)] == pytest.approx(
                    (skew[h] - skew[0]) * 1e3, abs=10.0)
            assert out["local_offset_ms"] == out["offsets_ms"][str(r)]
            assert out["spread_ms"] == pytest.approx(350.0, abs=20.0)
            g = reg.snapshot()["gauges"]
            assert g['fleet_clock_offset_ms{host="1"}'] == pytest.approx(
                250.0, abs=10.0)
            assert "fleet_clock_offset_spread_ms" in g

    def test_deposits_into_armed_tracer(self):
        comms.enable()
        run_fleet(guard.LocalCollective(2),
                  lambda r, h: port_fleet.estimate_clock_offsets(
                      h, rounds=2, registry=tmetrics.MetricsRegistry()))
        assert comms.get_tracer().clock_offsets["rounds"] == 2


class TestMergedTrace:
    def _merged(self, pkg):
        tel, cm, g, _, met, fl = pkg

        def host(r, handle):
            tl = tel.StepTimeline(capacity=64)
            tr = cm.CommsTracer(registry=met.MetricsRegistry(), timeline=tl)
            col = cm.instrument(handle, tracer=tr)
            with tl.phase("work"):
                col.barrier()
            inst = [{"event": "collective_slow", "wall_time": time.time(),
                     "op": "barrier", "host": r}]
            return fl.export_fleet_trace(col, timeline=tl,
                                         instant_events=inst)

        return run_fleet(g.LocalCollective(2), host)

    @staticmethod
    def shape(trace):
        return sorted((e.get("ph"), e["name"], e.get("pid"), e.get("tid"),
                       tuple(sorted(e.get("args", {})))
                       if e.get("ph") != "M" else repr(e.get("args")))
                      for e in trace["traceEvents"])

    def test_merged_trace_well_formed(self):
        got, want = self._merged(PORT), self._merged(REF)
        for trace in got:
            json.dumps(trace)
            evs = trace["traceEvents"]
            assert {e["pid"] for e in evs if e.get("ph") == "X"} == {0, 1}
            for r in (0, 1):
                bars = [e for e in evs if e.get("ph") == "X"
                        and e["pid"] == r
                        and e["name"] == "collective:barrier"]
                assert bars and bars[0]["args"]["payload_bytes"] == 0
            inst = [e for e in evs if e.get("ph") == "i"]
            assert {e["pid"] for e in inst} == {0, 1}
            assert all(e["ts"] >= 0 for e in evs if "ts" in e)
            assert trace["otherData"]["n_hosts"] == 2
        assert [self.shape(t) for t in got] == [self.shape(t) for t in want]

    def test_offset_correction_aligns_shared_instant(self):
        skew = [0.0, 0.2]

        def host(r, handle):
            clk = lambda: time.perf_counter() + skew[r]   # noqa: E731
            tl = telemetry.StepTimeline(capacity=64, clock=clk)
            tr = comms.CommsTracer(registry=tmetrics.MetricsRegistry(),
                                   timeline=tl, clock=clk)
            col = comms.instrument(handle, tracer=tr)
            off = port_fleet.estimate_clock_offsets(
                col, rounds=5, clock=clk,
                registry=tmetrics.MetricsRegistry())
            col.barrier()
            return port_fleet.export_fleet_trace(col, timeline=tl,
                                                 offsets=off)

        evs = run_fleet(guard.LocalCollective(2), host)[0]["traceEvents"]
        last = {}
        for e in evs:
            if e.get("ph") == "X" and e["name"] == "collective:barrier":
                last[e["pid"]] = e["ts"]
        assert set(last) == {0, 1} and abs(last[0] - last[1]) < 50e3

    def test_disabled_timeline_host_contributes_metadata_only(self):
        def host(r, handle):
            tl = telemetry.StepTimeline(capacity=8, enabled=(r == 0))
            if r == 0:
                tl.record_span("step", tl.clock(), 0.001)
            return port_fleet.export_fleet_trace(handle, timeline=tl,
                                                 instant_events=[])

        evs = run_fleet(guard.LocalCollective(2), host)[0]["traceEvents"]
        assert all(e["pid"] == 0 for e in evs if e.get("ph") == "X")
        assert any(e.get("ph") == "M" and e.get("pid") == 1 for e in evs)


class TestSection:
    def test_disabled_marker(self):
        s = comms.section()
        assert s == ref_comms.section()
        assert s["enabled"] is False and "APEX_TPU_COMMS" in s["reason"]

    def test_armed_summary(self):
        out = []
        for pkg in (PORT, REF):
            pkg[1].enable()
            pkg[1].instrument(pkg[2].NullCollective()).barrier()
            s = pkg[1].section()
            out.append((s["enabled"], s["ops"]["barrier"]["calls"],
                        sorted(s)))
        assert out[0] == out[1] == (True, 1, out[0][2])

    def test_flight_bundle_carries_the_section(self, tmp_path, monkeypatch):
        from apex_tpu_torch import records
        from apex_tpu_torch.telemetry import flight

        monkeypatch.setattr(records, "RECORDS_DIR", str(tmp_path))
        comms.enable()
        comms.instrument(guard.NullCollective()).barrier()
        rec = flight.enable()
        try:
            path = rec.dump("test", fleet=False)
        finally:
            flight.disable()
        with open(path) as f:
            bundle = json.load(f)["payload"]
        assert bundle["comms"]["enabled"] is True
        assert bundle["comms"]["ops"]["barrier"]["calls"] == 1


# ---------------------------------------------------------------------------
# retry (tests/test_resilience.py's TestRetry)
# ---------------------------------------------------------------------------


class _Flaky:
    def __init__(self, fails, exc=OSError):
        self.n, self.fails, self.exc = 0, fails, exc

    def __call__(self):
        self.n += 1
        if self.n <= self.fails:
            raise self.exc("transient")
        return "ok"


RETRIES = pytest.mark.parametrize("rt", [port_retry, ref_retry],
                                  ids=["port", "ref"])


class TestRetry:
    @RETRIES
    def test_success_after_transient(self, rt):
        f, slept = _Flaky(2), []
        assert rt.retry_call(f, retries=4, base_delay=0.1, jitter=0.0,
                             sleep=slept.append) == "ok"
        assert f.n == 3 and slept == [0.1, 0.2]

    @RETRIES
    def test_exhaustion_reraises_original(self, rt):
        with pytest.raises(OSError, match="dead disk"):
            rt.retry_call(lambda: (_ for _ in ()).throw(OSError("dead disk")),
                          retries=2, base_delay=0.0, sleep=lambda d: None)

    @RETRIES
    def test_retry_on_filters(self, rt):
        f = _Flaky(100, ValueError)
        with pytest.raises(ValueError):
            rt.retry_call(_Flaky(100, ValueError), retries=3,
                          retry_on=(OSError,), sleep=lambda d: None)
        with pytest.raises(ValueError):
            rt.retry_call(f, retries=3, retry_on=(ValueError,),
                          base_delay=0.0, sleep=lambda d: None)
        assert f.n == 4

    @RETRIES
    def test_deadline_bounds_total_time(self, rt):
        clock = {"t": 0.0, "n": 0}

        def dead():
            clock["n"] += 1
            clock["t"] += 0.4
            raise OSError("down")

        def sleep(d):
            clock["t"] += d

        with pytest.raises(OSError):
            rt.retry_call(dead, retries=50, base_delay=0.1, factor=1.0,
                          jitter=0.0, deadline=1.0, sleep=sleep,
                          monotonic=lambda: clock["t"])
        assert clock["n"] <= 3 and clock["t"] <= 1.5

    def test_jitter_schedule_equals_the_reference(self):
        for seed in (7, 8):
            assert port_retry.backoff_delays(
                6, jitter=0.5, base_delay=0.05, max_delay=0.5,
                rng=random.Random(seed)) == ref_retry.backoff_delays(
                6, jitter=0.5, base_delay=0.05, max_delay=0.5,
                rng=random.Random(seed))
        a = port_retry.backoff_delays(4, rng=random.Random(7))
        assert a != port_retry.backoff_delays(4, rng=random.Random(8))

    @RETRIES
    def test_on_retry_callback(self, rt):
        seen = []
        rt.retry_call(_Flaky(2), retries=3, base_delay=0.01, jitter=0.0,
                      on_retry=lambda i, e, d: seen.append((i, str(e), d)),
                      sleep=lambda d: None)
        assert seen == [(0, "transient", 0.01), (1, "transient", 0.02)]

    @RETRIES
    def test_engine_crash_on_the_give_up_list(self, rt):
        flt = faults if rt is port_retry else ref_faults
        f, slept = _Flaky(5, flt.EngineCrash), []
        with pytest.raises(flt.EngineCrash):
            rt.retry_call(f, retries=5, base_delay=0.1,
                          retry_on=(Exception,),
                          give_up_on=(flt.EngineCrash,), sleep=slept.append)
        assert f.n == 1 and slept == []
        # siblings not on the list keep retrying
        f2 = _Flaky(2, RuntimeError)
        assert rt.retry_call(f2, retries=5, base_delay=0.0,
                             retry_on=(RuntimeError,),
                             give_up_on=(flt.EngineCrash,),
                             sleep=lambda d: None) == "ok"

    @BOTH
    def test_named_site_publishes_attempts_and_terminals(self, pkg,
                                                         monkeypatch):
        tel, _, _, flt, met, _ = pkg
        rt = port_retry if pkg is PORT else ref_retry
        reg = met.MetricsRegistry()
        sink = met.InMemorySink()
        reg.add_sink(sink)
        monkeypatch.setattr(met, "_REGISTRY", reg)
        assert rt.retry_call(_Flaky(2), retries=4, base_delay=0.0,
                             jitter=0.0, sleep=lambda d: None,
                             site="disk") == "ok"
        assert reg.counter("retry_attempts").value(site="disk") == 2
        evs = [e for e in sink.events if e["event"] == "retry"]
        assert [e["attempt"] for e in evs] == [0, 1]
        assert all("transient" in e["error"] for e in evs)
        with pytest.raises(OSError):
            rt.retry_call(lambda: (_ for _ in ()).throw(OSError("dead")),
                          retries=1, base_delay=0.0, sleep=lambda d: None,
                          site="disk")
        assert reg.counter("retry_exhausted").value(site="disk") == 1
        with pytest.raises(flt.EngineCrash):
            rt.retry_call(_Flaky(9, flt.EngineCrash), retries=3,
                          retry_on=(Exception,),
                          give_up_on=(flt.EngineCrash,), base_delay=0.0,
                          sleep=lambda d: None, site="fleet_router")
        assert reg.counter("retry_give_up").value(site="fleet_router") == 1
        assert reg.counter("retry_attempts").value(site="fleet_router") == 0

    @BOTH
    def test_siteless_calls_publish_nothing(self, pkg, monkeypatch):
        met = pkg[4]
        rt = port_retry if pkg is PORT else ref_retry
        reg = met.MetricsRegistry()
        monkeypatch.setattr(met, "_REGISTRY", reg)
        with pytest.raises(OSError):
            rt.retry_call(lambda: (_ for _ in ()).throw(OSError("x")),
                          retries=1, base_delay=0.0, sleep=lambda d: None)
        assert not any(n.startswith("retry")
                       for n in reg.snapshot().get("counters", {}))

    @pytest.mark.parametrize("spec,written", [
        ("io:record_write=0,1", True),
        ("io_permanent:record_write=0", False),
    ], ids=["transient", "permanent"])
    def test_write_record_retries_at_site_record_write(
            self, spec, written, tmp_path, monkeypatch):
        from apex_tpu import records as ref_records
        from apex_tpu_torch import records

        seen = []
        for (_, _, _, flt, met, _), rec, sub in (
                (PORT, records, "port"), (REF, ref_records, "ref")):
            reg = met.MetricsRegistry()
            monkeypatch.setattr(met, "_REGISTRY", reg)
            monkeypatch.setattr(rec, "RECORDS_DIR", str(tmp_path / sub))
            flt.install(flt.FaultInjector.from_env(spec))
            try:
                path = rec.write_record("retry_probe", {"x": 1})
            finally:
                flt.install(None)
            assert (path is not None) == written
            seen.append({k: v for k, v in
                         reg.snapshot()["counters"].items()
                         if k.startswith("retry_")})
        assert seen[0] == seen[1]
        want = {'retry_attempts{site="record_write"}': 2.0 if written
                else 3.0}
        if not written:
            want['retry_exhausted{site="record_write"}'] = 1.0
        assert seen[0] == want

    @RETRIES
    def test_keyboard_interrupt_never_retried(self, rt):
        f = _Flaky(5, KeyboardInterrupt)
        with pytest.raises(KeyboardInterrupt):
            rt.retry_call(f, retries=5, retry_on=(BaseException,),
                          base_delay=0.0, sleep=lambda d: None)
        assert f.n == 1

    @RETRIES
    def test_decorator_form(self, rt):
        f = _Flaky(1)

        @rt.retry(retries=2, base_delay=0.0, sleep=lambda d: None)
        def call():
            return f()

        assert call() == "ok" and f.n == 2
