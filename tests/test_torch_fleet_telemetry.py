"""apex_tpu_torch's fleet telemetry against apex_tpu's.

Mirrors tests/test_fleet.py: the variable-length snapshot gather over
the ``Collective`` contract (with its cap and truncation stub), the
merge (counters summed, gauges per host with min/max/mean, histograms
bucket-merged, timelines side by side), EWMA straggler detection and
the aggregation boundary, each run through both packages on the same
snapshots and held equal. The port's host snapshots (its
``snapshot_detail``) merge in the reference's merge as in its own, and
the port's flight recorder carries a gathered fleet snapshot when a
multi-replica collective is attached.
"""

import json
import threading

import pytest

from apex_tpu import telemetry as ref_telemetry
from apex_tpu.resilience import guard as ref_guard
from apex_tpu.telemetry import fleet as ref_fleet
from apex_tpu.telemetry import metrics as ref_metrics

from apex_tpu_torch import records, telemetry
from apex_tpu_torch.resilience import guard
from apex_tpu_torch.telemetry import fleet, flight
from apex_tpu_torch.telemetry import metrics as tmetrics

PORT = (telemetry, guard, fleet, tmetrics)
REF = (ref_telemetry, ref_guard, ref_fleet, ref_metrics)


@pytest.fixture(autouse=True)
def fresh_telemetry():
    telemetry.reset()
    ref_telemetry.reset()
    yield
    telemetry.reset()
    ref_telemetry.reset()


def host_snapshot(r, *, steps=4, step_ms=10.0, timeline=True, pkg=PORT):
    """One synthetic host's ``snapshot_detail``: a private registry and
    timeline of ``pkg``, as a real host's process-global ones look."""
    tel, _, _, met = pkg
    reg = met.MetricsRegistry()
    reg.counter("steps").inc(steps)
    reg.counter("skips").inc(r, kind="nonfinite")
    reg.gauge("queue_depth").set(float(r))
    reg.histogram("save_s", buckets=(0.1, 1.0)).observe(0.05 + r)
    tl_summary = None
    if timeline:
        tl = tel.StepTimeline(capacity=64)
        for i in range(steps):
            tl.record_span("step", i * 0.02, step_ms / 1e3, step=i)
            tl.record_span("data_wait", i * 0.02, 0.002, step=i)
        tl_summary = tl.summary()
    return {"registry": reg.snapshot(), "step_timeline": tl_summary,
            "mfu": None}


def run_fleet(group, fn):
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


def canon(x):
    return json.dumps(x, sort_keys=True)


# ---------------------------------------------------------------------------
# gather
# ---------------------------------------------------------------------------


class TestGather:
    def test_every_host_sees_all_snapshots_in_order(self):
        def host(r, h):
            return fleet.gather_snapshots(
                h, {"host": r, "blob": "x" * (10 * (r + 1))})

        for got in run_fleet(guard.LocalCollective(3), host):
            assert [s["host"] for s in got] == [0, 1, 2]
            assert [len(s["blob"]) for s in got] == [10, 20, 30]

    def test_null_collective_and_none_are_local(self):
        snap = {"host": 0}
        assert fleet.gather_snapshots(guard.NullCollective(), snap) == [snap]
        assert fleet.gather_snapshots(None, snap) == [snap]

    def test_default_snapshot_is_process_detail(self):
        telemetry.registry().counter("c").inc(5)
        [got] = fleet.gather_snapshots(None)
        assert got["registry"]["counters"]["c"] == 5.0
        assert set(got) == set(telemetry.snapshot_detail())

    @pytest.mark.parametrize("pkg", [PORT, REF], ids=["port", "ref"])
    def test_oversized_snapshot_rides_as_stub_not_silence(self, pkg):
        _, g, fl, met = pkg
        regs = [met.MetricsRegistry() for _ in range(3)]

        def host(r, handle):
            snap = host_snapshot(r)
            if r == 1:
                snap["blob"] = "x" * 4096
            return fl.gather_snapshots(handle, snap, max_bytes=1024,
                                       registry=regs[r])

        outs = run_fleet(g.LocalCollective(3), host)
        for got in outs:
            assert got[0]["registry"]["counters"]["steps"] == 4.0
            stub = got[1]
            assert stub["truncated"] is True and stub["replica_id"] == 1
            assert stub["max_bytes"] == 1024
            assert stub["original_bytes"] > 1024
            assert fl.merge_snapshots(got)["counters"]["steps"] == 8.0
        c1 = regs[1].snapshot()["counters"]
        assert c1["fleet_snapshot_truncated_total"] == 1.0
        assert all("fleet_snapshot_truncated_total"
                   not in regs[r].snapshot()["counters"] for r in (0, 2))

    def test_stub_equals_the_reference(self):
        assert fleet._truncation_stub(5000, 1024, 1) == \
            ref_fleet._truncation_stub(5000, 1024, 1)
        assert fleet.DEFAULT_SNAPSHOT_CAP_BYTES == \
            ref_fleet.DEFAULT_SNAPSHOT_CAP_BYTES == 4 << 20

    def test_default_cap_admits_normal_snapshots(self):
        outs = run_fleet(guard.LocalCollective(2), lambda r, h:
                         fleet.gather_snapshots(h, host_snapshot(r)))
        assert all("truncated" not in s for got in outs for s in got)


# ---------------------------------------------------------------------------
# merge
# ---------------------------------------------------------------------------


class TestMerge:
    def test_counters_sum_gauges_stat_histograms_bucket_merge(self):
        snaps = [host_snapshot(r) for r in range(3)]
        got = fleet.merge_snapshots(snaps)
        assert canon(got) == canon(ref_fleet.merge_snapshots(snaps))
        assert got["n_hosts"] == 3 and got["counters"]["steps"] == 12.0
        assert got["counters"]['skips{kind="nonfinite"}'] == 3.0
        g = got["gauges"]["queue_depth"]
        assert g["per_host"] == {"0": 0.0, "1": 1.0, "2": 2.0}
        assert (g["min"], g["max"], g["mean"]) == (0.0, 2.0, 1.0)
        h = got["histograms"]["save_s"]
        assert (h["count"], h["buckets"]["0.1"], h["buckets"]["+Inf"]) == \
            (3, 1, 3)
        assert set(got["step_timelines"]) == {"0", "1", "2"}

    def test_the_packages_hosts_merge_alike(self):
        """A port host's snapshot and a reference host's, built from the
        same events, merge to the same fleet snapshot in both packages."""
        mixed = [host_snapshot(0), host_snapshot(1, pkg=REF),
                 host_snapshot(2)]
        same = [host_snapshot(r, pkg=REF) for r in range(3)]
        want = canon(ref_fleet.merge_snapshots(same))
        assert canon(fleet.merge_snapshots(mixed)) == want
        assert canon(ref_fleet.merge_snapshots(mixed)) == want

    def test_disabled_timeline_host_merges_as_none(self):
        snaps = [host_snapshot(0), host_snapshot(1, timeline=False)]
        got = fleet.merge_snapshots(snaps)
        assert got["step_timelines"]["1"] is None
        assert got["counters"]["steps"] == 8.0
        assert list(fleet.phase_means_by_host(snaps, "step")) == [0] == \
            list(ref_fleet.phase_means_by_host(snaps, "step"))

    def test_empty_registry_host(self):
        snaps = [{"registry": {"counters": {}, "gauges": {},
                               "histograms": {}},
                  "step_timeline": None, "mfu": None}, host_snapshot(1)]
        assert fleet.merge_snapshots(snaps)["counters"]["steps"] == 4.0
        assert canon(fleet.merge_snapshots(snaps)) == \
            canon(ref_fleet.merge_snapshots(snaps))

    def test_port_snapshot_detail_has_no_goodput_section(self):
        """The goodput plane is not ported: a port host carries a null
        (with its reason), and the merge drops it as the reference drops
        a host whose ledger is disarmed."""
        snap = telemetry.snapshot_detail()
        assert snap["goodput"] is None and snap["goodput_reason"]
        merged = fleet.merge_snapshots([snap, snap])
        assert "goodput" not in merged
        assert "goodput" not in ref_fleet.merge_snapshots([snap, snap])


# ---------------------------------------------------------------------------
# stragglers
# ---------------------------------------------------------------------------


class TestStraggler:
    def test_slow_host_flagged_and_published(self):
        snaps = [host_snapshot(0), host_snapshot(1),
                 host_snapshot(2, step_ms=50.0)]
        agg = fleet.FleetAggregator(None, straggler_factor=2.0)
        rep = agg.straggler_report(snaps)
        assert rep == ref_fleet.FleetAggregator(
            None, straggler_factor=2.0).straggler_report(snaps)
        step = rep["phases"]["step"]
        assert step["median_ms"] == pytest.approx(10.0)
        assert step["spread"] == pytest.approx(5.0)
        assert [s["host"] for s in step["stragglers"]] == ["2"]
        agg._publish(rep)
        reg = telemetry.registry()
        assert reg.gauge("fleet_straggler_spread").value(
            phase="step") == pytest.approx(5.0)
        assert reg.gauge("fleet_stragglers").value() == 1.0
        assert reg.gauge("fleet_phase_ms").value(
            phase="step", host="2") == pytest.approx(50.0)
        assert reg.counter("telemetry_events").value(
            event="fleet_straggler") == 1.0

    def test_clean_fleet_flags_nobody(self):
        rep = fleet.FleetAggregator(None).straggler_report(
            [host_snapshot(r) for r in range(3)])
        assert rep["n_stragglers"] == 0
        assert rep["phases"]["step"]["stragglers"] == []
        assert rep["phases"]["step"]["spread"] == pytest.approx(1.0)

    def test_ewma_converges_not_jumps(self):
        seq = [[host_snapshot(r) for r in range(2)]] + \
            [[host_snapshot(0), host_snapshot(1, step_ms=90.0)]] * 2
        out = []
        for fl in (fleet, ref_fleet):
            agg = fl.FleetAggregator(None, straggler_factor=3.0,
                                     ewma_alpha=0.5)
            out.append([float(agg.straggler_report(s)["phases"]["step"][
                "per_host_ewma_ms"]["1"]) for s in seq])
        assert out[0] == out[1]
        assert out[0][1] == pytest.approx(50.0) and out[0][2] > out[0][1]

    def test_single_host_never_flags(self):
        rep = fleet.FleetAggregator(None).straggler_report(
            [host_snapshot(0, step_ms=500.0)])
        assert rep["n_stragglers"] == 0

    @pytest.mark.parametrize("kw,match", [({"straggler_factor": 1.0},
                                           "straggler_factor"),
                                          ({"ewma_alpha": 0.0},
                                           "ewma_alpha")])
    def test_knob_validation(self, kw, match):
        with pytest.raises(ValueError, match=match):
            fleet.FleetAggregator(None, **kw)


# ---------------------------------------------------------------------------
# the aggregation boundary
# ---------------------------------------------------------------------------


class TestAggregate:
    def _threaded(self, pkg):
        _, g, fl, _ = pkg

        def host(r, handle):
            agg = fl.FleetAggregator(handle)
            return agg.aggregate(host_snapshot(r, step_ms=10.0 * (r + 1)),
                                 publish=False)

        return run_fleet(g.LocalCollective(3), host)

    def test_threaded_fleet_aggregates_identically(self):
        got, want = self._threaded(PORT), self._threaded(REF)
        for fl in got:
            assert fl["counters"]["steps"] == 12.0
            assert fl["straggler"]["phases"]["step"]["spread"] == \
                pytest.approx(3.0)
            assert fl["aggregation_ms"] >= 0.0
        strip = [canon(dict(o, aggregation_ms=None)) for o in got + want]
        assert len(set(strip)) == 1

    def test_single_host_aggregate_uses_local_snapshot(self):
        telemetry.registry().counter("c").inc(2)
        fl = fleet.FleetAggregator(guard.NullCollective()).aggregate()
        assert fl["n_hosts"] == 1 and fl["counters"]["c"] == 2.0

    def test_flight_bundle_gathers_the_fleet(self, tmp_path, monkeypatch):
        """A fleet-safe dump over a multi-replica collective carries the
        merged fleet snapshot; a host-local one says why it has none."""
        monkeypatch.setattr(records, "RECORDS_DIR", str(tmp_path))

        def host(r, handle):
            rec = flight.FlightRecorder(collective=handle)
            return rec._fleet_snapshot(handle), rec

        outs = run_fleet(guard.LocalCollective(2), host)
        for snap, _ in outs:
            assert snap["n_hosts"] == 2 and "straggler" in snap
        rec = flight.FlightRecorder(collective=guard.NullCollective())
        path = rec.dump("test", fleet=True)
        with open(path) as f:
            bundle = json.load(f)["payload"]
        assert bundle["fleet"] is None
        assert bundle["fleet_unavailable"] == (
            "no multi-replica collective attached (single-host bundle)")
        assert (bundle["replica_id"], bundle["n_replicas"]) == (0, 1)
