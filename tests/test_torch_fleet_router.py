"""apex_tpu_torch's fleet router against apex_tpu's.

Mirrors tests/test_fleet_router.py test by test. Each scenario runs the
same requests and fault clauses through one ``FleetRouter`` of each
package (``torch_fleet_pair.FleetPair``: engines of the tiny fp32 GPT,
the port's weights from the reference's by ``load_jax_params``) and
holds the port to the reference: per request id the same tokens (greedy
and sampled lanes), the same step reports, counters, events, failover
records (source, snapshot, recovered ids), hedged ids, handoff
statistics, traces and ``introspect()`` keys; and, where the reference
test checks it, the same single-engine tokens.
"""

import numpy as np
import pytest

from apex_tpu import records as ref_records
from apex_tpu import serving as ref_serving
from apex_tpu import telemetry as ref_telemetry
from apex_tpu.resilience import faults as ref_faults
from apex_tpu.telemetry import flight as ref_flight

from apex_tpu_torch import records, serving, telemetry
from apex_tpu_torch.resilience import faults
from apex_tpu_torch.telemetry import flight

from torch_fleet_pair import (
    BLOCKS,
    BS,
    VOCAB,
    FakeSLO,
    FleetPair,
    both_inject,
    build_models,
    key_tree,
    mk_requests,
    run_clean,
)

SAMPLED = dict(temperature=0.8, top_k=8, top_p=0.9)


@pytest.fixture(scope="module")
def models():
    return build_models()


@pytest.fixture()
def records_dirs(tmp_path, monkeypatch):
    monkeypatch.setattr(ref_records, "RECORDS_DIR", str(tmp_path / "ref"))
    monkeypatch.setattr(records, "RECORDS_DIR", str(tmp_path / "port"))
    return tmp_path


@pytest.fixture()
def both_flight(records_dirs):
    ref_flight.enable()
    flight.enable()
    yield records_dirs
    ref_flight.disable()
    flight.disable()


def latest_bundles():
    want = ref_records.latest_record(ref_flight.FLIGHT_KIND,
                                     require_backend=None)
    got = records.latest_record(flight.FLIGHT_KIND)
    return got["payload"], want["payload"]


def mixed_requests(n, seed):
    """``n`` requests, every other one sampled with its own seed."""
    reqs = mk_requests(n, np.random.RandomState(seed))
    for r in reqs:
        if r["id"] % 2:
            r.update(SAMPLED, seed=100 + r["id"])
    return reqs


# ---------------------------------------------------------------------------
# fault grammar
# ---------------------------------------------------------------------------


class TestFaultGrammar:
    SPEC = ("engine_crash=5,9;engine_crash_engine=1;engine_stall_ms=250;"
            "engine_stall_engine=2;engine_stall_at=3;"
            "router_snapshot_missing=0,2;io:fleet_router=1")

    def test_env_grammar_parses_fleet_clauses(self):
        got = faults.FaultInjector.from_env(self.SPEC)
        want = ref_faults.FaultInjector.from_env(self.SPEC)
        for f in ("engine_crash_steps", "engine_crash_engine",
                  "engine_stall_ms", "engine_stall_engine",
                  "engine_stall_at", "router_snapshot_missing",
                  "io_errors"):
            assert getattr(got, f) == getattr(want, f), f
        assert got.io_errors["fleet_router"] == frozenset({1})

    def test_engine_crash_is_engine_and_step_scoped(self):
        for mod in (faults, ref_faults):
            inj = mod.FaultInjector(engine_crash_steps=frozenset({5}),
                                    engine_crash_engine=1)
            inj.maybe_engine_crash(5, 0)
            inj.maybe_engine_crash(4, 1)
            with pytest.raises(mod.EngineCrash, match="engine 1 at router "
                               "step 5"):
                inj.maybe_engine_crash(5, 1)
        assert not issubclass(faults.EngineCrash, OSError)

    def test_engine_stall_plan(self):
        for mod in (faults, ref_faults):
            inj = mod.FaultInjector(engine_stall_ms=200.0,
                                    engine_stall_engine=0,
                                    engine_stall_at=frozenset({2}))
            assert [inj.engine_stall_s(s, e) for s, e in
                    ((2, 0), (3, 0), (2, 1))] == [0.2, 0.0, 0.0]
            every = mod.FaultInjector(engine_stall_ms=100.0)
            assert every.engine_stall_s(7, 0) == pytest.approx(0.1)

    def test_router_snapshot_missing(self):
        for mod in (faults, ref_faults):
            inj = mod.FaultInjector(router_snapshot_missing=frozenset({1}))
            assert [inj.should_skip_router_snapshot(i)
                    for i in range(3)] == [False, True, False]
        with faults.inject(router_snapshot_missing=frozenset({0})):
            assert faults.should_skip_router_snapshot(0)
        assert not faults.should_skip_router_snapshot(0)


# ---------------------------------------------------------------------------
# structured refusals
# ---------------------------------------------------------------------------


class TestStructuredRefusals:
    def test_oversized_reason(self, models):
        pair = FleetPair(models, ["colocated"])
        pair.submit(id="big", prompt=[1] * 60, max_new_tokens=60)
        [res] = pair.drive()
        assert (res.finish_reason, res.reason) == ("error", "oversized")
        pair.check()

    def test_draining_reason(self, models):
        pair = FleetPair(models, ["colocated", "colocated"])
        for rh, ph in (pair.handle("e0"),):
            rh.batcher.draining = ph.batcher.draining = True
        pair.r.placement = pair.p.placement = "round_robin"
        pair.submit(id="late", prompt=[1], max_new_tokens=1)
        pair.submit(id="ok", prompt=[1, 2], max_new_tokens=2)
        res = {r.id: r for r in pair.drive()}
        assert (res["late"].finish_reason, res["late"].reason) == \
            ("error", "draining")
        assert res["ok"].reason is None
        pair.check()

    def test_take_queued_withdraws_newest_first(self, models):
        pair = FleetPair(models, [])
        rb, pb = pair.engines()
        for i in range(3):
            rb.submit(ref_serving.Request(id=i, prompt=[1, 2],
                                          max_new_tokens=1))
            pb.submit(serving.Request(id=i, prompt=[1, 2],
                                      max_new_tokens=1))
        moved = pb.take_queued(2)
        assert [r.id for r, _ in moved] == [r.id for r, _ in
                                              rb.take_queued(2)] == [2, 1]
        assert [r.id for r, _ in pb.queue] == [0]
        assert pb.drain() == [] == rb.drain()


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


class TestPlacement:
    def _run(self, models, placement):
        rng = np.random.RandomState(31)
        pa = [int(t) for t in rng.randint(0, VOCAB, (2 * BS,))]
        pb = [int(t) for t in rng.randint(0, VOCAB, (2 * BS,))]
        pair = FleetPair(models, ["colocated", "colocated"],
                         placement=placement)
        seeds = {"a": pair.submit(id="seed-a", prompt=pa + [1],
                                  max_new_tokens=2),
                 "b": pair.submit(id="seed-b", prompt=pb + [2],
                                  max_new_tokens=2)}
        pair.drive()
        routed = {"a": [], "b": []}
        for i in range(4):
            routed["a"].append(pair.submit(id=f"a{i}", prompt=pa + [3 + i],
                                           max_new_tokens=2))
        for i in range(4):
            routed["b"].append(pair.submit(id=f"b{i}", prompt=pb + [10 + i],
                                           max_new_tokens=2))
        pair.drive()
        pair.check()
        return seeds, routed, pair

    def test_affinity_beats_round_robin(self, models):
        seeds, routed, aff = self._run(models, "affinity")
        assert set(routed["a"]) == {seeds["a"]}
        assert set(routed["b"]) == {seeds["b"]}
        assert aff.counter("fleet_prefix_affinity_hits") >= 8
        _, _, rr = self._run(models, "round_robin")
        assert rr.counter("fleet_prefix_affinity_hits") == 0
        miss_aff = aff.counter("serving_prefix_cache_hits", outcome="miss")
        miss_rr = rr.counter("serving_prefix_cache_hits", outcome="miss")
        assert miss_aff == 2 and miss_rr > miss_aff

    def test_least_queue_fallback_spreads(self, models):
        pair = FleetPair(models, ["colocated", "colocated"],
                         placement="least_queue")
        names = [pair.submit(**r)
                 for r in mk_requests(4, np.random.RandomState(32))]
        assert names == ["e0", "e1", "e0", "e1"]
        pair.drive()
        pair.check()

    def test_shed_deprioritized_then_fleet_refusal(self, models):
        slos = [(FakeSLO(), FakeSLO()), (FakeSLO(), FakeSLO())]
        pair = FleetPair(models, ["colocated", "colocated"], slos=slos,
                         placement="least_queue")
        for s in slos[0]:
            s.shed = True
        for i in range(3):
            assert pair.submit(id=f"s{i}", prompt=[1, 2, 3],
                               max_new_tokens=2) == "e1"
        pair.drive()
        for s in slos[1]:
            s.shed = True
        assert pair.submit(id="refused", prompt=[5, 6],
                           max_new_tokens=2) is None
        [res] = pair.merge()
        assert (res.id, res.finish_reason, res.reason) == \
            ("refused", "error", "shedding")
        assert pair.counter("fleet_shed") == 1
        assert "fleet_shed" in [e["event"] for e in pair.psink.events]
        tr = [d for d in pair.ptr.trace_dicts()
              if d["request_id"] == "refused"]
        assert tr and tr[-1]["outcome"] == "rejected"
        pair.check()


# ---------------------------------------------------------------------------
# failover
# ---------------------------------------------------------------------------


class TestFailover:
    def _crash_run(self, models, tmp_path, **extra):
        reqs = mixed_requests(6, 41)
        clean = run_clean(models, reqs)
        pair = FleetPair(models, ["colocated", "colocated"],
                         placement="least_queue",
                         snapshot_dir=tmp_path / "snaps")
        with both_inject(engine_crash_steps=frozenset({2}),
                         engine_crash_engine=0, **extra):
            for r in reqs:
                pair.submit(**r)
            results = pair.drive()
        pair.check()
        return clean, {r.id: r for r in results}, pair

    def _bundle_check(self, source):
        got, want = latest_bundles()
        assert got["trigger"] == want["trigger"] == "fleet_engine_lost"
        g, w = got["extra"], want["extra"]
        assert g["plan"]["source"] == w["plan"]["source"] == source
        assert g["plan"]["targets"] == w["plan"]["targets"]
        assert g["plan"]["recovered"] == w["plan"]["recovered"]
        assert key_tree(g["last_introspect"]) is not None
        assert set(g["last_introspect"]) == set(w["last_introspect"])
        assert got["fleet_unavailable"] == want["fleet_unavailable"]

    def test_crash_recovers_snapshot_path(self, models, both_flight):
        clean, res, pair = self._crash_run(models, both_flight)
        assert sorted(res) == sorted(clean)
        assert {i: r.tokens for i, r in res.items()} == clean
        [fo] = pair.p.failovers
        assert (fo["engine"], fo["cause"], fo["source"]) == \
            ("e0", "crash", "snapshot")
        assert fo["snapshot"] and fo["recovered"]
        assert pair.counter("fleet_failovers", cause="crash") == 1
        assert pair.counter("fleet_requests_rerouted", cause="crash") == \
            len(fo["recovered"])
        self._bundle_check("snapshot")
        rid = fo["recovered"][0]
        segs = [d for d in pair.ptr.trace_dicts()
                if d["request_id"] == str(rid)]
        assert len(segs) == 2 and len({d["trace_id"] for d in segs}) == 1
        assert segs[0]["outcome"] == "drained" and segs[1]["resumed_from"]
        trace = pair.ptr.export_trace()
        tids = {e["tid"] for e in trace["traceEvents"]
                if e.get("cat") == "request"
                and e["args"].get("trace_id") == segs[0]["trace_id"]}
        assert len(tids) == 1

    def test_crash_recovers_forced_replay_path(self, models, both_flight):
        clean, res, pair = self._crash_run(
            models, both_flight, router_snapshot_missing=frozenset({0}))
        assert {i: r.tokens for i, r in res.items()} == clean
        [fo] = pair.p.failovers
        assert fo["source"] == "replay" and fo["snapshot"] is None
        self._bundle_check("replay")

    def test_transient_router_fault_absorbed(self, models):
        reqs = mk_requests(4, np.random.RandomState(43))
        clean = run_clean(models, reqs)
        pair = FleetPair(models, ["colocated", "colocated"],
                         placement="least_queue", retry_base_delay=0.0)
        with both_inject(io_errors={"fleet_router": frozenset({1})}):
            for r in reqs:
                pair.submit(**r)
            res = pair.drive()
        assert {r.id: r.tokens for r in res} == clean
        assert pair.p.failovers == [] and \
            pair.counter("fleet_failovers") == 0
        pair.check()

    def test_wedged_engine_fenced_after_consecutive_failures(self, models):
        reqs = mk_requests(4, np.random.RandomState(44))
        clean = run_clean(models, reqs)
        pair = FleetPair(models, ["colocated", "colocated"],
                         placement="least_queue", max_step_failures=2,
                         step_retries=0, retry_base_delay=0.0)
        for r in reqs:
            pair.submit(**r)
        rh, ph = pair.handle("e0")
        real = (rh.batcher.step, ph.batcher.step)

        def wedged(state):
            raise RuntimeError("wedged engine")

        rh.batcher.step = ph.batcher.step = wedged
        pair.step()
        assert pair.handle("e0")[1].status == "active"
        assert ph.step_failures == 1
        pair.step()
        assert pair.handle("e0")[1].status == "fenced"
        rh.batcher.step, ph.batcher.step = real
        res = pair.drive()
        assert {r.id: r.tokens for r in res} == clean
        [fo] = pair.p.failovers
        assert fo["cause"] == "wedged"
        assert pair.counter("fleet_engine_step_errors", engine="e0") == 2
        pair.check()


# ---------------------------------------------------------------------------
# hedge, not kill
# ---------------------------------------------------------------------------


class TestHedge:
    def test_stalled_engine_hedges_and_survives(self, models):
        reqs = mixed_requests(8, 51)
        clean = run_clean(models, reqs)
        pair = FleetPair(models, ["colocated", "colocated"],
                         placement="least_queue", stall_after_s=0.25,
                         hedge_max=2,
                         engine_kw=dict(max_batch=2, max_prefill_batch=2))
        with both_inject(engine_stall_ms=600.0, engine_stall_engine=0,
                         engine_stall_at=frozenset({1})):
            for r in reqs:
                pair.submit(**r)
            res = pair.drive()
        assert {r.id: r.tokens for r in res} == clean
        _, h0 = pair.handle("e0")
        assert h0.status in ("active", "stalled")
        assert pair.p.failovers == []
        assert 0 < h0.hedged <= 2
        assert pair.counter("fleet_requests_rerouted", cause="hedge") == \
            h0.hedged
        moved = [e["moved"] for e in pair.psink.events
                 if e["event"] == "fleet_engine_hedged"]
        assert moved == [e["moved"] for e in pair.rsink.events
                         if e["event"] == "fleet_engine_hedged"]
        assert len(moved[0]) == h0.hedged
        rerouted = [d for d in pair.ptr.trace_dicts()
                    if d["outcome"] == "rerouted"]
        assert rerouted and any(
            d["trace_id"] == rerouted[0]["trace_id"]
            and d["outcome"] in ("length", "eos")
            for d in pair.ptr.trace_dicts())
        pair.check()


# ---------------------------------------------------------------------------
# elastic membership
# ---------------------------------------------------------------------------


class TestMembership:
    def test_join_and_leave_under_load(self, models, tmp_path):
        reqs = mixed_requests(8, 61)
        clean = run_clean(models, reqs)
        pair = FleetPair(models, ["colocated", "colocated"],
                         placement="least_queue", snapshot_dir=tmp_path)
        results = []
        for r in reqs:
            pair.submit(**r)
        for _ in range(2):
            pair.step()
            results.extend(pair.merge())
        _, h2 = pair.add(
            "e2", warm=True,
            pair=pair.engines(registries=(ref_telemetry.MetricsRegistry(),
                                          telemetry.MetricsRegistry())))
        assert h2.status == "active" and h2.batcher.tracer is pair.ptr
        # the port compiles no shape buckets: a bucket value is refused
        with pytest.raises(ValueError, match="no shape buckets"):
            h2.batcher.warmup(h2.state, seq_buckets=(8,))
        out = pair.p.remove_engine("e0")
        want = pair.r.remove_engine("e0")
        assert (out["source"], out["recovered"], out["targets"]) == \
            (want["source"], want["recovered"], want["targets"]) and \
            out["source"] == "snapshot"
        results.extend(pair.drive())
        assert {r.id: r.tokens for r in results} == clean
        assert pair.handle("e0")[1].status == "removed"
        assert pair.p.failovers == []
        assert pair.counter("fleet_requests_rerouted", cause="remove") == \
            len(out["recovered"])
        with pytest.raises(ValueError):
            pair.p.remove_engine("e0")
        assert pair.p._registry.gauge("fleet_engines").value(
            state="removed") == 1
        pair.check()

    def test_introspect_fleet_view(self, models):
        pair = FleetPair(models, ["colocated", "colocated"])
        pair.submit(id="x", prompt=[1, 2, 3], max_new_tokens=2)
        intro = pair.p.introspect()
        assert key_tree(intro) == key_tree(pair.r.introspect())
        assert set(intro["engines"]) == {"e0", "e1"}
        e0 = intro["engines"]["e0"]
        assert e0["status"] == "active"
        assert e0["engine"]["pool"]["num_blocks"] == BLOCKS
        assert intro["placement"] == "affinity" and intro["failovers"] == []
        pair.drive()
        pair.check()
