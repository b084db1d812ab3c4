"""apex_tpu_torch's serving request plane against apex_tpu's.

Mirrors tests/test_serving_request_plane.py (its ``serving_top`` and
``telemetry_dump`` tool tests aside: the tools are not ported). Both
packages' engines run the same schedule on the same fake clock
(``test_torch_serving_resilience.Pair``), and:

- each request's tracer spans and marks (names and arguments, and with
  the fake clock their times) equal the reference's, for monolithic
  and chunked prefill, a quarantine and the perfetto export;
- a trace survives a drain snapshot and a resume, across the packages;
- the SLO monitor fires and clears its alerts at the same checks for
  the same observation stream, with the same gauges and events, and
  sheds admission at the same steps;
- ``introspect()`` equals the reference's.
"""

import json
import os

import numpy as np
import pytest

from apex_tpu import records as ref_records
from apex_tpu import telemetry as ref_telemetry
from apex_tpu.resilience.guard import PreemptionHandler as RefHandler
from apex_tpu.serving import resilience as ref_sresil
from apex_tpu.serving.tracing import RequestTracer as RefTracer
from apex_tpu.telemetry import flight as ref_flight
from apex_tpu.telemetry.slo import SLOMonitor as RefMonitor
from apex_tpu.telemetry.slo import SLOTarget as RefTarget
from apex_tpu.telemetry.slo import SlidingWindowQuantile as RefQuantile

from apex_tpu_torch import records, serving, telemetry
from apex_tpu_torch.resilience import faults
from apex_tpu_torch.resilience.guard import PreemptionHandler
from apex_tpu_torch.serving import resilience as sresil
from apex_tpu_torch.serving.tracing import RequestTracer
from apex_tpu_torch.telemetry import flight
from apex_tpu_torch.telemetry.slo import (
    SLOMonitor,
    SLOTarget,
    SlidingWindowQuantile,
)

from test_torch_serving_resilience import (  # noqa: F401 (fixture)
    Pair,
    models,
    port_cache,
)

VOCAB = 64


class FakeClock:
    """A clock that advances 1 ms a read: both engines read it in the
    same order, so two copies give the same timestamps."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.001
        return self.t


def traced_pair(models, **kw):
    rclock, pclock = FakeClock(), FakeClock()
    rt, pt = RefTracer(clock=rclock), RequestTracer(clock=pclock)
    pair = Pair(models, ref_kw=dict(tracer=rt, clock=rclock),
                port_kw=dict(tracer=pt, clock=pclock), **kw)
    return pair, rt, pt


def _norm(traces):
    # a drained trace names its snapshot, which sits in each engine's
    # own directory
    for t in traces:
        for m in t["marks"]:
            if m["args"].get("snapshot"):
                m["args"]["snapshot"] = os.path.basename(
                    m["args"]["snapshot"])
    return traces


def same_traces(pt, rt):
    got = _norm(pt.trace_dicts())
    assert got == _norm(rt.trace_dicts())
    return got


def mk_requests(n, rng, **kw):
    return [dict(id=i, prompt=rng.randint(0, VOCAB, (int(rng.randint(3, 9)),)),
                 max_new_tokens=int(rng.randint(3, 6)), **kw)
            for i in range(n)]


class TestTracer:
    def test_spans_and_marks_at_transitions(self, models):
        pair, rt, pt = traced_pair(models)
        req = pair.submit(id="r0", prompt=[1] * 5, max_new_tokens=3)
        assert req.trace_id is not None          # minted at submit()
        pair.run()
        pair.drain()
        (trace,) = same_traces(pt, rt)
        assert trace["outcome"] == "length"
        names = [s["name"] for s in trace["spans"]]
        assert names == ["queued", "prefill", "decode"]
        assert trace["spans"][-1]["args"]["tokens"] == 2
        assert [m["name"] for m in trace["marks"]] == [
            "admitted", "first_token", "finished"]

    def test_chunked_prefill_gets_per_chunk_spans(self, models):
        pair, rt, pt = traced_pair(models, prefill_chunk=4)
        pair.submit(id="long", prompt=[2] * 11, max_new_tokens=2)
        pair.run()
        (trace,) = same_traces(pt, rt)
        chunks = [s for s in trace["spans"]
                  if s["name"].startswith("prefill_chunk")]
        assert [s["name"] for s in chunks] == [
            "prefill_chunk[0]", "prefill_chunk[1]", "prefill_chunk[2]"]
        assert [s["args"]["tokens"] for s in chunks] == [4, 4, 3]

    def test_perfetto_export_one_track_per_request(self, models, tmp_path):
        pair, rt, pt = traced_pair(models)
        for r in mk_requests(5, np.random.RandomState(3)):
            pair.submit(**r)
        pair.run()
        same_traces(pt, rt)
        trace = pt.export_trace(str(tmp_path / "requests.json"))
        assert json.loads((tmp_path / "requests.json").read_text()) == trace
        assert trace == rt.export_trace()
        meta = [e for e in trace["traceEvents"] if e["ph"] == "M"]
        assert len({e["tid"] for e in meta}) == 5

    def test_completed_ring_is_bounded(self, models):
        c = port_cache(32)
        tracer = RequestTracer(keep=3)
        eng = serving.ContinuousBatcher(models[2], c, max_batch=4,
                                        tracer=tracer)
        reqs = [serving.Request(**r)
                for r in mk_requests(8, np.random.RandomState(5))]
        serving.serve_loop(eng, c.init_state(), reqs)
        assert len(tracer.completed()) == 3
        assert tracer.summary()["finished"] == 8

    def test_untraced_engine_leaves_requests_untouched(self, models):
        c = port_cache()
        eng = serving.ContinuousBatcher(models[2], c)
        req = serving.Request(id=0, prompt=[1] * 4, max_new_tokens=2)
        serving.serve_loop(eng, c.init_state(), [req])
        assert req.trace_id is None

    def test_quarantine_marks_and_outcome(self, models, monkeypatch):
        pair, rt, pt = traced_pair(models)
        monkeypatch.setenv(faults.ENV_KNOB,
                           "decode_nonfinite=1;decode_nonfinite_lane=0")
        for i in range(2):
            pair.submit(id=i, prompt=[1 + i] * 4, max_new_tokens=4)
        pair.step()
        assert pair.step()["quarantined"] == [0]
        pair.run()
        traces = {t["request_id"]: t for t in same_traces(pt, rt)}
        assert traces["0"]["outcome"] == "error"
        assert any(m["name"] == "quarantine" for m in traces["0"]["marks"])


class TestTraceContinuity:
    def test_trace_survives_snapshot_and_resume_across_packages(
            self, models, tmp_path):
        rh, ph = RefHandler(), PreemptionHandler()
        rclock, pclock = FakeClock(), FakeClock()
        rt, pt = RefTracer(clock=rclock), RequestTracer(clock=pclock)
        pair = Pair(models, max_batch=2,
                    ref_kw=dict(tracer=rt, clock=rclock, preemption=rh,
                                snapshot_dir=str(tmp_path / "ref")),
                    port_kw=dict(tracer=pt, clock=pclock, preemption=ph,
                                 snapshot_dir=str(tmp_path / "port")))
        for r in mk_requests(5, np.random.RandomState(11)):
            pair.submit(**r)
        pair.step()
        pair.step()
        rh.requested = ph.requested = True
        rep = pair.step()
        same_traces(pt, rt)
        snap = sresil.load_snapshot(rep["snapshot"])
        by_id = {e["id"]: e for e in snap["requests"]}
        drained = {t["request_id"]: t for t in pt.trace_dicts()
                   if t["outcome"] == "drained"}
        assert set(drained) == {str(i) for i in by_id}
        for rid, e in by_id.items():
            assert e["trace_id"] == drained[str(rid)]["trace_id"]
        # the port's snapshot resumes in the reference's request type
        # and the port's alike, with the same trace ids and origin
        resumed, _ = sresil.resume_requests(snap)
        ref_resumed, _ = ref_sresil.resume_requests(snap)
        origin = f"serving_{snap['step']:012d}"
        assert [(r.id, r.trace_id, r.resumed_from) for r in resumed] == [
            (r.id, r.trace_id, r.resumed_from) for r in ref_resumed]
        assert all(r.resumed_from == origin for r in resumed)
        c = port_cache()
        tracer2 = RequestTracer()
        eng2 = serving.ContinuousBatcher(models[2], c, max_batch=2,
                                         tracer=tracer2)
        serving.serve_loop(eng2, c.init_state(), resumed)
        cont = {t["request_id"]: t for t in tracer2.trace_dicts()}
        for r in resumed:
            t = cont[str(r.id)]
            assert t["trace_id"] == by_id[r.id]["trace_id"]
            assert t["resumed_from"] == origin
            assert any(m["name"] == "resumed" for m in t["marks"])
            assert t["outcome"] in ("length", "eos")
        meta = [e for e in tracer2.export_trace()["traceEvents"]
                if e["ph"] == "M"]
        assert all(origin in e["args"]["name"] for e in meta)


class TestSlidingWindowQuantile:
    def test_exact_quantiles_and_pruning(self):
        est, ref = SlidingWindowQuantile(10.0), RefQuantile(10.0)
        for i, v in enumerate([1.0, 2.0, 3.0, 4.0, 9.5, 0.25]):
            est.observe(v, t=float(i))
            ref.observe(v, t=float(i))
        for now in (4.0, 6.0, 11.5, 12.5, 100.0):
            for q in (0.0, 0.5, 0.99, 1.0):
                assert est.quantile(q, now=now) == ref.quantile(q, now=now)
            assert est.count(now=now) == ref.count(now=now)

    def test_capacity_bounds_memory(self):
        est = SlidingWindowQuantile(1e9, capacity=4)
        for i in range(100):
            est.observe(float(i), t=float(i))
        assert est.count(now=100.0) == 4
        assert est.quantile(0.0, now=100.0) == 96.0


def _slo_stream(mod_monitor, mod_target, tel):
    """One observation stream through an SLO monitor: a clean stretch,
    a violating burst, then recovery; returns each check's alerting
    list, the gauges and the event names."""
    reg = tel.MetricsRegistry()
    sink = tel.InMemorySink()
    reg.add_sink(sink)
    mon = mod_monitor([mod_target("ttft_p99", 0.1, budget=0.1),
                       mod_target("goodput", 1.0, kind="ge", budget=0.05)],
                      windows=((10.0, 2.0, 2.0),), min_samples=2,
                      check_every=2, registry=reg)
    rng = np.random.RandomState(7)
    ticks = []
    for i in range(120):
        t = i * 0.25
        bad = 40 <= i < 60
        mon.observe_request(f"r{i}", ttft_s=(5.0 if bad else 0.01),
                            tpot_s=0.01, ok=not (bad and i % 3 == 0),
                            t=t)
        mon.observe("queue_depth", float(rng.randint(0, 4)), t=t)
        out = mon.tick(now=t, step=i)
        ticks.append(None if out is None else
                     (list(out["alerting"]), mon.should_shed()))
    return ticks, reg.snapshot()["gauges"], [
        (e["event"], e.get("slo"), e.get("step")) for e in sink.events]


class TestSLOMonitor:
    def test_alerts_fire_and_clear_at_the_reference_ticks(self):
        got = _slo_stream(SLOMonitor, SLOTarget, telemetry)
        want = _slo_stream(RefMonitor, RefTarget, ref_telemetry)
        assert got == want
        ticks, _, events = got
        assert any(t and t[0] for t in ticks)            # it did fire
        assert [e for e in events if e[0] == "slo_alert"]
        assert [e for e in events if e[0] == "slo_recovered"]

    def test_min_samples_guards_single_bad_request(self):
        mon = SLOMonitor([SLOTarget("ttft_p99", 0.1, budget=0.1)],
                         windows=((10.0, 2.0, 2.0),), min_samples=2,
                         check_every=1,
                         registry=telemetry.MetricsRegistry())
        mon.observe("ttft_p99", 99.0, t=1.9)
        assert mon.check(now=2.0)["alerting"] == []
        mon.observe("nonexistent", 1.0, t=0.0)   # must not raise

    def test_should_shed_gates_admission_at_the_same_steps(self, models):
        reps = {}
        for name, mon_cls, tgt, tel in (
                ("port", SLOMonitor, SLOTarget, telemetry),
                ("ref", RefMonitor, RefTarget, ref_telemetry)):
            t = [0.0]
            reg = tel.MetricsRegistry()
            mon = mon_cls([tgt("tpot_p99", 1e-6, budget=0.1)],
                          windows=((8.0, 4.0, 2.0),), min_samples=1,
                          check_every=1, registry=reg,
                          clock=lambda: t[0])
            reps[name] = (mon, reg, t)
        pair = Pair(models,
                    ref_kw=dict(slo=reps["ref"][0], clock=lambda: reps[
                        "ref"][2][0]),
                    port_kw=dict(slo=reps["port"][0], clock=lambda: reps[
                        "port"][2][0]))
        pair.p._registry, pair.r._registry = reps["port"][1], reps["ref"][1]

        def advance(dt):
            for _, _, t in reps.values():
                t[0] += dt

        pair.submit(id=0, prompt=[1] * 4, max_new_tokens=3)
        while not pair.idle():
            advance(0.5)
            pair.step()
        assert reps["port"][0].should_shed()
        pair.submit(id=1, prompt=[2] * 4, max_new_tokens=2)
        advance(0.5)
        rep = pair.step()
        assert rep["admitted"] == [] and rep["queued"] == 1
        advance(30.0)
        pair.step()
        assert not reps["port"][0].should_shed()
        assert pair.step()["admitted"] == [1]
        assert (reps["port"][1].snapshot()["counters"]
                == reps["ref"][1].snapshot()["counters"])

    def test_violation_bundle_embeds_traces_and_introspect(
            self, models, tmp_path, monkeypatch):
        monkeypatch.setattr(ref_records, "RECORDS_DIR",
                            str(tmp_path / "ref"))
        monkeypatch.setattr(records, "RECORDS_DIR", str(tmp_path / "port"))
        bundles = {}
        for name, fl, mon_cls, tgt, tel, tracer_cls in (
                ("port", flight, SLOMonitor, SLOTarget, telemetry,
                 RequestTracer),
                ("ref", ref_flight, RefMonitor, RefTarget, ref_telemetry,
                 RefTracer)):
            reg = tel.MetricsRegistry()
            mon = mon_cls([tgt("tpot_p99", 1e-9)],
                          windows=((5.0, 0.5, 1.0),), min_samples=1,
                          check_every=1, registry=reg)
            bundles[name] = (fl, mon, reg, tracer_cls())
        pair = Pair(models,
                    ref_kw=dict(slo=bundles["ref"][1],
                                tracer=bundles["ref"][3]),
                    port_kw=dict(slo=bundles["port"][1],
                                 tracer=bundles["port"][3]))
        recs = {n: b[0].enable(keep=3) for n, b in bundles.items()}
        try:
            for r in mk_requests(3, np.random.RandomState(9)):
                pair.submit(**r)
            pair.run()
        finally:
            for b in bundles.values():
                b[0].disable()
        got = {}
        for name, rec in recs.items():
            assert rec.dumps == 1 and rec.last_trigger == "slo_violation"
            with open(rec.last_dump) as f:
                got[name] = json.load(f)["payload"]["extra"]
        extra = got["port"]
        assert extra["slo"] == "tpot_p99"
        assert extra["requests"] == got["ref"]["requests"]
        traces = {t["request_id"]: t for t in extra["traces"]}
        for rid in extra["requests"]:
            assert traces[str(rid)]["outcome"] is not None
            assert any(s["name"] == "decode"
                       for s in traces[str(rid)]["spans"])
        assert extra["introspect"]["slo"]["alerting"] == ["tpot_p99"]
        assert set(extra["introspect"]) == set(got["ref"]["introspect"])


class TestChunkTokensHistogram:
    def test_chunk_tokens_land_in_finite_buckets(self, models):
        pair = Pair(models, prefill_chunk=4)
        pair.submit(id=0, prompt=[3] * 14, max_new_tokens=2)
        pair.run()
        h = pair.preg.histogram("serving_prefill_chunk_tokens").series()[
            "serving_prefill_chunk_tokens"]
        want = pair.rreg.histogram("serving_prefill_chunk_tokens").series()[
            "serving_prefill_chunk_tokens"]
        assert h == want
        assert h["count"] == 4
        top = max((le for le in h["buckets"] if le != "+Inf"), key=float)
        assert h["buckets"][top] == h["count"] and float(top) >= 4096


class TestIntrospection:
    def test_introspect_equals_the_reference(self, models):
        pair, rt, pt = traced_pair(models, max_batch=2,
                                   max_prefill_batch=1, prefill_chunk=4)
        pair.submit(id="short", prompt=[1] * 4, max_new_tokens=8,
                    deadline_ms=60000.0)
        pair.submit(id="long", prompt=[2] * 12, max_new_tokens=4)
        pair.submit(id="waiting", prompt=[3] * 4, max_new_tokens=2)
        pair.step()
        pair.step()
        intro = pair.p.introspect()
        json.dumps(intro)
        assert intro == pair.r.introspect()
        by_id = {r["id"]: r for r in intro["requests"]}
        assert by_id["short"]["state"] == "decoding"
        assert by_id["long"]["state"] == "prefilling"
        assert 0 < by_id["long"]["prefilled"] < 12
        assert by_id["waiting"]["state"] == "queued"
        assert by_id["short"]["deadline_left_ms"] is not None
        assert intro["traces"]["live"] == 3
        assert intro["pool"]["blocks_in_use"] > 0
