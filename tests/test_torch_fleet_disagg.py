"""apex_tpu_torch's disaggregated prefill/decode against apex_tpu's.

Mirrors tests/test_fleet_disagg.py test by test through
``torch_fleet_pair.FleetPair``: the same requests and ``kv_transfer_*``
/ ``handoff_orphan`` / ``engine_crash`` clauses through one router of
each package, held equal per request id (tokens, sampled lanes
included), in step reports, counters, events, failover records,
``handoff_stats``, traces and ``introspect()``. The manifests of the
two packages hash different fp32 bytes (the models agree to ~1e-6,
not bitwise), so their roots are compared in tests/test_torch_serving.py
over the same bytes instead; here each package's verify holds its own.
"""

import threading

import numpy as np
import pytest
import torch

from apex_tpu import records as ref_records
from apex_tpu.resilience import faults as ref_faults
from apex_tpu.telemetry import flight as ref_flight

from apex_tpu_torch import records, serving, telemetry
from apex_tpu_torch.models import GPTConfig, GPTModel
from apex_tpu_torch.resilience import faults
from apex_tpu_torch.serving import kv_cache as port_kv
from apex_tpu_torch.telemetry import flight

from torch_fleet_pair import (
    BS,
    D,
    KV,
    LAYERS,
    VOCAB,
    FleetPair,
    both_inject,
    build_models,
    mk_requests,
    run_clean,
)

SAMPLED = dict(temperature=0.8, top_k=8, top_p=0.9)


@pytest.fixture(scope="module")
def models():
    return build_models()


def mixed_requests(n, seed):
    reqs = mk_requests(n, np.random.RandomState(seed))
    for r in reqs:
        if r["id"] % 3 == 1:
            r.update(SAMPLED, seed=200 + r["id"])
    return reqs


def run_disagg(models, roles, reqs, **router_kw):
    router_kw.setdefault("retry_base_delay", 0.0)
    pair = FleetPair(models, roles, **router_kw)
    for r in reqs:
        pair.submit(**r)
    res = pair.drive()
    pair.check()
    return {r.id: r.tokens for r in res}, pair


# ---------------------------------------------------------------------------
# fault grammar
# ---------------------------------------------------------------------------


class TestHandoffGrammar:
    def test_env_grammar_parses_handoff_clauses(self):
        spec = ("kv_transfer_corrupt=0,3;kv_transfer_timeout=1;"
                "kv_transfer_partial=5;handoff_orphan=2;io:kv_handoff=4")
        got = faults.FaultInjector.from_env(spec)
        want = ref_faults.FaultInjector.from_env(spec)
        for f in ("kv_transfer_corrupt", "kv_transfer_timeout",
                  "kv_transfer_partial", "handoff_orphan", "io_errors"):
            assert getattr(got, f) == getattr(want, f), f
        assert got.io_errors["kv_handoff"] == frozenset({4})

    def test_kv_transfer_fault_sequences_per_attempt(self):
        for mod in (faults, ref_faults):
            inj = mod.FaultInjector(kv_transfer_corrupt=frozenset({0}),
                                    kv_transfer_timeout=frozenset({1}),
                                    kv_transfer_partial=frozenset({2}))
            assert [inj.kv_transfer_fault() for _ in range(4)] == \
                ["corrupt", "timeout", "partial", None]

    def test_orphan_sequences_per_handoff(self):
        for mod in (faults, ref_faults):
            inj = mod.FaultInjector(handoff_orphan=frozenset({1}))
            assert [inj.should_orphan_handoff() for _ in range(3)] == \
                [False, True, False]

    def test_role_is_validated(self, models):
        assert serving.ENGINE_ROLES == ("prefill", "decode", "colocated")
        pair = FleetPair(models, [])
        _, pb = pair.engines()
        with pytest.raises(ValueError, match="role"):
            pair.p.add_engine("bad", pb, pb.cache.init_state(),
                              role="prefetcher")


# ---------------------------------------------------------------------------
# the clean split
# ---------------------------------------------------------------------------


class TestDisaggClean:
    def test_split_matches_with_handoff_spans(self, models):
        reqs = mixed_requests(12, 7)
        clean = run_clean(models, reqs)
        got, pair = run_disagg(models, ["prefill", "decode", "decode"],
                               reqs)
        assert got == clean
        intro = pair.p.introspect()
        ho = intro["handoff"]
        assert ho["ok"] > 0 and ho["failed"] == 0 and ho["orphan"] == 0
        assert ho["bytes"] > 0 and not ho["fallback"]["latched"]
        eng = intro["engines"]
        assert (eng["e0"]["role"], eng["e1"]["role"]) == ("prefill",
                                                          "decode")
        assert eng["e0"]["handoffs_out"] == ho["ok"] == \
            eng["e1"]["handoffs_in"] + eng["e2"]["handoffs_in"]
        assert pair.counter("fleet_handoffs", outcome="ok") == ho["ok"]
        assert pair.counter("fleet_handoff_bytes") == ho["bytes"]
        spans = [s for t in pair.ptr.completed() for s in t.spans
                 if s["name"] == "handoff"]
        assert len(spans) == ho["ok"]
        assert all(s["args"]["src"] == "e0" for s in spans)
        trace = pair.ptr.export_trace()
        metas = [e for e in trace["traceEvents"] if e.get("ph") == "M"]
        assert len(metas) == len(reqs)

    def test_prefill_only_fleet_decodes_locally(self, models):
        reqs = mk_requests(6, np.random.RandomState(8))
        clean = run_clean(models, reqs)
        got, pair = run_disagg(models, ["prefill"], reqs)
        assert got == clean
        assert pair.p.introspect()["handoff"]["ok"] == 0

    def test_decode_only_fleet_admits(self, models):
        reqs = mk_requests(6, np.random.RandomState(9))
        clean = run_clean(models, reqs)
        got, _ = run_disagg(models, ["decode", "decode"], reqs)
        assert got == clean


# ---------------------------------------------------------------------------
# the failure ladder
# ---------------------------------------------------------------------------


class TestHandoffFaults:
    def test_transient_wire_faults_absorbed(self, models):
        reqs = mixed_requests(12, 7)
        clean = run_clean(models, reqs)
        with both_inject(kv_transfer_corrupt=frozenset({0, 3}),
                         kv_transfer_timeout=frozenset({1}),
                         kv_transfer_partial=frozenset({5})):
            got, pair = run_disagg(models, ["prefill", "decode"], reqs)
        assert got == clean
        ho = pair.p.introspect()["handoff"]
        assert ho["retries"] > 0 and ho["failed"] == 0
        assert pair.counter("fleet_handoff_retries") == ho["retries"]

    def test_persistent_corrupt_latches_with_bundle(self, models, tmp_path,
                                                    monkeypatch):
        monkeypatch.setattr(ref_records, "RECORDS_DIR", str(tmp_path / "r"))
        monkeypatch.setattr(records, "RECORDS_DIR", str(tmp_path / "p"))
        reqs = mk_requests(12, np.random.RandomState(7))
        clean = run_clean(models, reqs)
        ref_flight.enable()
        flight.enable()
        try:
            with both_inject(kv_transfer_corrupt=frozenset(range(10000))):
                got, pair = run_disagg(models, ["prefill", "decode"], reqs,
                                       fallback_after=2)
        finally:
            ref_flight.disable()
            flight.disable()
        assert got == clean
        ho = pair.p.introspect()["handoff"]
        assert ho["ok"] == 0 and ho["failed"] >= 2
        assert ho["fallback"]["latched"]
        assert ho["fallback"]["consecutive_failures"] >= 2
        assert pair.preg.gauge("fleet_colocated_fallback_latched").value() \
            == 1
        assert pair.counter("fleet_colocated_fallback",
                            transition="latched") == 1
        assert pair.counter("fleet_requests_rerouted",
                            cause="handoff_degraded") == ho["failed"]
        assert any(e.get("transition") == "latched"
                   and e.get("reason") == "handoff_degraded"
                   for e in pair.psink.events
                   if e["event"] == "fleet_colocated_fallback")
        got_b = records.latest_record(flight.FLIGHT_KIND)["payload"]
        want_b = ref_records.latest_record(ref_flight.FLIGHT_KIND,
                                           require_backend=None)["payload"]
        assert got_b["trigger"] == want_b["trigger"] == "kv_handoff_failed"
        g, w = got_b["extra"], want_b["extra"]
        for k in ("src", "dst", "attempts", "handoff", "request"):
            assert g[k] == w[k], k
        assert (g["src"], g["dst"], g["attempts"]) == ("e0", "e1", 3)
        assert len(g["manifest"]["root"]) == 64
        assert len(g["manifest"]["blocks"]) == len(w["manifest"]["blocks"])
        assert g["manifest"]["shape"] == w["manifest"]["shape"]
        assert g["verify"] == w["verify"]
        assert any(not v["ok"] for v in g["verify"])

    def test_clean_probe_unlatches(self, models):
        reqs = mk_requests(6, np.random.RandomState(7))
        clean = run_clean(models, reqs)
        with both_inject(kv_transfer_corrupt=frozenset(range(4))):
            got, pair = run_disagg(models, ["prefill", "decode"], reqs,
                                   fallback_after=1, handoff_retries=0)
        assert got == clean
        lat = [e.get("transition") for e in pair.psink.events
               if e["event"] == "fleet_colocated_fallback"]
        assert "latched" in lat and "unlatched" in lat
        assert not pair.p.introspect()["handoff"]["fallback"]["latched"]
        assert pair.counter("fleet_handoff_probes", outcome="ok") >= 1
        assert pair.counter("fleet_handoff_probes", outcome="failed") >= 1
        assert pair.preg.gauge("fleet_colocated_fallback_latched").value() \
            == 0

    def test_orphaned_export_scrubbed_and_replayed(self, models):
        reqs = mixed_requests(12, 7)
        clean = run_clean(models, reqs)
        with both_inject(handoff_orphan=frozenset({0})):
            got, pair = run_disagg(models, ["prefill", "decode"], reqs)
        assert got == clean
        assert pair.p.introspect()["handoff"]["orphan"] == 1
        assert pair.counter("fleet_handoffs", outcome="orphan") == 1
        assert pair.counter("fleet_requests_rerouted",
                            cause="handoff_orphan") == 1
        # the orphan's blocks were zeroed before reuse
        assert pair.counter("serving_blocks_scrubbed") > 0
        done = pair.ptr.completed()
        resumed = [t for t in done if t.resumed_from
                   and t.resumed_from.startswith("handoff_")]
        assert len(resumed) == 1
        assert [t for t in done if t.outcome == "rerouted"
                and t.trace_id == resumed[0].trace_id]

    def test_decode_crash_mid_handoff_replays(self, models):
        reqs = mixed_requests(12, 7)
        clean = run_clean(models, reqs)
        with both_inject(engine_crash_steps=frozenset({0}),
                         engine_crash_engine=1):
            got, pair = run_disagg(models, ["prefill", "decode", "decode"],
                                   reqs)
        assert got == clean
        assert pair.p.introspect()["handoff"]["dst_crash"] >= 1
        assert pair.p.failovers[0]["cause"] == "crash"
        assert pair.handle("e1")[1].status == "fenced"
        assert pair.counter("fleet_requests_rerouted",
                            cause="handoff_dst_crash") >= 1
        by_req = {}
        for ev in pair.ptr.export_trace()["traceEvents"]:
            if ev.get("ph") != "M":
                by_req.setdefault(ev["args"].get("trace_id"),
                                  set()).add(ev["tid"])
        assert by_req and all(len(t) == 1 for t in by_req.values())


# ---------------------------------------------------------------------------
# take_queued under concurrent submit
# ---------------------------------------------------------------------------


class TestTakeQueuedRace:
    def test_take_queued_races_concurrent_submit(self, models):
        pair = FleetPair(models, [])
        _, eng = pair.engines()
        n = 200
        taken = []
        stop = threading.Event()

        def hammer():
            while not stop.is_set():
                taken.extend(eng.take_queued(2))

        t = threading.Thread(target=hammer)
        t.start()
        try:
            for i in range(n):
                eng.submit(serving.Request(id=i, prompt=[1, 2],
                                           max_new_tokens=1))
        finally:
            stop.set()
            t.join()
        taken.extend(eng.take_queued())
        left = [r.id for r, _ in eng.queue]
        assert sorted([r.id for r, _ in taken] + left) == list(range(n))


# ---------------------------------------------------------------------------
# the bf16 handoff (the pool dtype the card serves in)
# ---------------------------------------------------------------------------


class TestBf16Handoff:
    def test_bf16_split_installs_the_source_bits(self, models):
        """A bf16 pool's handoff ships ``uint16`` bits under a
        ``bfloat16`` manifest and installs them bit for bit: every
        decode seat's imported blocks equal the prefill seat's export,
        and the streams equal a colocated bf16 engine's."""
        ref, params, port, _ = models
        model = GPTModel(GPTConfig(vocab_size=VOCAB, max_seq_len=64,
                                   hidden_size=32, num_layers=LAYERS,
                                   num_heads=4, num_kv_heads=KV,
                                   dtype=torch.bfloat16,
                                   param_dtype=torch.float32),
                         device="cpu")
        model.load_state_dict(port.state_dict())

        def engine(reg):
            cache = port_kv.KVCache(LAYERS, KV, D, num_blocks=24,
                                    block_size=BS, dtype=torch.bfloat16,
                                    device="cpu")
            return serving.ContinuousBatcher(model, cache, registry=reg,
                                             max_batch=4,
                                             max_prefill_batch=4)

        reqs = mk_requests(6, np.random.RandomState(3))
        solo = engine(telemetry.MetricsRegistry())
        _, res = serving.serve_loop(solo, solo.cache.init_state(),
                                    [serving.Request(**r) for r in reqs])
        clean = {r.id: r.tokens for r in res}
        reg = telemetry.MetricsRegistry()
        router = serving.FleetRouter(registry=reg, stall_after_s=30.0,
                                     retry_base_delay=0.0)
        for i, role in enumerate(["prefill", "decode"]):
            b = engine(reg)
            router.add_engine(f"e{i}", b, b.cache.init_state(), role=role)
        shipped = []
        real_install = serving.ContinuousBatcher.install_prefilled

        def install(self, state, req, generated, k, v, **kw):
            state = real_install(self, state, req, generated, k, v, **kw)
            [fl] = [f for f in self.running if f.req is req]
            _, k2, v2 = self.cache.export_blocks(state, fl.seq_id,
                                                 length=k.shape[1] * BS)
            shipped.append((k.dtype, np.array_equal(k2, k),
                            np.array_equal(v2, v)))
            return state

        manifests = []
        real_manifest = serving.FleetRouter._manifest

        def manifest(blocks, k, v, dtype=None):
            out = real_manifest(blocks, k, v, dtype=dtype)
            manifests.append(out["dtype"])
            return out

        serving.ContinuousBatcher.install_prefilled = install
        serving.FleetRouter._manifest = staticmethod(manifest)
        try:
            for r in reqs:
                router.submit(serving.Request(**r))
            out = serving.fleet_serve_loop(router, [])
        finally:
            serving.ContinuousBatcher.install_prefilled = real_install
            serving.FleetRouter._manifest = staticmethod(real_manifest)
        assert {r.id: r.tokens for r in out} == clean
        assert router.handoff_stats["ok"] == len(reqs) == len(shipped)
        assert all(s == (np.dtype(np.uint16), True, True) for s in shipped)
        assert set(manifests) == {"bfloat16"}
        assert all(h.batcher.cache.blocks_in_use == 0
                   for h in router.engines())
