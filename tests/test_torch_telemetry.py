"""apex_tpu_torch.telemetry against apex_tpu.telemetry.

- The metrics registry: the same sequence of calls (labeled counters,
  gauges, histograms on the default and the token-count grids, info
  blobs, events) gives the reference's ``snapshot()`` exactly and the
  same sink records; a conflicting bucket grid is refused by both.
- The step timeline: the same spans on the same fake clock export the
  same perfetto JSON and the same summary; ``sync_on`` of a CPU tensor
  is a no-op.
- The flight recorder: a ``serving_quarantine`` bundle from each
  package's engine, under the same fault clause, has the reference's
  keys at the top level and in its ``telemetry`` block; the planes the
  port lacks carry the reference's disabled markers, each with a
  reason.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from apex_tpu import records as ref_records
from apex_tpu import serving as ref_serving
from apex_tpu import telemetry as ref_telemetry
from apex_tpu.models.gpt import GPTConfig as RefConfig
from apex_tpu.models.gpt import GPTModel as RefModel
from apex_tpu.resilience import faults as ref_faults
from apex_tpu.serving import kv_cache as ref_kv
from apex_tpu.telemetry import flight as ref_flight
from apex_tpu.telemetry import timeline as ref_timeline

from apex_tpu_torch import records, serving, telemetry
from apex_tpu_torch.models import GPTConfig, GPTModel, load_jax_params
from apex_tpu_torch.resilience import faults
from apex_tpu_torch.serving import kv_cache as port_kv
from apex_tpu_torch.telemetry import flight
from apex_tpu_torch.telemetry import timeline

VOCAB, SEQ, HID, LAYERS, HEADS, KV = 64, 64, 32, 2, 4, 2


def _script(tel):
    """One sequence of registry calls; returns the registry and its
    in-memory sink."""
    reg = tel.MetricsRegistry()
    sink = tel.InMemorySink()
    reg.add_sink(sink)
    reg.counter("serving_requests", "finished").inc(outcome="length")
    reg.counter("serving_requests").inc(3, outcome="error")
    reg.counter("serving_tokens").inc(17)
    reg.gauge("serving_queue_depth").set(4)
    reg.gauge("serving_queue_depth").dec()
    bound = reg.gauge("slo_burn_rate").bind(slo="ttft_p99", window="5s")
    bound.set(2.5)
    h = reg.histogram("serving_ttft_seconds")
    for v in (0.0004, 0.003, 0.2, 7.0, 45.0):
        h.observe(v)
    t = reg.histogram("serving_prefill_chunk_tokens",
                      buckets=tel.TOKEN_COUNT_BUCKETS)
    for v in (1, 3, 256, 256, 700, 9000):
        t.observe(v)
    reg.histogram("lat", buckets=(0.1, 1.0)).observe(0.5, op="x")
    reg.set_info("slo_window", {"targets": {}, "alerting": []})
    reg.event("serving_quarantine", step=3, requests=["1"])
    reg.event("serving_drain", step=5, snapshot=None)
    return reg, sink


def test_registry_snapshot_equals_the_reference():
    reg, sink = _script(telemetry)
    rreg, rsink = _script(ref_telemetry)
    assert reg.snapshot() == rreg.snapshot()
    strip = [{k: v for k, v in e.items() if k != "wall_time"}
             for e in sink.events]
    assert strip == [{k: v for k, v in e.items() if k != "wall_time"}
                     for e in rsink.events]
    assert telemetry.TOKEN_COUNT_BUCKETS == ref_telemetry.TOKEN_COUNT_BUCKETS


def test_conflicting_bucket_grid_refused_by_both():
    for tel in (telemetry, ref_telemetry):
        reg = tel.MetricsRegistry()
        reg.histogram("toks", buckets=(8, 64, 512))
        assert reg.histogram("toks").buckets == (8.0, 64.0, 512.0)
        with pytest.raises(ValueError, match="mis-bucket"):
            reg.histogram("toks", buckets=(0.1, 1.0))
        with pytest.raises(TypeError, match="already registered"):
            reg.counter("toks")


def test_jsonl_and_stdout_sinks_write_the_reference_records(tmp_path,
                                                            capsys):
    lines = {}
    for name, tel in (("port", telemetry), ("ref", ref_telemetry)):
        sink = tel.JsonlSink(directory=str(tmp_path / name), fsync=False)
        reg = tel.MetricsRegistry()
        reg.add_sink(sink)
        reg.add_sink(tel.StdoutSink())
        reg.counter("c").inc(2, k="v")
        reg.event("e", x=1)
        reg.flush()
        sink.close()
        with open(sink.path) as f:
            recs = [json.loads(line) for line in f]
        for r in recs:
            r.pop("wall_time", None)
        out = capsys.readouterr().out.splitlines()
        lines[name] = (recs, [json.loads(o.split(" ", 1)[1]) for o in out])
        for r in lines[name][1]:
            r.pop("wall_time", None)
    assert lines["port"] == lines["ref"]


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        self.t += 0.00125
        return self.t


def _timeline_script(mod):
    tl = mod.StepTimeline(capacity=8, clock=_Clock())
    for _ in range(3):
        with tl.step_scope():
            with tl.phase("prefill", category="serving"):
                pass
            with tl.phase("decode", category="serving"):
                pass
            tl.record_span("collective", 100.5, 0.002, args={"bytes": 64})
    tl.record_span("outside", 101.0, 0.001, step=-1)
    return tl


def test_timeline_exports_the_reference_perfetto_trace(tmp_path):
    tl, rtl = _timeline_script(timeline), _timeline_script(ref_timeline)
    assert tl.export_trace() == rtl.export_trace()
    assert tl.export_trace(last_steps=1) == rtl.export_trace(last_steps=1)
    assert tl.summary() == rtl.summary()
    path = tmp_path / "trace.json"
    tl.export_trace(str(path))
    assert json.loads(path.read_text()) == rtl.export_trace()


def test_timeline_sync_on_cpu_tensor_and_global_switches():
    tl = timeline.StepTimeline(clock=_Clock())
    with tl.phase("decode", sync_on=torch.ones(3)):
        pass
    assert [s.name for s in tl.spans()] == ["decode"]
    seen = []
    timeline.set_span_observer(seen.append)
    try:
        timeline.enable()
        timeline.record_global_span("x", 1.0, 0.5)
        assert timeline.get_timeline().spans()[0].name == "x"
        timeline.disable()
        timeline.record_global_span("y", 1.0, 0.5)
        assert not timeline.get_timeline().spans()
    finally:
        timeline.set_span_observer(None)
        timeline.disable()
    assert [s.name for s in seen] == ["x"]


# -- the flight recorder's serving_quarantine bundle --------------------------


@pytest.fixture(scope="module")
def models():
    ref = RefModel(RefConfig(vocab_size=VOCAB, max_seq_len=SEQ,
                             hidden_size=HID, num_layers=LAYERS,
                             num_heads=HEADS, num_kv_heads=KV,
                             dtype=jnp.float32, param_dtype=jnp.float32,
                             softmax_impl="xla"))
    toks = jnp.asarray(np.random.RandomState(0).randint(0, VOCAB, (1, 8)),
                       jnp.int32)
    params = ref.init(jax.random.PRNGKey(0), toks)
    cfg = GPTConfig(vocab_size=VOCAB, max_seq_len=SEQ, hidden_size=HID,
                    num_layers=LAYERS, num_heads=HEADS, num_kv_heads=KV,
                    dtype=torch.float32, param_dtype=torch.float32)
    port = load_jax_params(GPTModel(cfg, device="cpu"),
                           jax.tree_util.tree_map(np.asarray, params))
    return ref, params, port


def _quarantine_bundle(eng, cache, req_cls, rec_mod, fl):
    state = cache.init_state()
    rec = fl.enable(keep=3)
    try:
        for i in range(2):
            eng.submit(req_cls(id=i, prompt=[1 + i] * 4, max_new_tokens=4))
        while not eng.idle():
            state, _ = eng.step(state)
    finally:
        fl.disable()
    assert rec.last_trigger == "serving_quarantine"
    with open(rec.last_dump) as f:
        return json.load(f)


def test_quarantine_bundle_has_the_reference_keys(models, tmp_path,
                                                  monkeypatch):
    ref, params, port = models
    monkeypatch.setattr(ref_records, "RECORDS_DIR", str(tmp_path / "ref"))
    monkeypatch.setattr(records, "RECORDS_DIR", str(tmp_path / "port"))
    monkeypatch.setenv(faults.ENV_KNOB,
                       "decode_nonfinite=1;decode_nonfinite_lane=0")
    rc = ref_kv.KVCache(LAYERS, KV, HID // HEADS, num_blocks=32,
                        block_size=4, dtype=jnp.float32)
    pc = port_kv.KVCache(LAYERS, KV, HID // HEADS, num_blocks=32,
                         block_size=4, dtype=torch.float32, device="cpu")
    rrec = _quarantine_bundle(
        ref_serving.ContinuousBatcher(ref, params, rc), rc,
        ref_serving.Request, ref_records, ref_flight)
    prec = _quarantine_bundle(serving.ContinuousBatcher(port, pc), pc,
                              serving.Request, records, flight)
    assert ref_faults.ENV_KNOB == faults.ENV_KNOB
    # the reference's records also carry ``captured``, its mark for
    # hand-transcribed evidence; the port writes no such records
    assert set(prec) == set(rrec) - {"captured"}
    assert prec["kind"] == rrec["kind"] == flight.FLIGHT_KIND
    got, want = prec["payload"], rrec["payload"]
    assert set(got) == set(want)
    # each plane is a value or a null with its ``<plane>_reason``; which
    # of the two the reference shows depends on what other code in this
    # process published into its global registry, so compare the planes
    planes = {k for k in got["telemetry"] if not k.endswith("_reason")}
    assert planes == {k for k in want["telemetry"]
                      if not k.endswith("_reason")}
    assert got["extra"]["requests"] == want["extra"]["requests"] == ["0"]
    assert got["extra"]["reasons"] == want["extra"]["reasons"]
    assert got["faults"] == want["faults"]
    # host-local trigger: no fleet view, the reference's own reason
    assert got["fleet"] is None
    assert got["fleet_unavailable"] == want["fleet_unavailable"]
    # the planes the port lacks: disabled markers, each with a reason
    assert got["comms"]["enabled"] is False and got["comms"]["reason"]
    assert got["goodput"]["enabled"] is False
    assert got["goodput"]["goodput_reason"]
    assert got["compile_plane"]["tracker"] is None
    assert got["compile_plane"]["reason"]
    assert got["last_checkpoint"] is None
    for key in ("devmem", "sharding", "layout_plan", "goodput"):
        assert got["telemetry"][key] is None
        assert got["telemetry"][f"{key}_reason"]
    assert set(got["devmem"]["last"]) >= {"bytes_in_use", "devmem_reason"}
    assert got["devmem"]["last"]["devmem_reason"]         # no CUDA here
    events = [e["event"] for e in got["recent_events"]]
    assert events == [e["event"] for e in want["recent_events"]]
    assert "serving_quarantine" in events
