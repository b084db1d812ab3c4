"""apex_tpu_torch's serving resilience plane against apex_tpu's.

Mirrors tests/test_serving_resilience.py class by class. Each test
drives one engine of each package (the tiny fp32 GPT of
tests/test_torch_serving.py, the port's weights carried over by
``load_jax_params``) through the same schedule, fake clock and fault
clauses, and holds the port to the reference exactly:

- every step's report (admitted, prefilled, decoded, finished,
  expired, quarantined, drained, queued, blocks in use) is equal;
- every result's tokens, outcome, reason code and error text are equal
  (greedy fp32 tokens: the two packages' logits agree to ~1e-6, far
  inside the tiny model's top-2 margins, as tests/test_torch_serving.py
  shows);
- the registries' counters are equal;
- a drain snapshot written by either package resumes in the other, and
  a swap to the same new weights gives the same tokens.
"""

import contextlib
import os
import threading

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
from apex_tpu.resilience.guard import PreemptionHandler as RefHandler
from apex_tpu.serving import kv_cache as ref_kv
from apex_tpu.serving import resilience as ref_sresil
from apex_tpu.telemetry import flight as ref_flight

from apex_tpu_torch import records, serving, telemetry
from apex_tpu_torch.models import GPTConfig, GPTModel, load_jax_params
from apex_tpu_torch.resilience import faults
from apex_tpu_torch.resilience.guard import PreemptionHandler
from apex_tpu_torch.serving import kv_cache as port_kv
from apex_tpu_torch.serving import resilience as sresil
from apex_tpu_torch.telemetry import flight

VOCAB, SEQ, HID, LAYERS, HEADS, KV = 64, 64, 32, 2, 4, 2
D = HID // HEADS
BLOCKS, BS = 24, 4


def port_config():
    return GPTConfig(vocab_size=VOCAB, max_seq_len=SEQ, hidden_size=HID,
                     num_layers=LAYERS, num_heads=HEADS, num_kv_heads=KV,
                     dtype=torch.float32, param_dtype=torch.float32)


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
    port = load_jax_params(GPTModel(port_config(), device="cpu"),
                           jax.tree_util.tree_map(np.asarray, params))
    # one reference step function for every engine: its programs
    # compile once per shape for the whole module
    step = ref_serving.make_decode_step(ref, ref_cache())
    return ref, params, port, step


def ref_cache(num_blocks=BLOCKS):
    return ref_kv.KVCache(LAYERS, KV, D, num_blocks=num_blocks,
                          block_size=BS, dtype=jnp.float32)


def port_cache(num_blocks=BLOCKS):
    return port_kv.KVCache(LAYERS, KV, D, num_blocks=num_blocks,
                           block_size=BS, dtype=torch.float32, device="cpu")


@contextlib.contextmanager
def both_inject(**kw):
    """The same fault plan installed in both packages."""
    with ref_faults.inject(**kw), faults.inject(**kw):
        yield


@pytest.fixture()
def records_dirs(tmp_path, monkeypatch):
    monkeypatch.setattr(ref_records, "RECORDS_DIR", str(tmp_path / "ref"))
    monkeypatch.setattr(records, "RECORDS_DIR", str(tmp_path / "port"))
    return tmp_path


def _norm_report(rep):
    out = dict(rep)
    if out.get("snapshot"):
        out["snapshot"] = os.path.basename(out["snapshot"])
    return out


def _outcome(r):
    return (list(r.tokens), r.finish_reason, r.reason, r.error)


class Pair:
    """One engine of each package over the same schedule: ``step``
    returns the port's report after asserting it equals the
    reference's."""

    def __init__(self, models, *, num_blocks=BLOCKS, port_model=None,
                 ref_params=None, ref_step=None, port_step=None,
                 ref_kw=None, port_kw=None, **kw):
        ref, params, port, step = models
        self.rc, self.pc = ref_cache(num_blocks), port_cache(num_blocks)
        self.rreg = ref_telemetry.MetricsRegistry()
        self.preg = telemetry.MetricsRegistry()
        self.rsink = ref_telemetry.InMemorySink()
        self.psink = telemetry.InMemorySink()
        self.rreg.add_sink(self.rsink)
        self.preg.add_sink(self.psink)
        kw.setdefault("max_batch", 4)
        kw.setdefault("max_prefill_batch", 4)
        self.r = ref_serving.ContinuousBatcher(
            ref, ref_params if ref_params is not None else params, self.rc,
            step_fn=ref_step if ref_step is not None else step,
            registry=self.rreg, **kw, **(ref_kw or {}))
        self.p = serving.ContinuousBatcher(
            port_model if port_model is not None else port, self.pc,
            step_fn=port_step, registry=self.preg, **kw, **(port_kw or {}))
        self.rs, self.ps = self.rc.init_state(), self.pc.init_state()

    def submit(self, **kw):
        """Submit the same request to both engines; returns the port's."""
        self.r.submit(ref_serving.Request(**kw))
        req = serving.Request(**kw)
        self.p.submit(req)
        return req

    def step(self):
        self.rs, rr = self.r.step(self.rs)
        self.ps, pr = self.p.step(self.ps)
        assert _norm_report(pr) == _norm_report(rr)
        return pr

    def idle(self):
        assert self.p.idle() == self.r.idle()
        return self.p.idle()

    def run(self):
        reports = []
        while not self.idle():
            reports.append(self.step())
        return reports

    def drain(self):
        rres, pres = self.r.drain(), self.p.drain()
        assert [r.id for r in pres] == [r.id for r in rres]
        for a, b in zip(pres, rres):
            assert _outcome(a) == _outcome(b), a.id
        return {r.id: r for r in pres}

    def counters(self):
        got = self.preg.snapshot()["counters"]
        assert got == self.rreg.snapshot()["counters"]
        return got


def mk_requests(n, rng, **kw):
    return [dict(id=i, prompt=rng.randint(0, VOCAB, (int(rng.randint(2, 9)),)),
                 max_new_tokens=int(rng.randint(3, 7)), **kw)
            for i in range(n)]


def run_clean(models, reqs, **kw):
    """Token streams per id of an uninterrupted, fault-free run (the
    port's, asserted equal to the reference's)."""
    pair = Pair(models, **kw)
    for r in reqs:
        pair.submit(**r)
    pair.run()
    return {i: r.tokens for i, r in pair.drain().items()}


# ---------------------------------------------------------------------------
# deadlines
# ---------------------------------------------------------------------------


class TestDeadlines:
    def test_queued_deadline_reaps_before_admission(self, models):
        t = [0.0]
        pair = Pair(models, clock=lambda: t[0])
        pair.submit(id="late", prompt=[1] * 4, max_new_tokens=4,
                    deadline_ms=50.0)
        t[0] = 0.2
        rep = pair.step()
        assert rep["expired"] == ["late"] and rep["admitted"] == []
        res = pair.drain()
        assert res["late"].finish_reason == "deadline_exceeded"
        assert res["late"].reason == "deadline_queued"
        assert pair.counters()[
            'serving_deadline_exceeded{where="queued"}'] == 1
        assert "serving_deadline_exceeded" in [
            e["event"] for e in pair.psink.events]
        assert pair.pc.blocks_in_use == 0

    def test_inflight_deadline_reaps_before_decode(self, models):
        t = [0.0]
        pair = Pair(models, clock=lambda: t[0])
        pair.submit(id="ttl", prompt=[1] * 4, max_new_tokens=8,
                    deadline_ms=100.0)
        pair.submit(id="ok", prompt=[2] * 4, max_new_tokens=8)
        rep = pair.step()
        assert rep["decoded"] == ["ttl", "ok"]
        n_before = len(pair.p.running[0].generated)
        t[0] = 0.5
        rep = pair.step()
        assert rep["expired"] == ["ttl"] and rep["decoded"] == ["ok"]
        res = pair.drain()
        assert res["ttl"].reason == "deadline_in_flight"
        assert len(res["ttl"].tokens) == n_before
        pair.run()
        assert pair.drain()["ok"].finish_reason == "length"
        assert pair.counters()[
            'serving_deadline_exceeded{where="in_flight"}'] == 1
        assert pair.pc.blocks_in_use == 0

    def test_prefilling_deadline_reaps_mid_chunks(self, models):
        t = [0.0]
        pair = Pair(models, clock=lambda: t[0], prefill_chunk=4)
        pair.submit(id="slow", prompt=[1] * 16, max_new_tokens=4,
                    deadline_ms=100.0)
        assert pair.step()["admitted"] == ["slow"]
        t[0] = 0.5
        assert pair.step()["expired"] == ["slow"]
        res = pair.drain()
        assert res["slow"].reason == "deadline_prefilling"
        assert res["slow"].tokens == []
        assert pair.counters()[
            'serving_deadline_exceeded{where="prefilling"}'] == 1
        assert pair.pc.blocks_in_use == 0

    def test_no_deadline_never_expires(self, models):
        t = [0.0]
        pair = Pair(models, clock=lambda: t[0])
        pair.submit(id=0, prompt=[3] * 4, max_new_tokens=3)
        t[0] = 1e6
        pair.run()
        assert pair.drain()[0].finish_reason == "length"


# ---------------------------------------------------------------------------
# quarantine: non-finite lanes and binary-split isolation
# ---------------------------------------------------------------------------


class _PoisonDecode:
    """A step function whose decode raises whenever its block tables
    touch a poisoned sequence's blocks (a sequence-bound fault, which
    the binary split must localize). ``ref`` picks the reference's
    decode signature (params first)."""

    def __init__(self, inner, ref):
        self.inner = inner
        self.ref = ref
        self.poison_blocks = set()
        self.decode_calls = 0

    def prefill(self, *a, **kw):
        return self.inner.prefill(*a, **kw)

    def prefill_chunk(self, *a, **kw):
        return self.inner.prefill_chunk(*a, **kw)

    def decode(self, *a, **kw):
        self.decode_calls += 1
        tables = a[4] if self.ref else a[3]
        if self.poison_blocks & set(np.asarray(tables).ravel().tolist()):
            raise faults.FaultError("poisoned sequence in batch")
        return self.inner.decode(*a, **kw)


class TestQuarantine:
    def test_nonfinite_lane_quarantined_and_scrubbed_blocks_reused(
            self, models, records_dirs):
        reqs = mk_requests(3, np.random.RandomState(11))
        nxt = dict(id="next", prompt=[5, 9, 2, 7, 1, 3], max_new_tokens=6)
        clean = run_clean(models, reqs)
        clean_next = run_clean(models, [nxt])
        pair = Pair(models)
        ref_flight.enable()
        flight.enable()
        try:
            with both_inject(decode_nonfinite_steps=frozenset({1}),
                             decode_nonfinite_lane=1):
                for r in reqs:
                    pair.submit(**r)
                assert pair.step()["decoded"] == [0, 1, 2]
                victim = pair.p.running[1]
                victim_blocks = set(pair.pc.table(victim.seq_id))
                rep = pair.step()
                assert rep["quarantined"] == [1]
                assert rep["decoded"] == [0, 2]
            # the next tenant lands on the quarantined request's blocks,
            # zeroed before reuse: it decodes finite, as on a clean pool
            pair.submit(**nxt)
            pair.step()
            tenant = next(f for f in pair.p.running if f.req.id == "next")
            assert set(pair.pc.table(tenant.seq_id)) & victim_blocks
            pair.run()
        finally:
            ref_flight.disable()
            flight.disable()
        res = pair.drain()
        assert res[1].finish_reason == "error"
        assert res[1].reason == "quarantined"
        assert "nonfinite" in res[1].error
        assert res[1].tokens == clean[1][:len(res[1].tokens)]
        assert res[0].tokens == clean[0] and res[2].tokens == clean[2]
        assert res["next"].tokens == clean_next["next"]
        counters = pair.counters()
        assert counters['serving_quarantined{reason="nonfinite"}'] == 1
        assert pair.pc.blocks_in_use == 0
        rec = records.latest_record(flight.FLIGHT_KIND)
        assert rec["payload"]["trigger"] == "serving_quarantine"
        assert rec["payload"]["extra"]["requests"] == ["1"]

    def test_binary_split_isolates_raising_sequence(self, models):
        ref, params, port, step = models
        reqs = mk_requests(4, np.random.RandomState(12))
        clean = run_clean(models, reqs)
        rc_step = _PoisonDecode(step, ref=True)
        pair = Pair(models, ref_step=rc_step)
        p_step = _PoisonDecode(serving.make_decode_step(port, pair.pc),
                               ref=False)
        pair.p.step_fn = p_step
        for r in reqs:
            pair.submit(**r)
        assert pair.step()["decoded"] == [0, 1, 2, 3]
        for eng, cache, wrapped in ((pair.r, pair.rc, rc_step),
                                    (pair.p, pair.pc, p_step)):
            victim = next(f for f in eng.running if f.req.id == 1)
            wrapped.poison_blocks = set(cache.table(victim.seq_id))
        calls = p_step.decode_calls
        rep = pair.step()
        assert rep["quarantined"] == [1]
        assert sorted(rep["decoded"]) == [0, 2, 3]
        # full batch, two halves, two singletons of the poisoned half
        assert p_step.decode_calls - calls == rc_step.decode_calls - calls
        assert p_step.decode_calls > calls + 1
        pair.run()
        res = pair.drain()
        assert res[1].reason == "quarantined"
        assert "poisoned sequence" in res[1].error
        for i in (0, 2, 3):
            assert res[i].tokens == clean[i]
        assert pair.counters()['serving_quarantined{reason="exception"}'] == 1
        assert pair.pc.blocks_in_use == 0

    def test_transient_decode_fault_absorbed_zero_quarantines(self,
                                                              models):
        reqs = mk_requests(2, np.random.RandomState(13))
        clean = run_clean(models, reqs)
        pair = Pair(models)
        with both_inject(io_errors={"decode_step": frozenset({1})}):
            for r in reqs:
                pair.submit(**r)
            pair.run()
        res = pair.drain()
        assert {r.finish_reason for r in res.values()} == {"length"}
        assert {i: r.tokens for i, r in res.items()} == clean
        assert 'serving_quarantined{reason="exception"}' not in \
            pair.counters()

    def test_step_fault_quarantines_whole_batch_and_serves_queue(
            self, models):
        reqs = mk_requests(4, np.random.RandomState(14))
        clean = run_clean(models, reqs[2:])
        pair = Pair(models, max_batch=2)
        with both_inject(decode_exception_steps=frozenset({1})):
            for r in reqs:
                pair.submit(**r)
            pair.step()
            rep = pair.step()
            assert rep["quarantined"] == [0, 1]
            pair.run()
        res = pair.drain()
        assert {res[i].reason for i in (0, 1)} == {"quarantined"}
        assert res[2].tokens == clean[2] and res[3].tokens == clean[3]
        assert pair.counters()['serving_quarantined{reason="exception"}'] == 2
        assert pair.pc.blocks_in_use == 0

    def test_chunk_fault_quarantines_chunk_batch_releasing_prefixes(
            self, models):
        shared = list(range(1, 9))
        pair = Pair(models, prefill_chunk=4)
        pair.submit(id="a", prompt=shared + [20, 21], max_new_tokens=3)
        pair.run()
        pair.drain()
        with both_inject(prefill_chunk_exception_indices=frozenset({3})):
            # both resume the published 8-token prefix by reference,
            # then chunk their private tails in one dispatch (index 3)
            pair.submit(id="b", prompt=shared + [30, 31, 32],
                        max_new_tokens=3)
            pair.submit(id="c", prompt=shared + [40, 41], max_new_tokens=3)
            rep = pair.step()
            assert rep["quarantined"] == ["b", "c"]
        pair.run()
        res = pair.drain()
        assert {res[i].reason for i in ("b", "c")} == {"quarantined"}
        assert pair.pc.blocks_in_use == 0
        # the shared prefix's references were released, not leaked
        assert pair.pc.prefix_stats() == pair.rc.prefix_stats()
        assert pair.pc.prefix_stats()["shared_blocks"] == 0
        assert pair.counters()['serving_quarantined{reason="exception"}'] == 2


# ---------------------------------------------------------------------------
# drain snapshots and resume, across the two packages
# ---------------------------------------------------------------------------


class TestDrainResume:
    def test_snapshot_resume_replays_across_packages(self, models,
                                                     tmp_path):
        reqs = mk_requests(6, np.random.RandomState(21))
        # lanes 1, 2, 4 and 5 sample: a resumed stream keys each draw on
        # (seed, token index), so it must equal the uninterrupted one
        # token for token, as the greedy lanes do
        for i, kw in ((1, dict(temperature=0.8, top_k=8, top_p=0.95)),
                      (2, dict(temperature=1.3)),
                      (4, dict(temperature=0.8, top_p=0.9)),
                      (5, dict(temperature=1.0, top_k=5))):
            reqs[i].update(kw, seed=1000 + i)
        clean = run_clean(models, reqs)
        rh, ph = RefHandler(), PreemptionHandler()
        pair = Pair(models, max_batch=3,
                    ref_kw=dict(preemption=rh,
                                snapshot_dir=str(tmp_path / "ref")),
                    port_kw=dict(preemption=ph,
                                 snapshot_dir=str(tmp_path / "port")))
        for r in reqs:
            pair.submit(**r)
        pair.step()
        pair.step()
        rh.requested = ph.requested = True
        rep = pair.step()
        assert rep["drained"] is True and rep["snapshot"]
        assert pair.pc.blocks_in_use == 0
        phase1 = pair.drain()
        pair.submit(id="late", prompt=[1], max_new_tokens=1)
        assert pair.drain()["late"].reason == "draining"

        rpath = ref_sresil.latest_snapshot(str(tmp_path / "ref"))
        ppath = sresil.latest_snapshot(str(tmp_path / "port"))
        rsnap, psnap = ref_sresil.load_snapshot(rpath), sresil.load_snapshot(
            ppath)
        assert psnap["requests"] == rsnap["requests"]
        assert {k: psnap[k] for k in ("format", "step", "reason")} == {
            k: rsnap[k] for k in ("format", "step", "reason")}
        assert set(psnap) == set(rsnap)
        assert any(e["state"] == "in_flight" and e["generated"]
                   for e in psnap["requests"])
        assert any(e["state"] == "in_flight" and e["generated"]
                   and e["temperature"] > 0 for e in psnap["requests"])
        # each package validates and resumes the other's snapshot
        assert ref_sresil.validate_snapshot(ppath) == (True, "")
        assert sresil.validate_snapshot(rpath) == (True, "")
        ref, params, port, step = models
        for snap_of_ref, load in ((True, sresil.load_snapshot),
                                  (False, ref_sresil.load_snapshot)):
            snap = load(rpath if snap_of_ref else ppath)
            if snap_of_ref:      # the reference's snapshot, the port serves
                resumed, prior = sresil.resume_requests(snap)
                c = port_cache()
                eng = serving.ContinuousBatcher(port, c, max_batch=3)
                _, results = serving.serve_loop(eng, c.init_state(),
                                                resumed)
                merged = sresil.merge_results(results, prior)
            else:
                resumed, prior = ref_sresil.resume_requests(snap)
                c = ref_cache()
                eng = ref_serving.ContinuousBatcher(ref, params, c,
                                                    step_fn=step,
                                                    max_batch=3)
                _, results = ref_serving.serve_loop(eng, c.init_state(),
                                                    resumed)
                merged = ref_sresil.merge_results(results, prior)
            got = {r.id: r.tokens for r in merged}
            got.update({i: r.tokens for i, r in phase1.items()})
            assert got == clean
        assert "serving_drain" in [e["event"] for e in pair.psink.events]
        pair.counters()

    def test_drain_without_snapshot_dir_finishes_inflight(self, models):
        rh, ph = RefHandler(), PreemptionHandler()
        pair = Pair(models, max_batch=2, ref_kw=dict(preemption=rh),
                    port_kw=dict(preemption=ph))
        for i in range(4):
            pair.submit(id=i, prompt=[1 + i] * 4, max_new_tokens=4)
        pair.step()
        rh.requested = ph.requested = True
        rep = pair.step()
        assert rep["drained"] is True and rep["snapshot"] is None
        res = pair.drain()
        assert all("preempted" in res[i].error for i in (2, 3))
        pair.run()
        res = pair.drain()
        assert res[0].finish_reason == res[1].finish_reason == "length"
        assert pair.pc.blocks_in_use == 0
        pair.counters()

    def test_drain_results_in_completion_order(self, models):
        pair = Pair(models)
        for i, n in enumerate([3, 1, 2]):
            pair.submit(id=i, prompt=[1 + i] * 4, max_new_tokens=n)
        pair.run()
        assert list(pair.drain()) == [1, 2, 0]

    def test_corrupt_snapshot_refused_by_both(self, models, tmp_path):
        ph = PreemptionHandler()
        c = port_cache()
        eng = serving.ContinuousBatcher(models[2], c, preemption=ph,
                                        snapshot_dir=str(tmp_path))
        state = c.init_state()
        eng.submit(serving.Request(id=0, prompt=[5] * 4, max_new_tokens=8))
        state, _ = eng.step(state)
        with faults.inject(snapshot_corrupt_indices=frozenset({0})):
            ph.requested = True
            state, rep = eng.step(state)
        path = rep["snapshot"]
        for mod in (sresil, ref_sresil):
            ok, reason = mod.validate_snapshot(path)
            assert not ok and "truncated" in reason
            with pytest.raises(mod.SnapshotError, match="truncated"):
                mod.load_snapshot(path)
            assert mod.latest_snapshot(str(tmp_path)) is None

    def test_latest_snapshot_falls_back_to_older_valid(self, models,
                                                       tmp_path):
        c = port_cache()
        eng = serving.ContinuousBatcher(models[2], c)
        eng.submit(serving.Request(id="q", prompt=[2] * 4,
                                   max_new_tokens=2))
        good = sresil.save_snapshot(eng, str(tmp_path), step=5)
        with faults.inject(snapshot_corrupt_indices=frozenset({1})):
            sresil.save_snapshot(eng, str(tmp_path), step=9)
        for mod in (sresil, ref_sresil):
            assert mod.latest_snapshot(str(tmp_path)) == good
            snap = mod.load_snapshot(good)
            assert snap["requests"][0]["id"] == "q"
            assert snap["requests"][0]["state"] == "queued"


# ---------------------------------------------------------------------------
# live weight swap
# ---------------------------------------------------------------------------


def _scaled(params, factor):
    return jax.tree_util.tree_map(lambda x: x * factor, params)


def _port_model(params):
    return load_jax_params(GPTModel(port_config(), device="cpu"),
                           jax.tree_util.tree_map(np.asarray, params))


class TestWeightSwap:
    def test_swap_installs_at_step_boundary_same_tokens(self, models):
        ref, params, port, step = models
        model = _port_model(params)
        pair = Pair(models, port_model=model)
        pair.submit(id=0, prompt=[7] * 5, max_new_tokens=6)
        pair.step()
        new_params = _scaled(params, 1.5)
        new_sd = _port_model(new_params).state_dict()
        rinfo = ref_serving.swap_weights(pair.r, new_params)
        info = serving.swap_weights(pair.p, new_sd)
        assert info["old_digest"] != info["new_digest"]
        assert info["step"] == rinfo["step"] == 1
        first = next(iter(new_sd))
        assert pair.p._pending_swap is not None      # staged only
        assert not torch.equal(model.state_dict()[first], new_sd[first])
        pair.step()                                  # the boundary
        assert torch.equal(model.state_dict()[first], new_sd[first])
        assert info["new_digest"] == sresil.params_digest(model)
        # a request submitted after the swap runs on the new weights
        pair.submit(id=1, prompt=[3, 1, 4, 1, 5], max_new_tokens=4)
        pair.run()
        res = pair.drain()
        assert res[0].finish_reason == "length" and len(res[0].tokens) == 6
        events = [e for e in pair.psink.events
                  if e["event"] == "serving_weight_swap"]
        assert events and events[0]["new_digest"] == info["new_digest"]
        assert pair.counters()["serving_weight_swaps"] == 1
        assert pair.pc.blocks_in_use == 0

    def test_staged_swap_ignores_later_writes_to_the_callers_tensors(
            self, models):
        """The staged weights are a copy: a caller that goes on writing
        to the tensors it passed (a trainer's live ``state_dict()``)
        changes neither what is installed nor the logged digest."""
        ref, params, port, step = models
        model = _port_model(params)
        reg = telemetry.MetricsRegistry()
        sink = telemetry.InMemorySink()
        reg.add_sink(sink)
        eng = serving.ContinuousBatcher(model, port_cache(), registry=reg)
        new_sd = _port_model(_scaled(params, 1.5)).state_dict()
        want = {k: v.clone() for k, v in new_sd.items()}
        info = serving.swap_weights(eng, new_sd)
        for t in new_sd.values():
            t.add_(1.0)                      # written after staging
        state = eng.cache.init_state()
        eng.step(state)                      # the boundary installs
        got = model.state_dict()
        for k, v in want.items():
            assert torch.equal(got[k], v), k
        assert sresil.params_digest(model) == info["new_digest"]
        events = [e for e in sink.events
                  if e["event"] == "serving_weight_swap"]
        assert [e["new_digest"] for e in events] == [info["new_digest"]]

    def test_swap_rejects_shape_mismatch_structured(self, models,
                                                    records_dirs):
        ref, params, port, step = models
        model = _port_model(params)
        c = port_cache()
        reg = telemetry.MetricsRegistry()
        eng = serving.ContinuousBatcher(model, c, registry=reg)
        bad = dict(model.state_dict())
        name = next(iter(bad))
        bad[name] = torch.zeros(tuple(bad[name].shape) + (2,))
        digest = sresil.params_digest(model)
        rec = flight.enable()
        try:
            with pytest.raises(serving.WeightSwapError) as ei:
                serving.swap_weights(eng, bad)
        finally:
            flight.disable()
        assert ei.value.mismatches[0]["path"] == name
        assert any("expected" in m for m in ei.value.mismatches)
        assert eng._pending_swap is None
        assert sresil.params_digest(model) == digest
        assert reg.counter("serving_weight_swap_rejected").value() == 1
        assert rec.dumps == 1 and rec.last_trigger == "serving_weight_swap"
        # the engine keeps serving
        state = c.init_state()
        eng.submit(serving.Request(id=0, prompt=[1, 2, 3], max_new_tokens=2))
        while not eng.idle():
            state, _ = eng.step(state)
        assert eng.drain()[0].finish_reason == "length"

    def test_weight_swap_mismatch_clause(self, models):
        model = _port_model(models[1])
        eng = serving.ContinuousBatcher(model, port_cache())
        with faults.inject(weight_swap_mismatch_indices=frozenset({0})):
            with pytest.raises(serving.WeightSwapError,
                               match="signature mismatch"):
                serving.swap_weights(eng, model.state_dict())
            serving.swap_weights(eng, model.state_dict())
        assert eng._pending_swap is not None

    def test_fingerprint_manifest_validation(self, models):
        model = _port_model(models[1])
        eng = serving.ContinuousBatcher(model, port_cache())
        fp = serving.params_fingerprint(model)
        # the per-entry checksums are the reference's per-leaf reduction
        # over the same bytes
        sd = model.state_dict()
        for i, (name, t) in enumerate(sd.items()):
            want = ref_sresil.params_fingerprint({"x": t.numpy()})[0]
            assert fp[i] == want, name
        serving.swap_weights(eng, model, expect_fingerprint=fp)
        wrong = fp.copy()
        wrong[0] ^= 1
        with pytest.raises(serving.WeightSwapError,
                           match="signature mismatch"):
            serving.swap_weights(eng, model, expect_fingerprint=wrong)


# ---------------------------------------------------------------------------
# thread-safe submission
# ---------------------------------------------------------------------------


class TestThreadSafety:
    def test_concurrent_submit_loses_nothing(self, models):
        n_threads, per = 4, 8
        want = run_clean(models, [dict(id=t, prompt=[1 + t] * 3,
                                       max_new_tokens=2)
                                  for t in range(n_threads)],
                         num_blocks=32)
        c = port_cache(32)
        eng = serving.ContinuousBatcher(models[2], c, max_batch=4)
        state = c.init_state()

        def client(t):
            for i in range(per):
                eng.submit(serving.Request(
                    id=(t, i), prompt=[1 + t] * 3, max_new_tokens=2))

        threads = [threading.Thread(target=client, args=(t,))
                   for t in range(n_threads)]
        for th in threads:
            th.start()
        results = []
        for _ in range(500):
            for th in threads:
                th.join(timeout=0.001)
            state, _ = eng.step(state)
            results.extend(eng.drain())
            if all(not th.is_alive() for th in threads) and eng.idle():
                break
        results.extend(eng.drain())
        assert {tuple(r.id) for r in results} == {
            (t, i) for t in range(n_threads) for i in range(per)}
        assert all(r.finish_reason == "length" for r in results)
        # every copy of a prompt got the reference's tokens for it
        assert all(r.tokens == want[r.id[0]] for r in results)
        assert c.blocks_in_use == 0


# ---------------------------------------------------------------------------
# grammar
# ---------------------------------------------------------------------------


class TestGrammar:
    def test_new_serving_clauses(self):
        spec = ("decode_nonfinite=2,4;decode_nonfinite_lane=1;"
                "serving_snapshot_corrupt=0;weight_swap_mismatch=3")
        inj = faults.FaultInjector.from_env(spec)
        ref = ref_faults.FaultInjector.from_env(spec)
        for s in range(6):
            assert inj.nonfinite_lane_at(s) == ref.nonfinite_lane_at(s)
            assert (inj.should_snapshot_corrupt(s)
                    == ref.should_snapshot_corrupt(s))
            assert (inj.should_weight_swap_mismatch(s)
                    == ref.should_weight_swap_mismatch(s))
        assert inj.nonfinite_lane_at(2) == 1
        assert inj.nonfinite_lane_at(3) is None

    def test_deadline_validation(self):
        with pytest.raises(ValueError, match="deadline_ms"):
            serving.Request(id=0, prompt=[1], deadline_ms=0)
        serving.Request(id=0, prompt=[1], deadline_ms=5.0)
