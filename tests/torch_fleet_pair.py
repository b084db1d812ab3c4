"""Shared harness of the fleet parity tests (tests/test_torch_fleet_*.py).

:class:`FleetPair` builds one ``FleetRouter`` of each package over the
same engine roles, each engine of the tiny fp32 GPT of
tests/test_torch_serving.py (the port's weights carried over by
``load_jax_params``), and drives both through the same submissions,
steps and fault clauses. Each router gets a fake clock of its own that
only its ``sleep`` advances, so a stall (``engine_stall_ms``) is
exactly its injected length in both packages and every heartbeat
decision is deterministic. Every step's reports, every merged result,
the fleet registries' counters, the structured events, the failover
records, the handoff statistics and the traces are held equal.
"""

import contextlib
import os
import re

import numpy as np
import torch

import jax
import jax.numpy as jnp
from apex_tpu import serving as ref_serving
from apex_tpu import telemetry as ref_telemetry
from apex_tpu.models.gpt import GPTConfig as RefConfig
from apex_tpu.models.gpt import GPTModel as RefModel
from apex_tpu.resilience import faults as ref_faults
from apex_tpu.serving import kv_cache as ref_kv

from apex_tpu_torch import serving, telemetry
from apex_tpu_torch.models import GPTConfig, GPTModel, load_jax_params
from apex_tpu_torch.resilience import faults
from apex_tpu_torch.serving import kv_cache as port_kv

VOCAB, SEQ, HID, LAYERS, HEADS, KV = 64, 64, 32, 2, 4, 2
D = HID // HEADS
BLOCKS, BS = 24, 4

# event fields that name a place on disk or a time, not a decision
_PATH_KEYS = ("snapshot", "path")
_ROOT = re.compile(r"manifest [0-9a-f]{12}")


def build_models():
    """(reference model, its params, the port's model, one reference
    step function shared by every reference engine)."""
    ref = RefModel(RefConfig(vocab_size=VOCAB, max_seq_len=SEQ,
                             hidden_size=HID, num_layers=LAYERS,
                             num_heads=HEADS, num_kv_heads=KV,
                             dtype=jnp.float32, param_dtype=jnp.float32,
                             softmax_impl="xla"))
    toks = jnp.asarray(np.random.RandomState(0).randint(0, VOCAB, (1, 8)),
                       jnp.int32)
    params = ref.init(jax.random.PRNGKey(0), toks)
    port = load_jax_params(
        GPTModel(GPTConfig(vocab_size=VOCAB, max_seq_len=SEQ,
                           hidden_size=HID, num_layers=LAYERS,
                           num_heads=HEADS, num_kv_heads=KV,
                           dtype=torch.float32, param_dtype=torch.float32),
                 device="cpu"),
        jax.tree_util.tree_map(np.asarray, params))
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


def mk_requests(n, rng, **kw):
    return [dict(id=i, prompt=rng.randint(0, VOCAB,
                                          (int(rng.randint(2, 9)),)),
                 max_new_tokens=int(rng.randint(3, 7)), **kw)
            for i in range(n)]


def _base(p):
    return os.path.basename(p) if isinstance(p, str) else p


def norm_event(ev):
    out = {k: v for k, v in ev.items() if k not in ("wall_time", "manifest")}
    for k in _PATH_KEYS:
        if k in out:
            out[k] = _base(out[k])
    if isinstance(out.get("error"), str):
        out["error"] = _ROOT.sub("manifest <root>", out["error"])
    return out


def norm_report(rep):
    out = dict(rep)
    if out.get("snapshot"):
        out["snapshot"] = _base(out["snapshot"])
    return out


def norm_failover(fo):
    return {k: (_base(v) if k == "snapshot" else v)
            for k, v in fo.items() if k not in ("recover_s", "t")}


def key_tree(x):
    """The nested key structure of a JSON-able dict (values dropped)."""
    if isinstance(x, dict):
        return {k: key_tree(v) for k, v in x.items()}
    if isinstance(x, list):
        return [key_tree(v) for v in x]
    return None


def trace_view(tracer):
    """Each trace segment as (request, outcome, resumed_from, span names,
    (mark, engine) pairs), sorted. ``retry_split`` marks are left out:
    a decode seat's ``install_prefilled`` joins ``running`` past
    ``max_batch`` in both packages, and the reference's decode, padded
    to ``max_batch`` lanes, raises there and splits (same tokens), where
    the port's unpadded batch runs in one dispatch."""
    out = []
    for d in tracer.trace_dicts():
        out.append((d["request_id"], d["outcome"], _base(d["resumed_from"]),
                    tuple(s["name"] for s in d["spans"]),
                    tuple((m["name"], m["args"].get("engine"))
                          for m in d["marks"]
                          if m["name"] != "retry_split")))
    return sorted(out, key=repr)


class FakeSLO:
    """A latchable stand-in for SLOMonitor: the surface the batcher and
    the router read, with ``should_shed`` under test control."""

    def __init__(self):
        self.shed = False

    def attach(self, **kw):
        pass

    def should_shed(self):
        return self.shed

    def alerting(self):
        return ["fake"] if self.shed else []

    def observe(self, *a, **kw):
        pass

    def observe_request(self, *a, **kw):
        pass

    def tick(self, **kw):
        pass

    def summary(self):
        return {"shed": self.shed}


class FleetPair:
    """One router of each package over the same roles (module
    docstring). ``r`` / ``p`` are the reference's and the port's
    routers."""

    def __init__(self, models, roles, *, engine_kw=None, slos=None,
                 snapshot_dir=None, **router_kw):
        self.models = models
        router_kw.setdefault("stall_after_s", 30.0)
        self.t = {"ref": [0.0], "port": [0.0]}
        self.rreg = ref_telemetry.MetricsRegistry()
        self.preg = telemetry.MetricsRegistry()
        self.rsink = ref_telemetry.InMemorySink()
        self.psink = telemetry.InMemorySink()
        self.rreg.add_sink(self.rsink)
        self.preg.add_sink(self.psink)
        self.rtr = ref_serving.RequestTracer()
        self.ptr = serving.RequestTracer()
        self.engine_kw = dict(engine_kw or {})
        snap = {"ref": None, "port": None}
        if snapshot_dir is not None:
            snap = {k: os.path.join(str(snapshot_dir), k) for k in snap}
        self.r = ref_serving.FleetRouter(
            registry=self.rreg, tracer=self.rtr, snapshot_dir=snap["ref"],
            clock=lambda: self.t["ref"][0],
            sleep=lambda d: self._advance("ref", d), **router_kw)
        self.p = serving.FleetRouter(
            registry=self.preg, tracer=self.ptr, snapshot_dir=snap["port"],
            clock=lambda: self.t["port"][0],
            sleep=lambda d: self._advance("port", d), **router_kw)
        for i, role in enumerate(roles):
            slo = (None, None) if slos is None else slos[i]
            self.add(f"e{i}", role=role, slo=slo)

    def _advance(self, which, d):
        self.t[which][0] += float(d)

    def engines(self, *, registries=None, slo=(None, None), **kw):
        """A (reference, port) engine pair with fresh caches."""
        ref, params, port, step = self.models
        kw = {**self.engine_kw, **kw}
        kw.setdefault("max_batch", 4)
        kw.setdefault("max_prefill_batch", 4)
        rreg, preg = registries or (self.rreg, self.preg)
        rb = ref_serving.ContinuousBatcher(
            ref, params, ref_cache(), step_fn=step, registry=rreg,
            slo=slo[0], **kw)
        pb = serving.ContinuousBatcher(port, port_cache(), registry=preg,
                                       slo=slo[1], **kw)
        return rb, pb

    def add(self, name, *, role="colocated", warm=False, slo=(None, None),
            pair=None, **kw):
        rb, pb = pair if pair is not None else self.engines(slo=slo, **kw)
        rh = self.r.add_engine(name, rb, rb.cache.init_state(), role=role,
                               warm=warm)
        ph = self.p.add_engine(name, pb, pb.cache.init_state(), role=role,
                               warm=warm)
        assert (ph.index, ph.status, ph.role) == (rh.index, rh.status,
                                                  rh.role)
        return rh, ph

    def handle(self, name):
        [rh] = [h for h in self.r.engines() if h.name == name]
        [ph] = [h for h in self.p.engines() if h.name == name]
        assert (ph.status, ph.hedged, ph.step_failures, ph.handoffs_in,
                ph.handoffs_out) == (rh.status, rh.hedged, rh.step_failures,
                                     rh.handoffs_in, rh.handoffs_out)
        return rh, ph

    def submit(self, **kw):
        a = self.r.submit(ref_serving.Request(**kw))
        b = self.p.submit(serving.Request(**kw))
        assert b == a, (kw["id"], a, b)
        return b

    def step(self):
        rr = self.r.step()
        pr = self.p.step()
        assert {k: norm_report(v) for k, v in pr.items()} == \
            {k: norm_report(v) for k, v in rr.items()}
        return pr

    def idle(self):
        assert self.p.idle() == self.r.idle()
        return self.p.idle()

    def merge(self):
        rres, pres = self.r.merge_results(), self.p.merge_results()
        assert sorted(map(str, (r.id for r in pres))) == \
            sorted(map(str, (r.id for r in rres)))
        by_id = {r.id: r for r in rres}
        for r in pres:
            want = by_id[r.id]
            assert (list(r.tokens), r.finish_reason, r.reason) == \
                (list(want.tokens), want.finish_reason, want.reason), r.id
        return pres

    def drive(self, limit=500):
        """Step both fleets to idle; the merged results (port's)."""
        out = []
        n = 0
        while not self.idle():
            self.step()
            out.extend(self.merge())
            n += 1
            assert n < limit, "fleet did not converge"
        out.extend(self.merge())
        return out

    def check(self):
        """The fleet-level records equal across the packages; returns the
        port's counters."""
        got = self.preg.snapshot()["counters"]
        want = self.rreg.snapshot()["counters"]
        assert got == want, {k: (got.get(k), want.get(k))
                             for k in set(got) | set(want)
                             if got.get(k) != want.get(k)}
        assert [norm_event(e) for e in self.psink.events] == \
            [norm_event(e) for e in self.rsink.events]
        assert [norm_failover(f) for f in self.p.failovers] == \
            [norm_failover(f) for f in self.r.failovers]
        assert self.p.handoff_stats == self.r.handoff_stats
        assert trace_view(self.ptr) == trace_view(self.rtr)
        pi, ri = self.p.introspect(), self.r.introspect()
        assert key_tree(pi) == key_tree(ri)
        assert pi["handoff"] == ri["handoff"]
        for name, e in pi["engines"].items():
            want = ri["engines"][name]
            for k in ("status", "index", "role", "step_failures", "hedged",
                      "handoffs_out", "handoffs_in", "shedding"):
                assert e[k] == want[k], (name, k)
        return got

    def counter(self, name, **labels):
        """A counter's value, equal in both registries (reading one
        registers it, so both are read)."""
        got = self.preg.counter(name).value(**labels)
        assert got == self.rreg.counter(name).value(**labels), name
        return got


def run_clean(models, reqs, **kw):
    """Token streams per id of an uninterrupted single-engine run of
    each package, asserted equal; returns the port's."""
    pair = FleetPair(models, [], **{k: v for k, v in kw.items()
                                    if k == "engine_kw"})
    rb, pb = pair.engines(registries=(ref_telemetry.MetricsRegistry(),
                                      telemetry.MetricsRegistry()))
    _, rres = ref_serving.serve_loop(
        rb, rb.cache.init_state(), [ref_serving.Request(**r) for r in reqs])
    _, pres = serving.serve_loop(
        pb, pb.cache.init_state(), [serving.Request(**r) for r in reqs])
    got = {r.id: r.tokens for r in pres}
    assert got == {r.id: r.tokens for r in rres}
    return got
