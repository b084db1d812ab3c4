"""apex_tpu_torch.resilience.faults against apex_tpu.resilience.faults.

One ``APEX_TPU_FAULTS`` clause string must mean the same thing in both
packages. For every clause of the reference's grammar (the list below is
checked against the reference's parser, so a clause added there fails
here until it is listed):

- the parsed plan has the same fields;
- each serving helper decides the same at engine steps 0-31, on the
  injector and through the module-level helpers with the plan
  installed and read from the environment;
- a call-indexed ``io:`` / ``io_permanent:`` site raises at the same
  call indices;
- ``sigterm`` delivers a real SIGTERM at the same steps, which the
  port's ``PreemptionHandler`` catches.
"""

import dataclasses
import re
import signal
from pathlib import Path

import pytest

from apex_tpu.resilience import faults as ref_faults

from apex_tpu_torch.resilience import faults
from apex_tpu_torch.resilience.guard import PreemptionHandler

STEPS = range(32)

# one clause per key of the reference's grammar, with indices inside
# 0-31 so the step sweep sees them fire
CLAUSES = [
    "nan_grads=3,4", "nan_leaf=2", "truncate=12", "crash=7",
    "bit_flip=5", "bit_flip_replica=1", "bit_flip_leaf=3",
    "crash_before_commit=6", "sigterm=9,17", "shard_truncate=4",
    "shard_truncate_host=2", "world_mismatch=8",
    "range_fetch_timeout=0,2", "collective_slow=12.5",
    "collective_slow_at=3", "collective_payload_corrupt=1",
    "serving_pool_exhausted=2,3", "decode_step_exception=5,30",
    "prefill_chunk_exception=0,11", "decode_nonfinite=7,9",
    "decode_nonfinite_lane=2", "serving_snapshot_corrupt=1",
    "weight_swap_mismatch=0,2", "engine_crash=3", "engine_crash_engine=1",
    "engine_stall_ms=40", "engine_stall_engine=1", "engine_stall_at=2",
    "router_snapshot_missing=0", "kv_transfer_corrupt=1",
    "kv_transfer_timeout=2", "kv_transfer_partial=3", "handoff_orphan=0",
    "moe_router_collapse=4", "moe_expert_dead=3", "data_stall_ms=50",
    "ckpt_stall_ms=60", "io:decode_step=1,3",
    "io_permanent:record_write=5",
]
COMBINED = ("decode_nonfinite=2,4;decode_nonfinite_lane=1;"
            "serving_pool_exhausted=6;io:prefill_chunk=0;"
            "decode_step_exception=8;weight_swap_mismatch=3")


def _grammar_keys():
    src = (Path(ref_faults.__file__).read_text())
    keys = set(re.findall(r'key == "([a-z_]+)"', src))
    keys |= {k + ":" for k in re.findall(
        r'key\.startswith\("([a-z_]+):"\)', src)}
    return keys


def test_clause_list_covers_the_reference_grammar():
    listed = set()
    for c in CLAUSES:
        key = c.partition("=")[0]
        listed.add(key.split(":")[0] + ":" if ":" in key else key)
    assert listed == _grammar_keys()


def _fields(inj):
    return dataclasses.asdict(inj)


def _site_raises(mod, site, n=32):
    out = []
    for _ in range(n):
        try:
            mod.check(site)
            out.append(False)
        except mod.FaultError:
            out.append(True)
    return out


def _decisions(mod):
    """Every serving helper's decision at steps 0-31 through ``mod``'s
    module-level helpers (the installed or environment plan)."""
    out = []
    for s in STEPS:
        row = [mod.should_pool_exhaust(s), mod.nonfinite_lane_at(s),
               mod.should_snapshot_corrupt(s),
               mod.should_weight_swap_mismatch(s)]
        for fn in (mod.maybe_decode_exception,
                   mod.maybe_prefill_chunk_exception):
            try:
                fn(s)
                row.append(None)
            except mod.FaultError as e:
                row.append(str(e))
        out.append(row)
    return out


@pytest.mark.parametrize("spec", CLAUSES + [COMBINED])
def test_clause_parses_and_decides_as_the_reference(spec, monkeypatch):
    inj = faults.FaultInjector.from_env(spec)
    ref = ref_faults.FaultInjector.from_env(spec)
    assert _fields(inj) == _fields(ref)
    for s in STEPS:
        assert inj.nonfinite_lane_at(s) == ref.nonfinite_lane_at(s)
        assert inj.should_pool_exhaust(s) == ref.should_pool_exhaust(s)
        assert (inj.should_snapshot_corrupt(s)
                == ref.should_snapshot_corrupt(s))
        assert (inj.should_weight_swap_mismatch(s)
                == ref.should_weight_swap_mismatch(s))
        assert (s in inj.sigterm_steps) == (s in ref.sigterm_steps)
    # module-level helpers, the plan installed
    faults.install(inj)
    ref_faults.install(ref)
    try:
        assert _decisions(faults) == _decisions(ref_faults)
    finally:
        faults.install(None)
        ref_faults.install(None)
    # the same from the environment knob, with call-indexed sites
    monkeypatch.setenv(faults.ENV_KNOB, spec)
    assert faults.ENV_KNOB == ref_faults.ENV_KNOB
    assert _fields(faults.active()) == _fields(ref_faults.active())
    assert _decisions(faults) == _decisions(ref_faults)
    for site in ("decode_step", "prefill_chunk", "record_write"):
        assert _site_raises(faults, site) == _site_raises(ref_faults, site)


def test_unknown_clause_refused_by_both():
    for mod in (faults, ref_faults):
        with pytest.raises(ValueError, match="unknown"):
            mod.FaultInjector.from_env("no_such_clause=1")


def test_sigterm_clause_delivers_a_real_signal():
    handler = PreemptionHandler(signals=(signal.SIGTERM,)).install()
    fired = []
    try:
        with faults.inject(sigterm_steps=frozenset({9, 17})):
            for s in STEPS:
                faults.maybe_sigterm(s)
                if handler.requested:
                    fired.append(s)
                    handler.requested = False
    finally:
        handler.uninstall()
    assert fired == [9, 17]
    assert handler.signum == signal.SIGTERM
