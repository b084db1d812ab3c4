"""The port's ZeRO optimizers (``apex_tpu_torch.contrib.optimizers``)
against the reference's (``tests/test_distributed_optimizers.py``, test
by test), at worlds 2 and 4.

The port runs in one gloo world of 2 and one of 4 CPU processes
(``torch_zero_worker.zero_world``, one spawn a world), the data axis its
shard axis; the reference in this process under ``shard_map`` over the
first 2 or 4 of its 8 simulated CPU devices, its data axis as large.
Both get the reference file's trees and one gradient tree a rank from
its seed, the tree's keys in ``jax.tree``'s (sorted) order so that both
flat spaces, and so both shard layouts, are laid out alike. Each case
is held against the reference's sharded run and against the port's
unsharded optimizer on the ranks' mean gradient.

Tolerances, from the measured gaps:

- Adam (fp32): bitwise the port's unsharded FusedAdam at world 2,
  where the reduce-scatter adds two values (one order) and the update
  is elementwise fp32; at world 4 gloo's order of the four-way sum is
  another, so the reference's bound (rtol 2e-5, atol 2e-6). Against
  the reference's sharded run, that bound at both worlds: XLA's CPU
  compiler contracts the moments' and the update's multiply-adds
  (``tests/test_torch_adam.py``), a measured gap of 2 ulps in m and of
  at most 2.2e-7 relative in p. ZeRO-Adam is bitwise DDP + FusedAdam at
  world 2 (both sum two values, divide by 2, and run the one
  elementwise update).
- LAMB: per-leaf norms summed in another order (per-subtile partials,
  then by leaf, then over the ranks; the reference's ``segment_sum`` of
  the shard, then ``psum``), so the reference's bound, rtol 2e-5 and
  atol 2e-6.
- The bf16 gradient sync: bitwise the unsharded FusedAdam on the
  wire's own mean; the Adam bound against the reference's sharded run
  (its shards at world 2 only: at world 4 XLA's CPU sums the bf16
  values in fp32 and rounds once, gloo after each hop); within the
  reference's 0.05 of the fp32 gradient's run.
- e5m2: the gather's cast bitwise ``ml_dtypes``'s, inf, NaN and
  overflow included; the parameters within the reference's 0.3.
- Stochastic rounding: Adam's shards bitwise the reference's (the
  stream is elementwise, seeded ``count x world + shard``, and no
  contracted ulp of the fp32 value crossed a rounding threshold in
  these draws); LAMB's stage-2 cast bitwise the reference's
  ``stochastic_round_cast`` of the same fp32 values at that seed; both
  within 2^-6 of the fp32 run (the reference's bound).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from apex_tpu.contrib.optimizers import DistributedFusedAdam as RefZAdam
from apex_tpu.contrib.optimizers import DistributedFusedLAMB as RefZLAMB
from apex_tpu.multi_tensor import FlatSpace as RefSpace
from apex_tpu.multi_tensor import stochastic_round_cast as ref_sr_cast
from apex_tpu.transformer import parallel_state as ref_ps

import torch_zero_worker
from apex_tpu_torch.contrib.optimizers import (DistributedFusedAdam,
                                               DistributedFusedLAMB,
                                               ShardLayout)
from apex_tpu_torch.contrib.optimizers.distributed import e5m2_bits
from apex_tpu_torch.multi_tensor import FlatSpace
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB
from apex_tpu_torch.parallel import multiproc

WORLDS = (2, 4)
RTOL, ATOL = 2e-5, 2e-6


def make_params(rng):
    """The reference file's tree, its keys in ``jax.tree``'s order."""
    p = {"w1": rng.randn(33, 17), "b1": rng.randn(17), "w2": rng.randn(17, 5)}
    return {k: np.asarray(p[k], np.float32) for k in sorted(p)}


def make_grads(rng, params, world):
    return {k: np.asarray(rng.randn(world, *v.shape), np.float32)
            for k, v in params.items()}


def _bf16(tree):
    return {k: np.asarray(v.astype(ml_dtypes.bfloat16), np.float32)
            for k, v in tree.items()}


# name -> (optimizer, keywords, step keywords, steps, bf16 params)
CASES = {
    "adam": ("adam", dict(lr=1e-2, weight_decay=0.01), {}, 3, False),
    "adam_sum": ("adam", dict(lr=1e-3, average_grad_sync=False), {}, 3,
                 False),
    "adam_overflow": ("adam", dict(lr=1e-2), dict(skip_if_nonfinite=True),
                      1, False),
    "adam_bf16_sync": ("adam", dict(lr=1e-2, grad_sync_dtype="bfloat16"),
                       {}, 3, False),
    "lamb": ("lamb", dict(lr=1e-2, weight_decay=0.01, max_grad_norm=1.0),
             {}, 3, False),
    "nvlamb": ("lamb", dict(lr=1e-2, weight_decay=0.0, use_nvlamb=True,
                            max_grad_norm=0.0), {}, 3, False),
    "e5m2": ("lamb", dict(lr=1e-3, e5m2_allgather=True), {}, 1, False),
    "clip_before_ar": ("lamb", dict(lr=1e-2, weight_decay=0.01,
                                    max_grad_norm=0.5, clip_after_ar=False),
                       {}, 3, False),
    "adam_sr32": ("adam", dict(lr=0.01), {}, 3, True),
    "adam_sr": ("adam", dict(lr=0.01, master_dtype="bfloat16",
                             stochastic_rounding=True), {}, 3, True),
    "lamb_sr32": ("lamb", dict(lr=0.01), {}, 3, True),
    "lamb_sr": ("lamb", dict(lr=0.01, master_dtype="bfloat16",
                             stochastic_rounding=True), {}, 3, True),
    # one SR step of LAMB and the fp32 step it rounds (the same bf16
    # values, upcast): its stage-2 values
    "lamb_sr1_32": ("lamb", dict(lr=0.01), {}, 1, True),
    "lamb_sr1": ("lamb", dict(lr=0.01, master_dtype="bfloat16",
                              stochastic_rounding=True), {}, 1, True),
    "sr_streams": ("adam", dict(lr=2.0 ** -9, weight_decay=0.0,
                                master_dtype="bfloat16",
                                stochastic_rounding=True), {}, 1, True),
}


def _inputs(n):
    rng = np.random.RandomState(0)
    params = make_params(rng)
    grads = make_grads(rng, params, n)
    poisoned = {k: v.copy() for k, v in grads.items()}
    poisoned["w2"][n - 1, 0, 0] = np.inf
    sr_grads = make_grads(rng, params, n)
    cases = {}
    for name, (opt, kw, step_kw, steps, bf16) in CASES.items():
        case = {"opt": opt, "kw": kw, "step_kw": step_kw, "steps": steps,
                "params": _bf16(params) if bf16 else params,
                "grads": sr_grads if bf16 else grads}
        if kw.get("master_dtype") == "bfloat16":
            case["dtype"] = "bfloat16"
        cases[name] = case
    cases["adam_overflow"]["grads"] = poisoned
    cases["adam_bf16_sync"]["wire"] = True
    w = 2048 * 8
    cases["sr_streams"].update(params={"w": np.ones(w, np.float32)},
                               grads={"w": np.full((n, w), 2.0 ** -9,
                                                   np.float32)})
    lamb = dict(lr=1e-2, weight_decay=0.01, max_grad_norm=1.0)
    return {"cases": cases,
            "l2": {"opt": "lamb", "kw": lamb, "params": params,
                   "grads": grads},
            "resume": {"opt": "lamb", "kw": lamb, "params": params,
                       "grads": grads},
            "ddp": {"kw": dict(lr=1e-2, weight_decay=0.01), "params": params,
                    "grads": [make_grads(rng, params, n) for _ in range(2)]},
            "refusals": {"params": params, "grads": grads}}


# -- the reference ------------------------------------------------------------

REF_OPTS = {"adam": RefZAdam, "lamb": RefZLAMB}


def _ref_kw(kw):
    return {k: getattr(jnp, v) if k.endswith("dtype") else v
            for k, v in kw.items()}


def _ref_run(n, opt, params, grads, steps, **step_kw):
    """``steps`` steps of the reference's ``opt`` under ``shard_map`` over
    n devices (their data axis): the gathered parameters and each
    device's shard (master, slots, leaf map, count, found_inf and
    l2_grad_norm)."""
    mesh = ref_ps.initialize_model_parallel(devices=jax.devices()[:n])
    try:
        def body(p, g):
            g = jax.tree.map(lambda s: s[0], g)
            s = opt.init(p)
            q = p
            for _ in range(steps):
                q, s = opt.step(s, g, **step_kw)
            return (q, s.master, s.slots, s.leaf_ids, s.count[None],
                    s.found_inf[None], s.l2_grad_norm[None])

        out = jax.jit(shard_map(
            body, mesh=mesh, in_specs=(P(), P("data")),
            out_specs=(P(), P("data"), P("data"), P("data"), P("data"),
                       P("data"), P("data")),
            check_vma=False))(params, grads)
    finally:
        ref_ps.destroy_model_parallel()
    q, master, slots, ids, count, found, l2 = jax.tree.map(np.asarray, out)
    shard = master.shape[0] // n
    per = [{"master": master[r * shard:(r + 1) * shard],
            **{k: v[r * shard:(r + 1) * shard] for k, v in slots.items()},
            "leaf_ids": ids[r * shard:(r + 1) * shard],
            "count": int(count[r]), "found_inf": float(found[r]),
            "l2_grad_norm": float(l2[r])} for r in range(n)]
    return {k: np.asarray(v, np.float32) for k, v in q.items()}, per


def _ref_case(n, case):
    opt = REF_OPTS[case["opt"]](impl="xla", **_ref_kw(case["kw"]))
    dt = jnp.bfloat16 if case.get("dtype") == "bfloat16" else jnp.float32
    params = {k: jnp.asarray(v, dt) for k, v in case["params"].items()}
    return _ref_run(n, opt, params, case["grads"], case["steps"],
                    **case["step_kw"])


@pytest.fixture(scope="module", params=WORLDS, ids=["w2", "w4"])
def world(request):
    n = request.param
    inp = _inputs(n)
    # the reference's shards after two steps, for the port to resume
    case = inp["resume"]
    _, inp["resume"]["states"] = _ref_run(
        n, RefZLAMB(impl="xla", **case["kw"]),
        {k: jnp.asarray(v) for k, v in case["params"].items()},
        case["grads"], 2)
    return n, inp, multiproc.launch(torch_zero_worker.zero_world, n, (inp,),
                                    backend="gloo", threads=1, timeout=600)


@pytest.fixture(scope="module")
def reference(world):
    n, inp, _ = world
    return {name: _ref_case(n, case) for name, case in inp["cases"].items()}


def _got(world, name, r=0):
    return world[2][r]["cases"][name]


def _unsharded(cls, kw, params, grads, steps, g=None, with_state=False):
    """The port's single-device optimizer on the ranks' mean gradient
    (``g`` when given), ``steps`` steps: the parameters (and the state,
    ``with_state``)."""
    opt = cls(**kw)
    tree = {k: torch.tensor(v) for k, v in params.items()}
    state = opt.init(tree)
    if g is None:
        g = {k: torch.tensor(v).sum(0) / v.shape[0]
             for k, v in grads.items()}
    p = tree
    for _ in range(steps):
        p, state = opt.step(state, g)
    p = {k: v.numpy() for k, v in p.items()}
    return (p, state) if with_state else p


def _close(got, want, rtol=RTOL, atol=ATOL, bitwise=False):
    for k, w in want.items():
        if bitwise:
            np.testing.assert_array_equal(got[k].view(np.uint32),
                                          np.asarray(w, np.float32).view(
                                              np.uint32), err_msg=k)
        else:
            np.testing.assert_allclose(got[k], w, rtol=rtol, atol=atol,
                                       err_msg=k)


def _every_rank_same(world, name):
    n, _, got = world
    for r in range(1, n):
        _close(got[r]["cases"][name]["params"],
               got[0]["cases"][name]["params"], bitwise=True)


def _shards_against_reference(world, reference, name):
    """Each rank's shard against the reference device's: the leaf map
    and the count equal, the master, m and v within the bound."""
    n, _, got = world
    _, per = reference[name]
    for r in range(n):
        mine = got[r]["cases"][name]
        np.testing.assert_array_equal(mine["leaf_ids"], per[r]["leaf_ids"])
        assert mine["count"] == per[r]["count"]
        for k in ("master", "m", "v"):
            _close({k: mine[k]}, {k: per[r][k]})


# -- TestDistributedFusedAdam ---------------------------------------------------


def test_adam_matches_unsharded(world, reference):
    n, inp, _ = world
    case = inp["cases"]["adam"]
    got = _got(world, "adam")
    _close(got["params"], _unsharded(FusedAdam, case["kw"], case["params"],
                                     case["grads"], 3), bitwise=n == 2)
    assert got["count"] == 3
    _every_rank_same(world, "adam")
    _close(got["params"], reference["adam"][0])
    _shards_against_reference(world, reference, "adam")


def test_adam_sum_mode(world, reference):
    """average_grad_sync=False: the unsharded optimizer on the summed
    gradient."""
    n, inp, _ = world
    case = inp["cases"]["adam_sum"]
    opt = FusedAdam(lr=case["kw"]["lr"])
    tree = {k: torch.tensor(v) for k, v in case["params"].items()}
    state = opt.init(tree)
    g = {k: torch.tensor(v).sum(0) for k, v in case["grads"].items()}
    want = tree
    for _ in range(case["steps"]):
        want, state = opt.step(state, g)
    got = _got(world, "adam_sum")
    _close(got["params"], {k: v.numpy() for k, v in want.items()},
           bitwise=n == 2)
    _close(got["params"], reference["adam_sum"][0])


def test_adam_overflow_skips_all_shards(world, reference):
    n, inp, got = world
    params = inp["cases"]["adam_overflow"]["params"]
    for r in range(n):
        mine = got[r]["cases"]["adam_overflow"]
        assert mine["found_inf"] == 1.0 and mine["count"] == 0
        _close(mine["params"], params, bitwise=True)
    _, per = reference["adam_overflow"]
    assert {p["found_inf"] for p in per} == {1.0}
    assert {p["count"] for p in per} == {0}


def test_adam_grad_sync_dtype_bf16(world, reference):
    """The gradient summed in bf16 on the wire.

    Bitwise, at both worlds, the unsharded FusedAdam fed the mean the
    wire gives (a reduce-scatter of the workers' own): the gathered
    parameters, and each rank's master, m and v shards. That mean is the
    exact sum within one bf16 rounding a hop, and at world 2 the two
    rounded gradients summed and rounded once, then / 2. Against the
    reference's sharded run: the parameters at the Adam bound at both
    worlds; the shards at world 2, where both sum two values. At world 4
    the reference (XLA's CPU) sums the bf16 values in fp32 and rounds
    once, while gloo rounds after each hop, so a gradient element may be
    a bf16 ulp apart: m and v then differ by that much, the parameters
    not (Adam's step is invariant to a gradient's scale that holds from
    step to step). Within the reference's 0.05 of the fp32 gradient's
    run."""
    n, inp, got = world
    case = inp["cases"]["adam_bf16_sync"]
    kw = {"lr": case["kw"]["lr"]}
    mine = _got(world, "adam_bf16_sync")
    assert mine["count"] == 3
    _every_rank_same(world, "adam_bf16_sync")
    space = FlatSpace.create({k: torch.tensor(v)
                              for k, v in case["params"].items()})
    wire = got[0]["cases"]["adam_bf16_sync"]["wire"]
    for r in range(1, n):
        np.testing.assert_array_equal(
            got[r]["cases"]["adam_bf16_sync"]["wire"], wire)
    bf = {k: np.asarray(torch.tensor(v).to(torch.bfloat16).float())
          for k, v in case["grads"].items()}
    exact = space.pack({k: torch.tensor(v.sum(0)) for k, v in bf.items()}
                       ).numpy()
    mag = space.pack({k: torch.tensor(np.abs(v).sum(0))
                      for k, v in bf.items()}).numpy()
    assert np.all(np.abs(wire * n - exact) <= (n - 1) * 2.0 ** -8 * mag)
    if n == 2:
        two = {k: (torch.tensor(v[0]).to(torch.bfloat16)
                   + torch.tensor(v[1]).to(torch.bfloat16)).float() / 2
               for k, v in case["grads"].items()}
        np.testing.assert_array_equal(wire, space.pack(two).numpy())
    g = {k: t.clone() for k, t in space.unpack(torch.tensor(wire)).items()}
    want, state = _unsharded(FusedAdam, kw, case["params"], case["grads"], 3,
                             g=g, with_state=True)
    _close(mine["params"], want, bitwise=True)
    for r in range(n):
        lay = ShardLayout(space, n, r)
        shard = got[r]["cases"]["adam_bf16_sync"]
        for k, full in (("master", state.master), ("m", state.slots["m"]),
                        ("v", state.slots["v"])):
            padded = np.zeros(lay.padded_total, np.float32)
            padded[:space.total] = full.numpy()
            np.testing.assert_array_equal(
                shard[k].view(np.uint32),
                padded[lay.start:lay.start + lay.shard].view(np.uint32),
                err_msg=f"rank {r} {k}")
    _close(mine["params"], reference["adam_bf16_sync"][0])
    if n == 2:
        _shards_against_reference(world, reference, "adam_bf16_sync")
    _close(mine["params"], _unsharded(FusedAdam, kw, case["params"],
                                      case["grads"], 3),
           rtol=0.05, atol=0.05)


# -- TestDistributedFusedLAMB ---------------------------------------------------


def test_lamb_matches_unsharded(world, reference):
    _, inp, _ = world
    case = inp["cases"]["lamb"]
    got = _got(world, "lamb")
    _close(got["params"], _unsharded(FusedLAMB, case["kw"], case["params"],
                                     case["grads"], 3))
    assert got["count"] == 3
    _every_rank_same(world, "lamb")
    _close(got["params"], reference["lamb"][0])
    _shards_against_reference(world, reference, "lamb")


def test_nvlamb_no_decay_groups(world, reference):
    _, inp, _ = world
    case = inp["cases"]["nvlamb"]
    got = _got(world, "nvlamb")
    _close(got["params"], _unsharded(FusedLAMB, case["kw"], case["params"],
                                     case["grads"], 3))
    _close(got["params"], reference["nvlamb"][0])


def test_e5m2_allgather_roundtrip(world, reference):
    _, inp, _ = world
    params = inp["cases"]["e5m2"]["params"]
    got = _got(world, "e5m2")
    _close(got["params"], params, rtol=0.3, atol=0.3)
    # the gathered parameters are the e5m2 cast of the updated master
    want = {k: np.asarray(v, np.float32) for k, v in
            reference["e5m2"][0].items()}
    _close(got["params"], want, rtol=RTOL, atol=ATOL)
    master = np.concatenate([r["cases"]["e5m2"]["master"] for r in world[2]])
    space = FlatSpace.create({k: torch.tensor(v) for k, v in params.items()})
    cast = np.asarray(master.astype(ml_dtypes.float8_e5m2), np.float32)
    flat = np.concatenate([got["params"][k].ravel() for k in params])
    mine = np.concatenate([cast[o:o + int(np.prod(s))] for o, s in
                           zip(space.offsets, space.shapes)])
    np.testing.assert_array_equal(flat, mine)


def test_e5m2_cast_is_ml_dtypes_bitwise():
    """The gather's fp32 -> e5m2 cast against ml_dtypes: round to nearest
    even, subnormals, the largest finite, overflow to inf, inf and NaN
    of both signs."""
    rng = np.random.RandomState(3)
    x = np.concatenate([
        rng.randn(4096) * 10.0 ** rng.uniform(-8, 5, 4096),
        [0.0, -0.0, 57344.0, -57344.0, 61439.0, 61440.0, 65536.0, 1e30,
         -1e30, np.inf, -np.inf, np.nan, -np.nan, 1.5258789e-05,
         2.0 ** -17, 2.0 ** -16 * 1.5, 3.0 * 2.0 ** -17]]).astype(np.float32)
    got = e5m2_bits(torch.from_numpy(x)).numpy()
    want = x.astype(ml_dtypes.float8_e5m2).view(np.uint8)
    np.testing.assert_array_equal(got, want)


def test_clip_before_ar(world, reference):
    """clip_after_ar=False: the unsharded LAMB on the mean gradient with
    the clip norm the max over ranks of the local norms."""
    from apex_tpu_torch.multi_tensor.ops import fused_lamb_update

    n, inp, _ = world
    case = inp["cases"]["clip_before_ar"]
    got = _got(world, "clip_before_ar")
    assert got["count"] == 3
    g_all = case["grads"]
    norm = max(float(np.sqrt(sum(np.sum(np.float64(g_all[k][d]) ** 2)
                                 for k in g_all))) for d in range(n))
    params = {k: torch.tensor(v) for k, v in case["params"].items()}
    space = FlatSpace.create(params)
    master = space.pack(params, dtype=torch.float32)
    m, v = torch.zeros_like(master), torch.zeros_like(master)
    g = space.pack({k: torch.tensor(x).sum(0) / n for k, x in g_all.items()},
                   dtype=torch.float32)
    for step in range(1, 4):
        master, m, v, _ = fused_lamb_update(
            master, m, v, g, space, lr=1e-2, weight_decay=0.01,
            max_grad_norm=0.5, step=step,
            global_grad_norm=torch.tensor(norm, dtype=torch.float32))
    want = {k: t.numpy() for k, t in space.unpack(master).items()}
    _close(got["params"], want)
    _close(got["params"], reference["clip_before_ar"][0])


def test_clip_before_ar_rejects_pre_synced(world):
    n, _, got = world
    for r in range(n):
        assert "grads_pre_synced" in got[r]["refusals"]["pre_synced"]


# -- TestDistributedStochasticRounding ------------------------------------------


@pytest.mark.parametrize("opt", ["adam", "lamb"])
def test_bf16_sr_tracks_fp32(world, opt):
    got, want = _got(world, f"{opt}_sr"), _got(world, f"{opt}_sr32")
    assert got["count"] == want["count"] == 3 and got["found_inf"] == 0.0
    for k, b in want["params"].items():
        a = got["params"][k]
        assert np.max(np.abs(a - b) / (1.0 + np.abs(b))) < 2.0 ** -6


def test_adam_sr_shards_bitwise_reference(world, reference):
    _, per = reference["adam_sr"]
    _close(_got(world, "adam_sr")["params"], reference["adam_sr"][0],
           bitwise=True)
    for r, mine in enumerate(world[2]):
        mine = mine["cases"]["adam_sr"]
        np.testing.assert_array_equal(
            mine["master"], np.asarray(per[r]["master"], np.float32))


def test_lamb_sr_cast_bitwise_reference(world):
    """Each shard's SR output is the reference's ``stochastic_round_cast``
    of its fp32 stage-2 values, seeded ``count x world + shard``."""
    n, _, got = world
    for r in range(n):
        f32 = got[r]["cases"]["lamb_sr1_32"]["master"]
        want = np.asarray(ref_sr_cast(jnp.asarray(f32), 0 * n + r),
                          np.float32)
        np.testing.assert_array_equal(got[r]["cases"]["lamb_sr1"]["master"],
                                      want)


def test_sr_streams_differ_across_shards(world, reference):
    n, _, got = world
    shards = [got[r]["cases"]["sr_streams"]["master"] for r in range(n)]
    assert not all((s == shards[0]).all() for s in shards[1:])
    _, per = reference["sr_streams"]
    for r in range(n):
        np.testing.assert_array_equal(
            shards[r], np.asarray(per[r]["master"], np.float32))


def test_rejects_mixed_leaves(world):
    n, _, got = world
    for r in range(n):
        assert "float32" in got[r]["refusals"]["mixed"]


# -- the layout, the norm, resuming, DDP --------------------------------------


@pytest.mark.parametrize("n", [2, 4, 8])
def test_shard_layout_matches_reference(n):
    """padded_total, the shard's size and its per-element leaf map (a
    host view in the port) for each rank."""
    rng = np.random.RandomState(0)
    params = make_params(rng)
    grads = make_grads(rng, params, n)
    _, per = _ref_run(n, RefZAdam(lr=1e-3, impl="xla"),
                      {k: jnp.asarray(v) for k, v in params.items()}, grads,
                      0)
    space = FlatSpace.create({k: torch.tensor(v) for k, v in params.items()})
    assert space.total == RefSpace.create(params).total
    for r in range(n):
        lay = ShardLayout(space, n, r)
        assert lay.shard == per[r]["master"].shape[0]
        assert lay.padded_total == lay.shard * n
        np.testing.assert_array_equal(lay.leaf_ids(), per[r]["leaf_ids"])
        # the LAMB window: subtile-aligned, around the shard
        assert lay.win_start % 2048 == 0 and lay.window % 2048 == 0
        assert lay.win_start + lay.lead == lay.start


def test_l2_grad_norm_is_the_steps(world):
    n, inp, got = world
    case = inp["l2"]
    mean = {k: v.sum(0) / n for k, v in case["grads"].items()}
    want = np.sqrt(sum(np.sum(np.float64(v) ** 2) for v in mean.values()))
    for r in range(n):
        l2 = got[r]["l2"]
        assert l2["before"] == l2["after"]
        np.testing.assert_allclose(l2["after"], want / 2.0, rtol=1e-6)


def test_resume_from_reference_state(world):
    """Two reference steps, then the third in the port from the
    reference's shards (``load_jax_dist_state``), against the
    reference's own third step."""
    n, inp, got = world
    case = inp["resume"]
    opt = RefZLAMB(impl="xla", **case["kw"])
    params = {k: jnp.asarray(v) for k, v in case["params"].items()}
    want, _ = _ref_run(n, opt, params, case["grads"], 3)
    assert got[0]["resume"]["count"] == 3
    _close(got[0]["resume"]["params"], want)


def test_zero_adam_is_ddp_bitwise(world):
    """ZeRO-Adam's gathered master against DDP + FusedAdam after each of
    two steps: bitwise at world 2 (two-value sums, one elementwise
    kernel); within the Adam bound at world 4."""
    n, _, got = world
    for r in range(n):
        for st in got[r]["ddp"]:
            np.testing.assert_array_equal(st["zero"], st["zero_out"])
            if n == 2:
                np.testing.assert_array_equal(st["zero"], st["ddp"])
            else:
                np.testing.assert_allclose(st["zero"].view(np.float32),
                                           st["ddp"].view(np.float32),
                                           rtol=RTOL, atol=ATOL)


def test_load_jax_dist_state_refuses_another_layout():
    """A reference shard of another world or rank (its per-element leaf
    map differs) is refused; one of this layout loads in place, into the
    LAMB windows the shard views."""
    from apex_tpu_torch.models.convert import load_jax_dist_state

    params = make_params(np.random.RandomState(0))
    opt = DistributedFusedLAMB(lr=1e-3)
    state = opt.init({k: torch.tensor(v) for k, v in params.items()})
    space = state.space
    other = ShardLayout(space, 2, 1)
    shard = {"master": np.zeros(other.shard, np.float32),
             "m": np.zeros(other.shard, np.float32),
             "v": np.zeros(other.shard, np.float32), "count": 2,
             "found_inf": 0.0, "l2_grad_norm": 1.5,
             "leaf_ids": other.leaf_ids()}
    with pytest.raises(ValueError, match="leaf_ids"):
        load_jax_dist_state(state, shard)
    n = state.layout.shard
    mine = {"master": np.arange(n, dtype=np.float32),
            "m": np.full(n, 0.5, np.float32), "v": np.ones(n, np.float32),
            "count": 2, "found_inf": 0.0, "l2_grad_norm": 1.5,
            "leaf_ids": state.leaf_ids}
    state = load_jax_dist_state(state, mine)
    assert state.count == 2 and float(state.l2_grad_norm) == 1.5
    lay = state.layout
    np.testing.assert_array_equal(
        lay.shard_of(state.buffers["master"]).numpy(), mine["master"])
    np.testing.assert_array_equal(state.slots["m"].numpy(), mine["m"])
