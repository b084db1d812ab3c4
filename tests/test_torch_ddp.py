"""The port's DistributedDataParallel, Reducer and sync_deviation against
the reference's, at world 4.

The port runs in four gloo CPU processes (``multiproc.launch``, once
for the module: ``torch_dist_worker.ddp_cases``); the reference in this
process under ``shard_map`` over four of the simulated CPU devices, on
the same per-rank gradients from the seed. Mirrors
``tests/test_parallel.py``'s DDP and sync-deviation cases.

Tolerances: every sum over two ranks bitwise (the BN-style groups of
2, in fp32 and bf16: a + b rounds once in either order), and so the
fp32 reduction of bf16 gradients, which rounds back to bf16. A sum
over all four ranks is taken in another order (gloo's ring against
XLA's), so each element is within 2^-21 (fp32; at most three roundings
of 2^-24 a side) or 2^-6 (bf16 summed as bf16: gloo rounds each
addition to bf16, XLA may keep wider partial sums) of the sum of the
four |terms|, over the same final divisor. Every rank of a group holds
the same bits in the port. sync_deviation exact: 0 after the
reduction, the reference's value before it, +inf with a NaN.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from apex_tpu.parallel import DistributedDataParallel as RefDDP
from apex_tpu.parallel import Reducer as RefReducer
from apex_tpu.parallel.distributed import sync_deviation as ref_deviation

import torch_dist_worker
from apex_tpu_torch.parallel import multiproc

WORLD = 4
GROUPS = [[0, 1], [2, 3]]


def _inputs():
    rng = np.random.RandomState(0)
    grads = {"a": rng.randn(WORLD, 7, 37).astype(np.float32),
             "b": rng.randn(WORLD, 5, 3).astype(np.float32) * 1e-3}
    return {"grads": grads}


@pytest.fixture(scope="module")
def world():
    inp = _inputs()
    return inp, multiproc.launch(torch_dist_worker.ddp_cases, WORLD, (inp,),
                                 backend="gloo", threads=1, timeout=300)


def _per_rank(fn, tree):
    """``fn`` of each rank's slice of ``tree`` under shard_map over the
    data axis of WORLD devices; per-rank outputs stacked."""
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))

    def body(t):
        out = fn(jax.tree.map(lambda a: a[0], t))
        return jax.tree.map(lambda a: jnp.asarray(a)[None], out)

    return jax.tree.map(np.asarray, jax.jit(shard_map(
        body, mesh=mesh, in_specs=P("data"), out_specs=P("data"),
        check_vma=False))(tree))


def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _order_tol(terms, divisor, dtype_bound):
    """Per element: ``dtype_bound`` of the sum of the four |terms|, over
    the final divisor (a sum of four values in another order)."""
    return dtype_bound * np.abs(np.asarray(terms, np.float64)).sum(0) \
        / divisor


@pytest.mark.parametrize("case,kw,bf16,divisor", [
    ("average", {}, False, WORLD),
    ("sum", {"gradient_average": False}, False, 1),
    ("predivide", {"gradient_predivide_factor": 2.0}, False, WORLD),
    ("predivide_sum", {"gradient_predivide_factor": 2.0,
                       "gradient_average": False}, False, 1),
    ("bf16", {}, True, WORLD),
    ("bf16_fp32", {"allreduce_always_fp32": True}, True, None),
    ("groups", {"axis_index_groups": GROUPS}, False, None),
    ("bf16_groups", {"axis_index_groups": GROUPS}, True, None),
])
def test_allreduce_grads_matches_reference(world, case, kw, bf16, divisor):
    inp, got = world
    grads = inp["grads"]
    if bf16:
        grads = {k: jnp.asarray(v, jnp.bfloat16) for k, v in grads.items()}
    want = _per_rank(lambda g: jax.tree.map(
        lambda a: a.astype(jnp.float32), RefDDP(**kw).allreduce_grads(g)),
        grads)
    bound = 2.0 ** -6 if case == "bf16" else 2.0 ** -21
    for r in range(WORLD):
        for k in want:
            w, g = want[k][r], got[r][case][k]
            if divisor is None:
                np.testing.assert_array_equal(g, w)
            else:
                terms = [_bf16(t) if bf16 else t for t in inp["grads"][k]]
                assert np.all(np.abs(g.astype(np.float64) - w)
                              <= _order_tol(terms, divisor, bound)), (case, k)
            # every rank of a group holds the same bits
            first = (r // 2) * 2 if "groups" in case else 0
            np.testing.assert_array_equal(g, got[first][case][k])


def test_flat_buffer_is_one_reduction_of_the_same_values(world):
    inp, got = world
    want = _per_rank(lambda g: RefDDP().allreduce_grads(g), inp["grads"])
    keys = sorted(want)
    flat = np.concatenate([want[k][0].reshape(-1) for k in keys])
    terms = np.concatenate([inp["grads"][k].reshape(WORLD, -1)
                            for k in keys], axis=1)
    for r in range(WORLD):
        assert np.all(np.abs(got[r]["flat"].astype(np.float64) - flat)
                      <= _order_tol(terms, WORLD, 2.0 ** -21))
        np.testing.assert_array_equal(got[r]["flat"], got[0]["flat"])


@pytest.mark.parametrize("average", [True, False])
def test_reducer_matches_reference(world, average):
    inp, got = world
    want = _per_rank(lambda g: RefReducer().reduce(g, average=average),
                     inp["grads"])
    key = "reducer" if average else "reducer_sum"
    for r in range(WORLD):
        for k in want:
            assert np.all(np.abs(got[r][key][k].astype(np.float64)
                                 - want[k][r])
                          <= _order_tol(inp["grads"][k],
                                        WORLD if average else 1,
                                        2.0 ** -21))


def test_sync_deviation_zero_after_reduction_nonzero_before(world):
    inp, got = world

    def ref(g):
        before = ref_deviation(g, "data")
        after = ref_deviation(RefDDP().allreduce_grads(g), "data")
        return before, after

    before, after = _per_rank(ref, inp["grads"])
    for r in range(WORLD):
        assert got[r]["dev_before"] > 0.0
        assert got[r]["dev_before"] == got[0]["dev_before"]
        np.testing.assert_array_equal(np.float32(got[r]["dev_before"]),
                                      before[r])
        assert got[r]["dev_after"] == 0.0 == float(after[r])


def test_sync_deviation_inf_with_a_nan(world):
    _, got = world
    assert all(got[r]["dev_nan"] == np.inf for r in range(WORLD))
    ref = _per_rank(lambda x: ref_deviation(
        {"a": jnp.where((jax.lax.axis_index("data") == 1)
                        & (jnp.arange(x.size).reshape(x.shape) == 0),
                        jnp.nan, x)}, "data"),
        _inputs()["grads"]["a"])
    assert np.all(np.isinf(ref))


def test_sync_deviation_over_groups(world):
    inp, got = world
    want = _per_rank(lambda g: ref_deviation(g, "data", GROUPS),
                     inp["grads"])
    for r in range(WORLD):
        np.testing.assert_array_equal(np.float32(got[r]["dev_groups"]),
                                      want[r])


def test_check_synchronized_catches_a_bypassed_leaf(world):
    _, got = world
    for r in range(WORLD):
        assert got[r]["check_good"] == 0.0
        assert got[r]["check_bad"] > 0.0


def test_world_of_one_is_the_identity_divided_by_one():
    from apex_tpu_torch.parallel import DistributedDataParallel, sync_deviation

    g = {"a": torch.randn(4, generator=torch.Generator().manual_seed(1))}
    want = g["a"].clone()
    DistributedDataParallel(gradient_predivide_factor=2.0).allreduce_grads(g)
    torch.testing.assert_close(g["a"], want, rtol=0, atol=0)
    assert float(sync_deviation(g)) == 0.0
    g["a"][0] = float("inf")
    assert float(sync_deviation(g)) == float("inf")
