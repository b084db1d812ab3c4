"""The port's rank grid and process groups against the reference's mesh.

Host-only: for every (tp, pp) in {(1,1), (2,1), (1,2), (2,2)} and with
ep or cp 2, over 8 ranks, the port's ``rank_grid`` (rank -> coordinates)
equals the reference mesh built over 8 explicit devices (device i is
rank i), each axis's groups are the ranks along that axis of the
reference mesh, and the world sizes agree. Then one spawned world of 4
gloo processes builds the real groups for each (tp, pp) and checks every
rank's coordinates, sizes and ranks, and an all-reduce over each axis's
group. Exact (integers).
"""

import numpy as np
import pytest

import jax

from apex_tpu.transformer import parallel_state as ref_ps

import torch_dist_worker
from apex_tpu_torch.parallel import multiproc
from apex_tpu_torch.transformer import parallel_state as ps

CONFIGS = [(1, 1, 1, 1), (2, 1, 1, 1), (1, 2, 1, 1), (2, 2, 1, 1),
           (1, 1, 2, 1), (1, 1, 1, 2), (2, 1, 2, 2)]


@pytest.fixture
def ref_mesh():
    def build(tp, pp, ep, cp):
        return ref_ps.initialize_model_parallel(
            tp, pp, ep, cp, devices=jax.devices()[:8])
    yield build
    ref_ps.destroy_model_parallel()


@pytest.mark.parametrize("tp,pp,ep,cp", CONFIGS)
def test_rank_grid_equals_the_reference_mesh(ref_mesh, tp, pp, ep, cp):
    mesh = ref_mesh(tp, pp, ep, cp)
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    grid = ps.rank_grid(8, tp, pp, ep, cp)
    np.testing.assert_array_equal(grid, ids)
    assert ps.AXES == tuple(mesh.axis_names)
    for i, axis in enumerate(ps.AXES):
        moved = np.moveaxis(ids, i, -1).reshape(-1, ids.shape[i])
        assert ps.axis_rank_lists(grid, axis) == moved.tolist()
    sizes = {"data": ref_ps.get_data_parallel_world_size(),
             "tensor": ref_ps.get_tensor_model_parallel_world_size(),
             "pipe": ref_ps.get_pipeline_model_parallel_world_size(),
             "expert": ref_ps.get_expert_model_parallel_world_size(),
             "context": ref_ps.get_context_parallel_world_size()}
    assert {a: grid.shape[i] for i, a in enumerate(ps.AXES)} == sizes
    assert grid.size == ref_ps.get_world_size()


def test_indivisible_world_and_uninitialized_raise_as_the_reference():
    with pytest.raises(RuntimeError, match="not divisible"):
        ps.rank_grid(6, 4)
    ps.destroy_model_parallel()
    assert not ps.model_parallel_is_initialized()
    with pytest.raises(RuntimeError, match="not initialized"):
        ps.get_data_parallel_world_size()


def test_world_of_one_without_a_process_group():
    topo = ps.initialize_model_parallel()
    try:
        assert ps.model_parallel_is_initialized()
        assert topo.shape == {a: 1 for a in ps.AXES}
        assert ps.get_world_size() == 1
        assert ps.get_data_parallel_rank() == 0
        assert ps.axis_group("data") == (None, (0,))
        with pytest.raises(RuntimeError, match="not divisible"):
            ps.initialize_model_parallel(2)
        with pytest.raises(ValueError, match="unknown axis"):
            ps.axis_group("batch")
    finally:
        ps.destroy_model_parallel()


@pytest.fixture(scope="module")
def world():
    configs = [(1, 1, 1, 1), (2, 1, 1, 1), (1, 2, 1, 1), (2, 2, 1, 1)]
    return configs, multiproc.launch(torch_dist_worker.parallel_state_cases,
                                     4, (configs,), backend="gloo",
                                     threads=1, timeout=300)


@pytest.mark.parametrize("index", range(4))
def test_real_groups_over_four_ranks(world, index):
    configs, got = world
    tp, pp, ep, cp = configs[index]
    grid = ps.rank_grid(4, tp, pp, ep, cp)
    for rank in range(4):
        res = got[rank][index]
        pos = np.argwhere(grid == rank)[0]
        assert res["coords"] == {a: int(pos[i])
                                 for i, a in enumerate(ps.AXES)}
        assert res["sizes"] == dict({a: grid.shape[i]
                                     for i, a in enumerate(ps.AXES)},
                                    world=4)
        assert res["ranks"] == res["coords"]
        for axis in ps.AXES:
            total, ranks = res["group_sums"][axis]
            want = next(g for g in ps.axis_rank_lists(grid, axis)
                        if rank in g)
            assert ranks == want
            assert total == float(sum(want))
