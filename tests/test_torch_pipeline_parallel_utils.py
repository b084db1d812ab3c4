"""The port's pipeline-parallel toolbox
(``apex_tpu_torch/transformer/pipeline_parallel``) against the
reference's: the microbatch calculators, microbatch slicing and the
left-to-right masks (``tests/test_mesh_pipeline.py`` ``TestMicrobatches``,
``TestLtorMasks``) on the same inputs, the Timers, and the two
collectives: the loss average over the data group and the parameter
norm over the tensor group, the port's in a gloo world of 2
(``torch_pp_worker.utils_world``), the reference's under ``shard_map``
over 2 of its simulated CPU devices.

Tolerances: calculators, slices, masks and positions exact; the
average and the norm within rtol 1e-6 (fp32 sums of the same terms; a
two-rank sum is the same either way round).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from apex_tpu.transformer import pipeline_parallel as ref_pp

import torch_pp_worker
from apex_tpu_torch.parallel import multiproc
from apex_tpu_torch.telemetry import timeline
from apex_tpu_torch.transformer import pipeline_parallel as pp

WORLD = 2


def test_all_matches_reference():
    assert sorted(pp.__all__) == sorted(
        n for n in dir(ref_pp) if not n.startswith("_")
        and n not in ("microbatches", "utils"))


def test_constant():
    c = pp.ConstantNumMicroBatches(64, 4, 2)
    assert c.get() == 8
    assert c.get_current_global_batch_size() == 64


def test_constant_indivisible_raises():
    with pytest.raises(ValueError) as mine:
        pp.ConstantNumMicroBatches(65, 4, 2)
    with pytest.raises(ValueError) as theirs:
        ref_pp.ConstantNumMicroBatches(65, 4, 2)
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("consumed", [0, 200, 333, 334, 500, 700, 999, 1000,
                                      2000])
def test_rampup_matches_reference(consumed):
    kw = dict(start_batch_size=16, batch_size_increment=16,
              ramup_samples=1000, global_batch_size=64, micro_batch_size=4,
              data_parallel_size=2)
    mine, ref = (pp.RampupBatchsizeNumMicroBatches(**kw),
                 ref_pp.RampupBatchsizeNumMicroBatches(**kw))
    mine.update(consumed, False)
    ref.update(consumed, False)
    assert (mine.get(), mine.get_current_global_batch_size()) == \
        (ref.get(), ref.get_current_global_batch_size())


def test_rampup_steps():
    r = pp.RampupBatchsizeNumMicroBatches(
        start_batch_size=16, batch_size_increment=16, ramup_samples=1000,
        global_batch_size=64, micro_batch_size=4, data_parallel_size=2)
    assert r.get_current_global_batch_size() == 16
    r.update(500, False)
    assert r.get_current_global_batch_size() == 32
    r.update(2000, False)
    assert r.get_current_global_batch_size() == 64
    assert r.get() == 8


@pytest.mark.parametrize("rampup", [None, [8, 8, 100], [8, 8]])
def test_build_calculator_and_global_getters(rampup):
    args = (32, 2, 2, rampup)
    if rampup is not None and len(rampup) != 3:
        with pytest.raises(ValueError, match="rampup_batch_size"):
            pp.build_num_microbatches_calculator(*args)
        return
    mine = pp.build_num_microbatches_calculator(*args)
    ref = ref_pp.build_num_microbatches_calculator(*args)
    assert type(mine).__name__ == type(ref).__name__
    pp.setup_microbatch_calculator(*args)
    ref_pp.setup_microbatch_calculator(*args)
    for consumed in (0, 60, 120):
        pp.update_num_microbatches(consumed, consistency_check=False)
        ref_pp.update_num_microbatches(consumed, consistency_check=False)
        assert (pp.get_num_microbatches(), pp.get_current_global_batch_size(),
                pp.get_micro_batch_size()) == (
            ref_pp.get_num_microbatches(),
            ref_pp.get_current_global_batch_size(),
            ref_pp.get_micro_batch_size())


def test_kth_microbatch(rng):
    x = rng.randn(12, 3).astype(np.float32)
    mine = pp.get_kth_microbatch({"x": torch.tensor(x), "y": [torch.tensor(
        x[:, 0])]}, 2, 4)
    ref = ref_pp.get_kth_microbatch({"x": jnp.asarray(x), "y": [
        jnp.asarray(x[:, 0])]}, 2, 4)
    np.testing.assert_array_equal(mine["x"].numpy(), np.asarray(ref["x"]))
    np.testing.assert_array_equal(mine["y"][0].numpy(),
                                  np.asarray(ref["y"][0]))


@pytest.mark.parametrize("data, kw", [
    ([[5, 3, 7, 1]], {}),
    ([[5, 0, 7, 1]], dict(eod_token=0, reset_position_ids=True,
                          reset_attention_mask=True, eod_mask_loss=True)),
    ([[0, 4, 0, 0, 9, 2], [3, 3, 0, 1, 0, 6]],
     dict(eod_token=0, reset_position_ids=True)),
    ([[0, 4, 0, 0, 9, 2], [3, 3, 0, 1, 0, 6]],
     dict(eod_token=0, reset_attention_mask=True)),
    ([[0, 4, 0, 0, 9, 2]], dict(eod_token=0, eod_mask_loss=True)),
], ids=["causal", "eod_all", "positions", "attention", "loss_mask"])
def test_ltor_masks_match_reference(data, kw):
    mine = pp.get_ltor_masks_and_position_ids(torch.tensor(data), **kw)
    ref = ref_pp.get_ltor_masks_and_position_ids(
        jnp.asarray(data, jnp.int32), **kw)
    for a, b in zip(mine, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert mine[0].dtype == torch.bool and mine[1].dtype == torch.float32


def test_causal_mask_semantics():
    mask, loss_mask, pos = pp.get_ltor_masks_and_position_ids(
        torch.tensor([[5, 3, 7, 1]]))
    assert mask.shape == (1, 1, 4, 4)
    m = mask[0, 0]
    assert not m[2, 1] and m[1, 2]
    assert pos[0].tolist() == [0, 1, 2, 3]
    assert loss_mask[0].tolist() == [1, 1, 1, 1]


def test_timers_accumulate_log_and_record_spans():
    tl = timeline.enable()
    try:
        timers = pp.Timers()
        t = timers("fwd")
        t.start(barrier_data=torch.ones(3))
        time.sleep(0.02)
        t.stop(barrier_data={"x": torch.ones(2)})
        t.start()
        time.sleep(0.01)
        e = t.elapsed(reset=False)
        assert e >= 0.03 and t.started_
        t.stop()
        assert timers.log(["fwd", "missing"]).startswith("time (ms) | fwd: ")
        assert [s.name for s in tl.spans() if s.category == "timers"] == \
            ["fwd"] * 3
        assert t.elapsed() >= 0.03 and t.elapsed() == 0.0
        assert pp.get_timers() is pp.get_timers()
        ref = ref_pp.Timers()
        ref("fwd").start()
        ref("fwd").stop()
        assert ref.log(["fwd"]).split(":")[0] == timers.log(
            ["fwd"]).split(":")[0]
    finally:
        timeline.disable()


def test_timer_syncs_only_where_cuda_work_is(monkeypatch):
    """On the CPU a timer calls no device synchronisation (the card's
    is exercised by tests/test_torch_pp_cuda.py)."""
    seen = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda d=None: seen.append(d))
    t = pp.Timers()("cpu")
    t.start(barrier_data=[torch.ones(2)])
    t.stop(barrier_data=None)
    assert seen == [] or torch.cuda.is_initialized()


def _inputs():
    rng = np.random.RandomState(0)
    return {"losses": [rng.randn(WORLD, 5).astype(np.float32),
                       rng.randn(WORLD, 2, 3).astype(np.float32)],
            "params": {"a": rng.randn(WORLD, 4, 6).astype(np.float32),
                       "b": rng.randn(WORLD, 7).astype(np.float32)}}


@pytest.fixture(scope="module")
def world():
    inp = _inputs()
    return inp, multiproc.launch(torch_pp_worker.utils_world, WORLD, (inp,),
                                 backend="gloo", threads=1, timeout=300)


def _per_rank(fn, tree, axis):
    mesh = Mesh(np.array(jax.devices()[:WORLD]), (axis,))

    def body(t):
        return jnp.asarray(fn(jax.tree.map(lambda a: a[0], t)))[None]

    return np.asarray(jax.jit(shard_map(
        body, mesh=mesh, in_specs=P(axis), out_specs=P(axis),
        check_vma=False))(tree))


def test_average_losses_across_data_parallel_group(world):
    inp, got = world
    want = _per_rank(ref_pp.average_losses_across_data_parallel_group,
                     inp["losses"], "data")
    for r in range(WORLD):
        np.testing.assert_allclose(got[r]["average"], want[r], rtol=1e-6)


@pytest.mark.parametrize("sharded", [True, False])
def test_calc_params_l2_norm(world, sharded):
    inp, got = world
    want = _per_rank(lambda p: ref_pp.calc_params_l2_norm(
        p, params_sharded=sharded), inp["params"], "tensor")
    key = "norm_sharded" if sharded else "norm_replicated"
    for r in range(WORLD):
        np.testing.assert_allclose(got[r][key], want[r], rtol=1e-6)


def test_norm_and_average_in_a_world_of_one():
    x = torch.arange(6.0).reshape(2, 3)
    assert float(pp.calc_params_l2_norm({"x": x})) == pytest.approx(
        float(np.sqrt((np.arange(6.0) ** 2).sum())))
    module = torch.nn.Linear(3, 2)
    want = torch.sqrt(sum((p.detach() ** 2).sum()
                          for p in module.parameters()))
    torch.testing.assert_close(pp.calc_params_l2_norm(module), want)
    avg = pp.average_losses_across_data_parallel_group(
        [torch.tensor([1.0, 3.0]), torch.tensor(5.0)])
    assert avg.tolist() == [2.0, 5.0]
