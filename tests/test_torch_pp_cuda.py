"""Pipeline parallelism on the card: two ranks sharing one CUDA device
over gloo (NCCL refuses two ranks on one card), spawned once for the
module (``torch_pp_worker.cuda_world``).

Needs a CUDA device and skips without one. Imports neither JAX nor
apex_tpu: ``python -m pytest --noconftest -m cuda
tests/test_torch_pp_cuda.py``. A tiny GPT (fp32, TF32 off) at pp=2
through each schedule for 3 steps: the two copies of the tied embedding
bitwise equal after every step; gpipe's step 1 (loss and master) bitwise
1f1b's; losses finite, falling on the synchronous schedules; the
LayerNorm and flash kernels launched on each rank exactly as often as
the schedule works out (remat recomputes every layer's forward in the
backward; the final norm runs on the last stage only, once a scored
microbatch).
"""

import numpy as np
import pytest
import torch

import torch_pp_worker
from apex_tpu_torch.parallel import multiproc

WORLD, STEPS, LAYERS, M = 2, 3, 4, 2
CFG = dict(vocab_size=128, max_seq_len=64, hidden_size=128,
           num_layers=LAYERS, num_heads=4, dtype=torch.float32)


@pytest.fixture(scope="module")
def world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, CFG["vocab_size"], (4, 65))
    inp = {"cfg": CFG, "tokens": tokens[:, :-1], "labels": tokens[:, 1:],
           "steps": STEPS, "m": M}
    return multiproc.launch(torch_pp_worker.cuda_world, WORLD, (inp,),
                            backend="gloo", timeout=600)


def _backward_units(schedule, stage):
    """Units of (microbatch, chunk) that run a backward on ``stage`` over
    STEPS steps: every forward unit in a synchronous schedule; in the
    asynchronous one, tick j's unit when its output reaches a scored
    output within the step."""
    if schedule != "async_1f1b":
        return STEPS * M
    d = WORLD - 1 - stage
    return sum(1 for step in range(STEPS) for j in range(M)
               if j + d < M and step * M + j + d >= WORLD - 1)


SCHEDULES = ["gpipe", "1f1b", "interleaved_1f1b", "async_1f1b"]


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_pp2_tied_embedding_copies_bitwise(world, schedule):
    a, b = world[0][schedule]["tied"], world[1][schedule]["tied"]
    assert len(a) == len(b) == STEPS
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert world[0][schedule]["losses"] == world[1][schedule]["losses"]
    assert all(np.isfinite(world[0][schedule]["losses"]))


@pytest.mark.cuda
def test_pp2_gpipe_step_bitwise_1f1b(world):
    for r in range(WORLD):
        assert world[r]["gpipe"]["losses"][0] == world[r]["1f1b"]["losses"][0]
        assert torch.equal(world[r]["gpipe"]["first_master"],
                           world[r]["1f1b"]["first_master"])
        assert world[r]["1f1b"]["losses"][-1] < world[r]["1f1b"]["losses"][0]


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_pp2_kernels_launch_as_the_schedule_works_out(world, schedule):
    from apex_tpu_torch.ops import attention, layer_norm

    fp32 = torch.float32
    per_stage = LAYERS // WORLD
    for r in range(WORLD):
        n = world[r][schedule]["launches"]
        fwd, bwd = STEPS * M, _backward_units(schedule, r)
        last = r == WORLD - 1
        want = {attention.kernel_name(attention.KERNEL, fp32):
                per_stage * (fwd + bwd),
                attention.kernel_name(attention.BWD_DQ_KERNEL, fp32):
                per_stage * bwd,
                attention.kernel_name(attention.BWD_DKV_KERNEL, fp32):
                per_stage * bwd,
                layer_norm.KERNEL: 2 * per_stage * (fwd + bwd)
                + (bwd if last else 0),
                layer_norm.BWD_KERNEL: 2 * per_stage * bwd
                + (bwd if last else 0)}
        for name, count in want.items():
            assert n.get(name, 0) == count, (r, name)


@pytest.mark.cuda
def test_timers_synchronise_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from apex_tpu_torch.transformer.pipeline_parallel import Timers

    x = torch.randn(4096, 4096, device="cuda")
    t = Timers()("matmul")
    t.start(barrier_data=x)
    for _ in range(8):
        x = x @ x.T / 4096
    t.stop(barrier_data=x)
    assert t.elapsed() > 0
