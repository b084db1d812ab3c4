"""Tensor parallelism on the card: two ranks sharing one CUDA device over
gloo (NCCL refuses two ranks on one card), spawned once for the module
(``torch_tp_worker.cuda_world``).

Needs a CUDA device and skips without one. Imports neither JAX nor
apex_tpu: ``python -m pytest --noconftest -m cuda
tests/test_torch_tp_cuda.py``. A tiny GPT (fp32, TF32 off) at tp=2
through the mesh step: every replicated leaf bitwise equal across the
two ranks after every step; the first loss within 1e-5 relative of one
rank's tp=1 loss on the same weights and batch (fp32 sums in other
orders: the row-parallel partial products and the vocab-split cross
entropy's sums); the flash forward, dq and dk/dv and the LayerNorm
forward and backward kernels launched on each rank, once a layer a step
(the LayerNorms twice a layer and once more for the final norm).
"""

import numpy as np
import pytest
import torch

import torch_tp_worker
from apex_tpu_torch.parallel import multiproc

WORLD, STEPS, LAYERS = 2, 3, 2
CFG = dict(vocab_size=128, max_seq_len=64, hidden_size=128,
           num_layers=LAYERS, num_heads=4, dtype=torch.float32)


@pytest.fixture(scope="module")
def world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, CFG["vocab_size"], (2, 65))
    inp = {"cfg": CFG, "tokens": tokens[:, :-1], "labels": tokens[:, 1:],
           "steps": STEPS}
    return multiproc.launch(torch_tp_worker.cuda_world, WORLD, (inp,),
                            backend="gloo", timeout=600)


@pytest.mark.cuda
def test_tp2_replicated_leaves_stay_bitwise_equal(world):
    for a, b in zip(world[0]["replicated"], world[1]["replicated"]):
        assert a.keys() == b.keys() and a
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert world[0]["losses"] == world[1]["losses"]
    assert world[0]["losses"][-1] < world[0]["losses"][0]


@pytest.mark.cuda
def test_tp2_loss_matches_one_rank(world):
    for r in range(WORLD):
        np.testing.assert_allclose(world[r]["losses"][0], world[r]["tp1"],
                                   rtol=1e-5)


@pytest.mark.cuda
def test_tp2_kernels_launch_on_each_rank(world):
    from apex_tpu_torch.ops import attention, layer_norm

    fp32 = torch.float32
    for r in range(WORLD):
        n = world[r]["launches"]
        for base in (attention.KERNEL, attention.BWD_DQ_KERNEL,
                     attention.BWD_DKV_KERNEL):
            assert n.get(attention.kernel_name(base, fp32), 0) == \
                LAYERS * STEPS, base
        for name in (layer_norm.KERNEL, layer_norm.BWD_KERNEL):
            assert n.get(name, 0) == (2 * LAYERS + 1) * STEPS, name
