"""The data-parallel plane on the card: two ranks sharing one CUDA
device over gloo (NCCL refuses two ranks on one card), spawned once for
the module (``torch_dist_worker.cuda_cases``).

Needs a CUDA device and skips without one. Imports neither JAX nor
apex_tpu: ``python -m pytest --noconftest -m cuda
tests/test_torch_ddp_cuda.py``. Checks: a CUDA flat buffer's sum over
the two ranks equals the CPU's a + b bitwise (one rounding either way);
SyncBatchNorm on CUDA tensors against F.batch_norm in float64 over the
whole batch within 1e-5 (fp32 sums in other orders); the DDP example's
FusedSGD kernel once a step on each rank, the ranks' master and
momentum bitwise equal after every step.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_dist_worker
from apex_tpu_torch.parallel import multiproc

WORLD, STEPS = 2, 5


@pytest.fixture(scope="module")
def world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    rng = np.random.RandomState(0)
    inp = {"flat": rng.randn(WORLD, 1 << 20).astype(np.float32),
           "x": (rng.randn(WORLD, 8, 6) * 2 + 0.5).astype(np.float32),
           "t": rng.randn(WORLD, 8, 6).astype(np.float32), "steps": STEPS}
    return inp, multiproc.launch(torch_dist_worker.cuda_cases, WORLD, (inp,),
                                 backend="gloo", timeout=600)


@pytest.mark.cuda
def test_cuda_flat_allreduce_equals_the_cpu_sum_bitwise(world):
    inp, got = world
    want = (torch.tensor(inp["flat"][0]) + torch.tensor(inp["flat"][1]))
    for r in range(WORLD):
        np.testing.assert_array_equal(got[r]["flat_sum"], want.numpy())


@pytest.mark.cuda
def test_cuda_syncbn_matches_the_global_batchnorm(world):
    inp, got = world
    c = inp["x"].shape[-1]
    x = torch.tensor(inp["x"].reshape(-1, c), dtype=torch.float64,
                     requires_grad=True)
    rm, rv = (torch.zeros(c, dtype=torch.float64),
              torch.ones(c, dtype=torch.float64))
    y = F.batch_norm(x, rm, rv, training=True, momentum=0.1, eps=1e-5)
    (y * torch.tensor(inp["t"].reshape(-1, c), dtype=torch.float64)
     ).sum().backward()
    for r in range(WORLD):
        g = got[r]["bn"]
        np.testing.assert_allclose(g["y"], y.detach().numpy().reshape(
            inp["x"].shape)[r], rtol=0, atol=1e-5)
        np.testing.assert_allclose(g["dx"], x.grad.numpy().reshape(
            inp["x"].shape)[r], rtol=0, atol=1e-5)
        np.testing.assert_allclose(g["mean"], rm.numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(g["var"], rv.numpy(), rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_fused_sgd_kernel_under_ddp_keeps_the_ranks_bitwise_equal(world):
    _, got = world
    for r in range(WORLD):
        d = got[r]["ddp"]
        assert d["launches"].get("fused_sgd", 0) == STEPS
        assert d["deviations"] == [0.0] * STEPS
        assert d["losses"][-1] < d["losses"][0]
        for k, v in d["master"].items():
            np.testing.assert_array_equal(got[1 - r]["ddp"]["master"][k], v)
