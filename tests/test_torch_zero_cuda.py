"""ZeRO and norms over a sharded flat state on the card: two ranks
sharing one CUDA device over gloo (NCCL refuses two ranks on one card),
spawned once for the module (``torch_zero_worker.cuda_world``).

Needs a CUDA device and skips without one. Imports neither JAX nor
apex_tpu: ``python -m pytest --noconftest -m cuda
tests/test_torch_zero_cuda.py``. A tiny GPT (fp32, TF32 off) at dp=2,
its parameters views into the flat buffer ZeRO gathers into:
ZeRO-Adam's gathered master bitwise DDP + FusedAdam's after every step
(two-value sums, one elementwise kernel); ZeRO-LAMB's within 2 ulp of
DDP + FusedLAMB's plus lr x 2^-20 on the same gradients (per-leaf norms
summed in another order; a second run would part from the first where
the forward meets weights an ulp apart: measured on the card, 1.1e-8 at
a weight of 0.017 by step 3); the Adam, LAMB, sum-of-squares and leaf-sum kernels launched
every step; a bf16-master SR step bitwise the plain SR cast of its fp32
twin's values. Then FusedLAMB at tp=2 through the mesh step: the
replicated leaves bitwise equal across the ranks after every step, the
whole model's gradient norm within 1e-5 of one process's (fp32).
"""

import numpy as np
import pytest
import torch

import torch_zero_worker
from apex_tpu_torch.parallel import multiproc

WORLD, STEPS, LR = 2, 3, 1e-3
CFG = dict(vocab_size=128, max_seq_len=64, hidden_size=128, num_layers=2,
           num_heads=4, dtype=torch.float32)


@pytest.fixture(scope="module")
def world():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, CFG["vocab_size"], (4, 65))
    inp = {"cfg": CFG, "tokens": tokens[:, :-1], "labels": tokens[:, 1:],
           "steps": STEPS}
    return multiproc.launch(torch_zero_worker.cuda_world, WORLD, (inp,),
                            backend="gloo", timeout=600)


@pytest.mark.cuda
def test_zero_adam_is_ddp_bitwise(world):
    for r in range(WORLD):
        for z, d in zip(world[r]["adam"]["zero"], world[r]["adam"]["ddp"]):
            assert torch.equal(z, d)


@pytest.mark.cuda
def test_zero_lamb_within_ulps_of_ddp(world):
    for r in range(WORLD):
        for z, d in zip(world[r]["lamb"]["zero"], world[r]["lamb"]["ddp"]):
            ulp = torch.nextafter(d.abs(), torch.tensor(float("inf"))) - \
                d.abs()
            excess = (z - d).abs() - (2 * ulp + LR * 2.0 ** -20)
            i = int(excess.argmax())
            assert float(excess[i]) <= 0, (i, float(z[i]), float(d[i]))


@pytest.mark.cuda
@pytest.mark.parametrize("opt,kernels", [
    ("adam", ("fused_adam", "sumsq")),
    ("lamb", ("lamb_stage1", "lamb_stage2", "sumsq", "leaf_sum"))])
def test_zero_kernels_launch_every_step(world, opt, kernels):
    for r in range(WORLD):
        counts = world[r][opt]["launches"]
        for k in kernels:
            assert counts.get(k, 0) >= STEPS, (k, counts)


@pytest.mark.cuda
def test_zero_sr_shard_is_the_plain_cast_of_its_twin(world):
    for r in range(WORLD):
        assert world[r]["sr_bitwise"]
        assert world[r]["sr_launches"].get("stochastic_round", 0) >= 1


@pytest.mark.cuda
def test_tp2_lamb_replicated_leaves_and_norm(world):
    a, b = world[0]["tp"], world[1]["tp"]
    for x, y in zip(a["replicated"], b["replicated"]):
        for k, v in x.items():
            np.testing.assert_array_equal(v, y[k], err_msg=k)
    for t in (a, b):
        np.testing.assert_allclose(t["norm"], t["dense_norm"], rtol=1e-5)
