"""The two data-parallel examples at world 2 on the CPU.

One spawned world of two gloo processes (``torch_dist_worker.
examples_case``) runs the DDP example (``examples/simple_ddp.py``) for
10 steps on the reference's weights, again with a SIGTERM delivered to
rank 1 at step 4, and the ImageNet example at ``--arch tiny --sync-bn``
for 6 steps, saved, then resumed to step 8 (as
``tests/test_harness_examples.py``'s smoke of the reference's).

The reference: its example's step built from its own functions
(``mnist_mlp_params``, ``mlp_apply``), amp O1, ``FusedSGD(impl="xla")``
and ``DistributedDataParallel`` under ``shard_map`` over two simulated
devices, the same batch. Tolerances: each step's loss on rank 0 within
1e-6 relative, the final weights within 1e-5 relative L2 per leaf (fp32
products of 784-wide rows summed in other orders, ten steps of
momentum); the port's world of 2 against its own world of 1 on the same
global batch (a mean over 64 against the average of two means over 32)
within the same 1e-5.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

import torch_dist_worker
from apex_tpu_torch.examples import simple_ddp
from apex_tpu_torch.parallel import multiproc
from apex_tpu_torch.transformer import parallel_state as ps

STEPS, SIGTERM_STEP = 10, 4
LOSS_TOL, WEIGHT_TOL = 1e-6, 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ref_example():
    spec = importlib.util.spec_from_file_location(
        "ref_simple_ddp", os.path.join(
            ROOT, "examples/simple/distributed/distributed_data_parallel.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_params():
    ex = _ref_example()
    tree = ex.mnist_mlp_params(jax.random.PRNGKey(0))
    return {f"{layer}.{k}": np.asarray(v)
            for layer, d in tree.items() for k, v in d.items()}


def _ref_run(steps=STEPS, batch=64, world=2):
    """The reference example's loop over ``world`` devices; (losses on
    device 0, final params by the port's names)."""
    from apex_tpu import amp
    from apex_tpu.amp import _amp_state
    from apex_tpu.optimizers import FusedSGD
    from apex_tpu.parallel import DistributedDataParallel

    ex = _ref_example()
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.rand(batch, 784), jnp.float32)
    y = jnp.asarray(rng.randint(0, 10, batch), jnp.int32)
    params = ex.mnist_mlp_params(jax.random.PRNGKey(0))
    opt = FusedSGD(lr=0.05, momentum=0.9, impl="xla")
    prev = _amp_state.get_active()
    try:
        params, opt_state, amp_state = amp.initialize(params, opt,
                                                      opt_level="O1")
    finally:
        _amp_state.set_active(prev)
    scaler = amp.make_scaler(amp_state.properties)
    sstate = amp_state.scalers[0]
    ddp = DistributedDataParallel()

    def local_loss(p, x, y):
        logits = ex.mlp_apply(p, x).astype(jnp.float32)
        lse = jax.scipy.special.logsumexp(logits, axis=-1)
        return jnp.mean(lse - jnp.take_along_axis(logits, y[:, None],
                                                  -1)[:, 0])

    @jax.jit
    def step(params, opt_state, sstate, x, y):
        def grads_fn(p, x, y):
            loss, g = jax.value_and_grad(
                lambda p: scaler.scale_loss(local_loss(p, x, y), sstate))(p)
            return loss, ddp.allreduce_grads(g)

        sloss, grads = shard_map(
            grads_fn, mesh=mesh, in_specs=(P(), P("data"), P("data")),
            out_specs=(P(), P()), check_vma=False)(params, x, y)
        new_params, opt_state = opt.step(
            opt_state, grads, grad_scale=sstate.loss_scale,
            skip_if_nonfinite=True)
        return new_params, opt_state, scaler.update(
            sstate, opt_state.found_inf), sloss

    losses = []
    for _ in range(steps):
        params, opt_state, sstate, sloss = step(params, opt_state, sstate,
                                                x, y)
        losses.append(float(sloss) / float(sstate.loss_scale))
    return losses, {f"{layer}.{k}": np.asarray(v)
                    for layer, d in params.items() for k, v in d.items()}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    inp = {"params": _ref_params(), "steps": STEPS,
           "sigterm_step": SIGTERM_STEP,
           "ckpt": str(tmp_path_factory.mktemp("imagenet") / "ck.pt")}
    return inp, multiproc.launch(torch_dist_worker.examples_case, 2, (inp,),
                                 backend="gloo", threads=1, timeout=600)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_ddp_example_matches_the_reference_over_two_devices(world):
    inp, got = world
    losses, params = _ref_run()
    g = got[0]
    assert len(g["losses"]) == STEPS and g["stopped_at"] is None
    for a, b in zip(g["losses"], losses):
        assert abs(a - b) <= LOSS_TOL * abs(b), (g["losses"], losses)
    assert g["losses"][-1] < g["losses"][0]
    for k, w in params.items():
        assert _rel(g["master"][k], w) <= WEIGHT_TOL, k
    for k, v in g["master"].items():
        np.testing.assert_array_equal(got[1]["master"][k], v)


def test_ddp_example_world_of_two_matches_one_process(world):
    inp, got = world
    ps.initialize_model_parallel()
    try:
        res = simple_ddp.train(simple_ddp.parse_args(["--steps", str(STEPS)]),
                               params={k: torch.tensor(v) for k, v in
                                       inp["params"].items()}, device="cpu")
    finally:
        ps.destroy_model_parallel()
    one = torch_dist_worker.master_by_name(res["state"])
    for k, v in one.items():
        assert _rel(got[0]["master"][k], v.numpy()) <= WEIGHT_TOL, k


def test_sigterm_on_rank_one_stops_both_ranks_at_the_same_step(world):
    _, got = world
    for r in range(2):
        assert got[r]["sigterm"]["stopped_at"] == SIGTERM_STEP
        assert len(got[r]["sigterm"]["losses"]) == SIGTERM_STEP


def test_imagenet_example_tiny_sync_bn_saves_and_resumes(world):
    _, got = world
    for r in range(2):
        assert len(got[r]["imagenet"]) == 2
        assert all(np.isfinite(v) for v in got[r]["imagenet"])
