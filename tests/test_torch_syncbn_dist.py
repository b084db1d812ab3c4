"""Cross-device SyncBatchNorm at world 4 against the global BatchNorm
and the reference's, convert_syncbn_model, and the tiny ResNet's
synchronised step through the ImageNet example against the reference's.

The port runs in four gloo CPU processes, launched once for the module
(``torch_dist_worker.syncbn_cases``); the reference in this process
under ``shard_map`` over four simulated CPU devices, the global
BatchNorm in float64 (``F.batch_norm`` over the whole batch), on the
same inputs from the seed.

Tolerances (fp32): outputs, input and affine gradients, running
statistics and eval outputs within 1e-5 absolute of the reference and
of the float64 global BatchNorm (sums of 16 values in other orders;
the normalised values are O(1), the gradients O(1)). The converted
model against the same torch model on the global batch: 1e-5. The tiny
ResNet's step (O0: fp32 compute, the reference's example loop over four
devices with ``--sync-bn``): the loss within 1e-5 relative and every
parameter and running statistic within 1e-4 relative L2 of the
reference's, through 8 convolutions and 9 BatchNorms of fp32 sums in
other orders.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from apex_tpu.parallel import SyncBatchNorm as RefBN

import torch_dist_worker
from apex_tpu_torch.models.convert import resnet_params_from_jax
from apex_tpu_torch.parallel import multiproc

WORLD, ROWS, C = 4, 4, 6
RESNET_BATCH = 16
TOL = 1e-5


def _affine():
    return (np.linspace(0.5, 1.5, C, dtype=np.float32),
            np.linspace(-0.2, 0.2, C, dtype=np.float32))


def _seq_and_x():
    torch.manual_seed(0)
    seq = nn.Sequential(nn.Conv2d(3, 4, 3), nn.BatchNorm2d(4, momentum=0.2),
                        nn.ReLU(), nn.Flatten(), nn.Linear(4 * 4 * 4, 5),
                        nn.BatchNorm1d(5, eps=1e-3))
    with torch.no_grad():
        for m in (seq[1], seq[5]):
            m.weight.uniform_(0.5, 1.5)
            m.bias.uniform_(-0.5, 0.5)
    x = np.random.RandomState(3).randn(WORLD, 3, 3, 6, 6).astype(np.float32)
    return seq, x


def _ref_resnet():
    from apex_tpu.models.resnet import ResNet, ResNetConfig

    cfg = ResNetConfig.resnet18ish(num_classes=100, bn_axis_name="data",
                                   dtype=jnp.float32)
    model = ResNet(cfg)
    rng = np.random.RandomState(0)
    x = rng.rand(RESNET_BATCH, 32, 32, 3).astype(np.float32)
    y = rng.randint(0, 100, RESNET_BATCH).astype(np.int32)
    variables = model.init(jax.random.PRNGKey(0), x[:2], train=True)
    return model, variables["params"], variables["batch_stats"], x, y


@pytest.fixture(scope="module")
def world():
    rng = np.random.RandomState(0)
    x = rng.randn(WORLD, ROWS, C).astype(np.float32) * 2 + 0.5
    t = rng.randn(WORLD, ROWS, C).astype(np.float32)
    seq, seq_x = _seq_and_x()
    _, params, stats, _, _ = _ref_resnet()
    state = resnet_params_from_jax(jax.tree.map(np.asarray, params),
                                   jax.tree.map(np.asarray, stats))
    inp = {"x": x, "t": t,
           "seq_state": {k: v.numpy() for k, v in seq.state_dict().items()},
           "seq_x": seq_x, "resnet_batch": RESNET_BATCH,
           "resnet_state": {k: v.numpy() for k, v in state.items()}}
    return inp, multiproc.launch(torch_dist_worker.syncbn_cases, WORLD,
                                 (inp,), backend="gloo", threads=1,
                                 timeout=300)


def _ref_bn(x, t, groups=None, fuse_relu=False):
    """The reference's SyncBatchNorm per rank: y, dx, dscale, dbias, the
    running statistics, and the eval output with them."""
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    bn = RefBN(num_features=C, axis_index_groups=groups, fuse_relu=fuse_relu)
    w, b = _affine()
    params = {"scale": jnp.asarray(w), "bias": jnp.asarray(b)}
    stats0 = {"mean": jnp.zeros(C), "var": jnp.ones(C)}

    def body(x, t):
        x, t = x[0], t[0]

        def loss(p, x):
            y, mut = bn.apply({"params": p, "batch_stats": stats0}, x,
                              mutable=["batch_stats"])
            return jnp.sum(y * t), (y, mut["batch_stats"])

        (_, (y, st)), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(params, x)
        ev = bn.apply({"params": params, "batch_stats": st}, x, True)
        out = (y, gx, gp["scale"], gp["bias"], st["mean"], st["var"], ev)
        return tuple(o[None] for o in out)

    res = jax.jit(shard_map(body, mesh=mesh, in_specs=P("data"),
                            out_specs=P("data"), check_vma=False))(x, t)
    keys = ("y", "dx", "dw", "db", "mean", "var", "eval")
    return dict(zip(keys, (np.asarray(a) for a in res)))


def _global_bn(x, t, fuse_relu=False):
    """F.batch_norm in float64 over the whole (ranks * rows, C) batch."""
    w, b = (torch.tensor(a, dtype=torch.float64, requires_grad=True)
            for a in _affine())
    xg = torch.tensor(x.reshape(-1, C), dtype=torch.float64,
                      requires_grad=True)
    rm = torch.zeros(C, dtype=torch.float64)
    rv = torch.ones(C, dtype=torch.float64)
    y = F.batch_norm(xg, rm, rv, w, b, training=True, momentum=0.1, eps=1e-5)
    if fuse_relu:
        y = torch.relu(y)
    (y * torch.tensor(t.reshape(-1, C), dtype=torch.float64)).sum().backward()
    return {"y": y.detach().numpy().reshape(x.shape),
            "dx": xg.grad.numpy().reshape(x.shape),
            "dw": w.grad.numpy(), "db": b.grad.numpy(),
            "mean": rm.numpy(), "var": rv.numpy()}


@pytest.mark.parametrize("case", ["plain", "relu"])
def test_syncbn_matches_the_global_batchnorm_and_the_reference(world, case):
    inp, got = world
    relu = case == "relu"
    ref = _ref_bn(inp["x"], inp["t"], fuse_relu=relu)
    glob = _global_bn(inp["x"], inp["t"], fuse_relu=relu)
    for r in range(WORLD):
        g = got[r][case]
        for k in ("y", "dx", "mean", "var", "eval"):
            np.testing.assert_allclose(g[k], ref[k][r], rtol=0, atol=TOL,
                                       err_msg=f"{k} rank {r}")
        for k in ("y", "dx"):
            np.testing.assert_allclose(g[k], glob[k][r], rtol=0, atol=TOL)
        for k in ("mean", "var"):
            np.testing.assert_allclose(g[k], glob[k], rtol=0, atol=TOL)
        np.testing.assert_allclose(g["dw"], ref["dw"][r], rtol=0, atol=TOL)
        np.testing.assert_allclose(g["db"], ref["db"][r], rtol=0, atol=TOL)
        if relu:
            assert g["y"].min() >= 0.0
    # the affine gradients summed over the ranks are the global ones
    for k in ("dw", "db"):
        np.testing.assert_allclose(sum(got[r][case][k] for r in range(WORLD)),
                                   glob[k], rtol=0, atol=TOL)


def test_syncbn_groups_of_two(world):
    inp, got = world
    groups = [[0, 1], [2, 3]]
    ref = _ref_bn(inp["x"], inp["t"], groups=groups)
    for half in (slice(0, 2), slice(2, 4)):
        glob = _global_bn(inp["x"][half], inp["t"][half])
        for i, r in enumerate(range(WORLD)[half]):
            g = got[r]["groups"]
            for k in ("y", "dx", "mean", "var", "eval"):
                np.testing.assert_allclose(g[k], ref[k][r], rtol=0, atol=TOL)
            for k in ("y", "dx"):
                np.testing.assert_allclose(g[k], glob[k][i], rtol=0,
                                           atol=TOL)
            np.testing.assert_allclose(g["mean"], glob["mean"], rtol=0,
                                       atol=TOL)


def test_convert_syncbn_model_matches_the_model_on_the_global_batch(world):
    inp, got = world
    seq, x = _seq_and_x()
    seq.train()
    want = seq(torch.tensor(x.reshape(-1, 3, 6, 6))).detach().numpy()
    for r in range(WORLD):
        g = got[r]["convert"]
        np.testing.assert_allclose(g["y"], want.reshape(WORLD, 3, 5)[r],
                                   rtol=0, atol=TOL)
        for i in (1, 5):
            np.testing.assert_allclose(g[f"mean{i}"],
                                       seq[i].running_mean.numpy(), rtol=0,
                                       atol=TOL)
            np.testing.assert_allclose(g[f"var{i}"],
                                       seq[i].running_var.numpy(), rtol=0,
                                       atol=TOL)


def _ref_example_step():
    """One step of the reference ImageNet example's loop (O0, --sync-bn)
    over WORLD devices: its loss on device 0, new params, batch stats."""
    from apex_tpu import amp as ref_amp
    from apex_tpu.models.resnet import cross_entropy_logits
    from apex_tpu.optimizers import FusedSGD
    from apex_tpu.parallel import DistributedDataParallel

    model, params, batch_stats, x, y = _ref_resnet()
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("data",))
    opt = FusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4, impl="xla")
    params, opt_state, amp_state = ref_amp.initialize(params, opt,
                                                      opt_level="O0")
    scaler = ref_amp.make_scaler(amp_state.properties)
    sstate = amp_state.scalers[0]
    ddp = DistributedDataParallel()

    def local(p, bs, x, y):
        def loss_fn(p):
            logits, mut = model.apply({"params": p, "batch_stats": bs}, x,
                                      train=True, mutable=["batch_stats"])
            return scaler.scale_loss(cross_entropy_logits(logits, y),
                                     sstate), mut
        (sloss, mut), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        return sloss, ddp.allreduce_grads(g), mut["batch_stats"]

    sloss, grads, batch_stats = jax.jit(shard_map(
        local, mesh=mesh, in_specs=(P(), P(), P("data"), P("data")),
        out_specs=(P(), P(), P()), check_vma=False))(params, batch_stats,
                                                     x, y)
    new_params, _ = opt.step(opt_state, grads, grad_scale=sstate.loss_scale,
                             skip_if_nonfinite=True)
    return (float(sloss) / float(sstate.loss_scale),
            resnet_params_from_jax(jax.tree.map(np.asarray, new_params),
                                   jax.tree.map(np.asarray, batch_stats)))


def test_tiny_resnet_step_matches_the_reference_example(world):
    _, got = world
    loss, want = _ref_example_step()
    g = got[0]["resnet"]
    assert abs(g["loss"] - loss) <= 1e-5 * abs(loss)
    assert set(g["state"]) == set(want)
    for k, w in want.items():
        w = w.numpy()
        err = np.linalg.norm(g["state"][k] - w) / max(np.linalg.norm(w),
                                                      1e-30)
        assert err <= 1e-4, (k, err)
    # every rank holds the same weights and statistics
    for r in range(1, WORLD):
        for k, v in got[0]["resnet"]["state"].items():
            np.testing.assert_array_equal(got[r]["resnet"]["state"][k], v)
