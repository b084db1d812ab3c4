"""apex_tpu_torch's ResNet, NHWC convolution, SAME max-pool and
SyncBatchNorm against apex_tpu's, on the same numpy inputs and
converted weights (CPU tensors: cuDNN's place is taken by PyTorch's CPU
convolution).

Tolerances. fp32: the convolutions sum in another order than XLA's, so
conv and pool outputs agree within 1e-5 of the largest |value| (the
pool exactly: a max rounds nothing); through the tiny ResNet (BatchNorm
renormalises each layer) logits within 1e-5 of their largest |value|
(1.3e-6 read), the running statistics within 1e-5 relative. bf16 (the
compute dtype of the ResNet-50 runs): both sides round every conv and
BatchNorm output to bf16, and an fp32 sum one ulp apart can round to the
neighbouring bf16 value in any layer; the global mean and the fp32 head
average such flips out, so logits within one bf16 ulp (2^-8) of their
largest |value| (3.9e-7 read). SyncBatchNorm alone: 1e-5 (fp32 sums of
the same values in another order), the bf16 output within one bf16 ulp
(2^-8) of each value.
"""

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp
from apex_tpu.contrib.bottleneck import conv2d_nhwc as ref_conv
from apex_tpu.models.resnet import ResNet as RefResNet
from apex_tpu.models.resnet import ResNetConfig as RefConfig
from apex_tpu.parallel.sync_batchnorm import SyncBatchNorm as RefBN
from apex_tpu.parallel.sync_batchnorm import (
    create_syncbn_group_assignment as ref_groups,
)

from apex_tpu_torch.contrib.bottleneck import conv2d_nhwc, same_padding
from apex_tpu_torch.models import (
    ResNet,
    ResNetConfig,
    cross_entropy_logits,
    load_jax_resnet,
)
from apex_tpu_torch.models.resnet import max_pool_same
from apex_tpu_torch.parallel import (
    SyncBatchNorm,
    create_syncbn_group_assignment,
)

HW = 32


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _max_rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def images():
    return np.random.RandomState(0).randn(2, HW, HW, 3).astype(np.float32)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def reference(request, images):
    """The reference's tiny ResNet, its initial variables and one
    jitted train-mode forward (logits and updated batch stats)."""
    cfg = RefConfig.resnet18ish(dtype=jnp.dtype(request.param))
    model = RefResNet(cfg)
    variables = model.init(jax.random.PRNGKey(0), images, train=True)

    @jax.jit
    def forward(v, x):
        out, mut = model.apply(v, x, train=True, mutable=["batch_stats"])
        return out, mut["batch_stats"]

    logits, stats = forward(variables, images)
    eval_logits = jax.jit(lambda v, x: model.apply(
        v, x, train=False))({"params": variables["params"],
                             "batch_stats": stats}, images)
    return (request.param, _np(variables["params"]),
            _np(variables["batch_stats"]), np.asarray(logits, np.float32),
            _np(stats), np.asarray(eval_logits, np.float32))


def _port(dtype_name, params, stats):
    cfg = ResNetConfig.resnet18ish(dtype=getattr(torch, dtype_name))
    model = ResNet(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    return load_jax_resnet(model, params, stats)


def test_forward_and_batch_stats_match_reference(reference, images):
    dtype, params, stats0, want, want_stats, want_eval = reference
    model = _port(dtype, params, stats0)
    with torch.no_grad():
        got = model(torch.from_numpy(images)).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 1000)
    tol = 1e-5 if dtype == "float32" else 2.0 ** -8
    assert _max_rel(got, want) <= tol
    own = model.state_dict()
    for path, leaf in jax.tree_util.tree_leaves_with_path(want_stats):
        keys = [k.key for k in path]
        name = ".".join(keys[:-1] + [{"mean": "running_mean",
                                      "var": "running_var"}[keys[-1]]])
        np.testing.assert_allclose(own[name].numpy(), leaf, rtol=1e-5,
                                   atol=1e-6 if dtype == "float32" else 1e-3)
    # inference on the updated running statistics
    with torch.no_grad():
        got_eval = model(torch.from_numpy(images), train=False).numpy()
    assert _max_rel(got_eval, want_eval) <= tol


def test_load_jax_resnet_is_strict(reference):
    _, params, stats0, *_ = reference
    model = ResNet(ResNetConfig.resnet18ish(), device="cpu")
    bad = dict(params)
    bad.pop("head_bias")
    with pytest.raises(KeyError):
        load_jax_resnet(model, bad, stats0)
    wrong = ResNet(ResNetConfig.resnet18ish(num_classes=10), device="cpu")
    with pytest.raises(ValueError):
        load_jax_resnet(wrong, params, stats0)


def test_init_follows_reference_scheme():
    model = ResNet(ResNetConfig.resnet18ish(), device="cpu",
                   generator=torch.Generator().manual_seed(0))
    w = model.stage0_block0.conv2.detach()        # 3x3, 16 -> 16
    std = np.sqrt(2.0 / (16 * 9)) / 0.87962566103423978
    assert float(w.abs().max()) <= 2 * std
    assert abs(float(w.std()) / (std * 0.8796) - 1) < 0.1
    assert abs(float(model.head.detach().std()) / 0.01 - 1) < 0.05
    assert float(model.head_bias.abs().max()) == 0.0
    assert torch.equal(model.bn_stem.bn.weight, torch.ones(16))
    assert float(model.bn_stem.bn.running_var.min()) == 1.0


@pytest.mark.parametrize("n", [7, 8, 15, 16])
@pytest.mark.parametrize("k,stride", [(1, 1), (1, 2), (3, 1), (3, 2),
                                      (7, 2)])
def test_conv2d_nhwc_matches_reference(n, k, stride):
    rng = np.random.RandomState(n * 10 + k + stride)
    x = rng.randn(2, n, n + 1, 5).astype(np.float32)
    w = rng.randn(k, k, 5, 6).astype(np.float32)
    want = np.asarray(ref_conv(jnp.asarray(x), jnp.asarray(w), stride=stride))
    got = conv2d_nhwc(torch.from_numpy(x), torch.from_numpy(w), stride)
    assert got.shape == want.shape
    assert _max_rel(got.numpy(), want) <= 1e-5


def test_conv2d_nhwc_explicit_padding_matches_reference():
    rng = np.random.RandomState(3)
    x = rng.randn(1, 9, 8, 4).astype(np.float32)
    w = rng.randn(3, 3, 4, 2).astype(np.float32)
    for pad in ("VALID", ((0, 2), (1, 0))):
        want = np.asarray(ref_conv(jnp.asarray(x), jnp.asarray(w), stride=2,
                                   padding=pad))
        got = conv2d_nhwc(torch.from_numpy(x), torch.from_numpy(w), 2, pad)
        assert _max_rel(got.numpy(), want) <= 1e-5


def test_same_padding_is_xlas_not_symmetric():
    assert same_padding(224, 7, 2) == (2, 3)       # the stem
    assert same_padding(56, 3, 2) == (0, 1)        # 3x3 stride 2, even
    assert same_padding(7, 3, 2) == (1, 1)         # odd
    assert same_padding(56, 1, 2) == (0, 0)
    assert same_padding(56, 3, 1) == (1, 1)


@pytest.mark.parametrize("n", [7, 8, 111, 112])
@pytest.mark.parametrize("stride", [1, 2])
def test_max_pool_matches_reference(n, stride):
    x = np.random.RandomState(n + stride).randn(2, n, n, 3).astype(
        np.float32)
    want = np.asarray(nn.max_pool(jnp.asarray(x), (3, 3),
                                  strides=(stride, stride), padding="SAME"))
    got = max_pool_same(torch.from_numpy(x).permute(0, 3, 1, 2), 3,
                        stride).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fuse_relu", [False, True])
def test_sync_batchnorm_matches_reference(fuse_relu, dtype):
    rng = np.random.RandomState(4)
    x = (rng.randn(3, 5, 4, 6) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.randn(6)).astype(np.float32)
    b = (0.1 * rng.randn(6)).astype(np.float32)
    ref = RefBN(6, axis_name=None, fuse_relu=fuse_relu)
    v = ref.init(jax.random.PRNGKey(0), jnp.asarray(x))
    v = {"params": {"scale": jnp.asarray(w), "bias": jnp.asarray(b)},
         "batch_stats": v["batch_stats"]}
    xj = jnp.asarray(x).astype(jnp.dtype(dtype))
    want, mut = ref.apply(v, xj, mutable=["batch_stats"])
    bn = SyncBatchNorm(6, fuse_relu=fuse_relu)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(w))
        bn.bias.copy_(torch.from_numpy(b))
        got = bn(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        assert (np.abs(got - want) <= 2.0 ** -8 * np.abs(want)).all()
    if fuse_relu:
        assert got.min() == 0.0
    for key, buf in (("mean", bn.running_mean), ("var", bn.running_var)):
        np.testing.assert_allclose(buf.numpy(),
                                   np.asarray(mut["batch_stats"][key]),
                                   rtol=1e-5, atol=1e-7)
    with torch.no_grad():
        inf_out = bn(torch.from_numpy(x), use_running_stats=True)
    want_inf = ref.apply({"params": v["params"],
                          "batch_stats": mut["batch_stats"]},
                         jnp.asarray(x), use_running_stats=True)
    np.testing.assert_allclose(inf_out.numpy(), np.asarray(want_inf),
                               rtol=0, atol=1e-5)


def test_sync_batchnorm_takes_a_channels_last_view_and_refuses_sync():
    """The ResNet's activations are NCHW views of NHWC memory; the
    statistics stay per channel whatever the strides. Outside an
    initialized topology the data axis is a world of one, so the
    synchronised module acts unsynchronised (the reference's outside
    shard_map); an axis that parallel_state does not name is refused."""
    x = torch.randn(2, 4, 3, 5, generator=torch.Generator().manual_seed(0))
    bn = SyncBatchNorm(5, axis_name=None)
    y1 = bn(x)
    view = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    assert not view.is_contiguous()
    # sums over another order of the same values
    torch.testing.assert_close(SyncBatchNorm(5)(view), y1, rtol=0, atol=1e-6)
    torch.testing.assert_close(SyncBatchNorm(5, axis_name="data")(x), y1,
                               rtol=0, atol=0)
    with pytest.raises(ValueError):
        SyncBatchNorm(5, axis_name="batch")
    with pytest.raises(ValueError):
        SyncBatchNorm(5, axis_name=None, axis_index_groups=[[0]])
    model = ResNet(ResNetConfig.resnet18ish(bn_axis_name="data",
                                            bn_groups=[[0]]), device="cpu")
    assert model(torch.zeros(1, 8, 8, 3)).shape == (1, 1000)
    assert create_syncbn_group_assignment(8, 4) == ref_groups(8, 4)
    with pytest.raises(ValueError):
        create_syncbn_group_assignment(6, 4)


def test_cross_entropy_matches_reference():
    from apex_tpu.models.resnet import cross_entropy_logits as ref_ce
    rng = np.random.RandomState(5)
    logits = rng.randn(4, 10).astype(np.float32)
    labels = rng.randint(0, 10, 4).astype(np.int32)
    want = float(ref_ce(jnp.asarray(logits), jnp.asarray(labels)))
    got = float(cross_entropy_logits(torch.from_numpy(logits),
                                     torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-6
