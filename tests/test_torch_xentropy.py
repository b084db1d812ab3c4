"""The fused cross-entropy family of apex_tpu_torch against apex_tpu.

``softmax_cross_entropy_loss`` (``ops/xentropy.py``) forward and
gradient, the contrib ``softmax_cross_entropy`` with ``padding_idx`` and
``SoftmaxCrossEntropyLoss.apply``, and ``vocab_parallel_cross_entropy``
at tp=1 (the reference inside a one-device ``shard_map`` over its
``tensor`` axis). The reference runs its XLA path and its Pallas kernels
in interpret mode (the ``impl`` fixture); the port runs its plain
versions on CPU tensors (the CUDA kernels are held against those on the
card, ``tests/test_torch_kernels_cuda.py``). Inputs are made with numpy
from a seed; bf16 logits cross as uint16 bit patterns.

Tolerances, those of ``tests/test_fused_layers.py``'s xentropy tests or
tighter. Losses (fp32 whatever the logits' dtype): within 1e-5 absolute
and relative (fp32 logsumexp and mean, summed in other orders). fp32
gradients: within 1e-6 absolute (exp of a logsumexp an ulp or two
apart; the gradients are at most 1 in size). bf16 gradients: within one
bf16 ulp of the larger value (2^-7 of it; fp32 values a few ulps apart
may round to neighbouring bf16 values) plus 1e-6 near zero.
vocab_parallel_cross_entropy: the same as the losses and fp32 gradients.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P
from apex_tpu.contrib.xentropy import SoftmaxCrossEntropyLoss as RefLossFn
from apex_tpu.contrib.xentropy import softmax_cross_entropy as ref_contrib
from apex_tpu.ops.xentropy import softmax_cross_entropy_loss as ref_loss
from apex_tpu.transformer.tensor_parallel import (
    vocab_parallel_cross_entropy as ref_vpce,
)

from apex_tpu_torch.contrib.xentropy import (
    SoftmaxCrossEntropyLoss,
    softmax_cross_entropy,
)
from apex_tpu_torch.ops import softmax_cross_entropy_loss
from apex_tpu_torch.ops import xentropy as port_x
from apex_tpu_torch.transformer.tensor_parallel import (
    vocab_parallel_cross_entropy,
)

LOSS_TOL = 1e-5
GRAD_ATOL_FP32 = 1e-6
BF16_REL = 2.0 ** -7
BF16_ATOL = 1e-6
SHAPE = (2, 9, 131)          # multidimensional labels (2, 9); K odd


def _inputs(shape, seed, k=None):
    rng = np.random.RandomState(seed)
    k = shape[-1] if k is None else k
    x = (2.0 * rng.randn(*shape)).astype(np.float32)
    y = rng.randint(0, k, shape[:-1]).astype(np.int32)
    g = rng.randn(*shape[:-1]).astype(np.float32)
    return x, y, g


def _pair(x, dt):
    """The same logits for both sides: a jax array and a torch tensor of
    dtype ``dt`` ("fp32" or "bf16"), bf16 crossing as its uint16 bits."""
    if dt == "fp32":
        return jnp.asarray(x), torch.from_numpy(x.copy())
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    bits = np.asarray(xj).view(np.uint16).view(np.int16).copy()
    return xj, torch.from_numpy(bits).view(torch.bfloat16)


def _ref_vjp(fn, xj, g):
    out, vjp = jax.vjp(fn, xj)
    (dx,) = vjp(jnp.asarray(g))
    return np.asarray(out), np.asarray(dx.astype(jnp.float32))


def _port_vjp(fn, xt, g):
    xt = xt.clone().requires_grad_()
    out = fn(xt)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), xt.grad.float().numpy(), xt.grad.dtype


def _assert_grad_close(got, want, dt):
    if dt == "fp32":
        np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_ATOL_FP32)
    else:
        bound = BF16_REL * np.maximum(np.abs(got), np.abs(want)) + BF16_ATOL
        assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1, 0.2])
def test_loss_and_grad_match_reference(impl, dt, smoothing):
    x, y, g = _inputs(SHAPE, seed=1)
    xj, xt = _pair(x, dt)
    want, want_dx = _ref_vjp(
        lambda l: ref_loss(l, jnp.asarray(y), smoothing, impl), xj, g)
    got, got_dx, gdt = _port_vjp(
        lambda l: softmax_cross_entropy_loss(l, torch.from_numpy(y),
                                             smoothing), xt, g)
    assert got.shape == y.shape and got.dtype == np.float32
    assert gdt == xt.dtype
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL, atol=LOSS_TOL)
    _assert_grad_close(got_dx, want_dx, dt)


@pytest.mark.parametrize("k", [512, 50])
def test_forward_alone_matches_numpy(k):
    """Without a gradient the forward runs alone and gives the loss's
    definition (float64 numpy), as the reference's own test states it."""
    x, y, _ = _inputs((16, k), seed=2)
    with torch.no_grad():
        got = softmax_cross_entropy_loss(torch.from_numpy(x),
                                         torch.from_numpy(y), 0.1).numpy()
    xd = x.astype(np.float64)
    lse = np.log(np.exp(xd).sum(-1))
    want = lse - 0.9 * xd[np.arange(16), y] - 0.1 * xd.mean(-1)
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL, atol=LOSS_TOL)


def test_no_grad_call_skips_the_autograd_function(monkeypatch):
    def refuse(*args):
        raise AssertionError("the autograd Function ran without a gradient")

    monkeypatch.setattr(port_x._XentropyFn, "apply", refuse)
    x, y, _ = _inputs((4, 33), seed=3)
    softmax_cross_entropy_loss(torch.from_numpy(x), torch.from_numpy(y))
    with pytest.raises(AssertionError):
        softmax_cross_entropy_loss(torch.from_numpy(x).requires_grad_(),
                                   torch.from_numpy(y))


def test_labels_get_no_gradient_and_must_be_integers():
    x, y, _ = _inputs((4, 33), seed=4)
    xt = torch.from_numpy(x).requires_grad_()
    softmax_cross_entropy_loss(xt, torch.from_numpy(y), 0.1).sum().backward()
    assert xt.grad is not None
    with pytest.raises(TypeError):
        softmax_cross_entropy_loss(xt, torch.from_numpy(y).float())
    with pytest.raises(ValueError):
        softmax_cross_entropy_loss(xt, torch.from_numpy(y[:3]))


def test_out_of_range_labels_follow_the_pallas_kernel():
    """A label outside [0, K): the Pallas kernel's compare picks x[y] = 0;
    the reference's XLA forward wraps -1 to K-1 and gives NaN for K and
    -100. Both backwards take a zero one-hot. The port follows the
    kernel on both of its paths."""
    x, _, g = _inputs((3, 20), seed=5)
    y = np.asarray([-1, 20, -100], np.int32)
    got, got_dx, _ = _port_vjp(
        lambda l: softmax_cross_entropy_loss(l, torch.from_numpy(y), 0.1),
        torch.from_numpy(x), g)
    for impl in ("interpret", "xla"):
        want, want_dx = _ref_vjp(
            lambda l: ref_loss(l, jnp.asarray(y), 0.1, impl), jnp.asarray(x),
            g)
        np.testing.assert_allclose(got_dx, want_dx, rtol=0,
                                   atol=GRAD_ATOL_FP32)
        if impl == "interpret":
            np.testing.assert_allclose(got, want, rtol=LOSS_TOL,
                                       atol=LOSS_TOL)
        else:
            assert np.isnan(want[1:]).all()
            lse = np.log(np.exp(x[0].astype(np.float64)).sum())
            np.testing.assert_allclose(
                want[0], lse - 0.9 * x[0, -1] - 0.1 * x[0].mean(),
                rtol=LOSS_TOL)
    lse = np.log(np.exp(x.astype(np.float64)).sum(-1))
    np.testing.assert_allclose(got, lse - 0.1 * x.mean(-1), rtol=LOSS_TOL)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("padding_idx", [0, 7])
def test_contrib_padding_rows_are_zero(impl, dt, padding_idx):
    x, y, g = _inputs((4, 6, 40), seed=6)
    y[:, 4:] = padding_idx
    y[1, :2] = padding_idx
    xj, xt = _pair(x, dt)
    want, want_dx = _ref_vjp(
        lambda l: ref_contrib(l, jnp.asarray(y), 0.1, padding_idx,
                              impl=impl), xj, g)
    got, got_dx, _ = _port_vjp(
        lambda l: softmax_cross_entropy(l, torch.from_numpy(y), 0.1,
                                        padding_idx), xt, g)
    pad = y == padding_idx
    assert (got[pad] == 0).all() and (got_dx[pad] == 0).all()
    assert (got[~pad] != 0).all()
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL, atol=LOSS_TOL)
    _assert_grad_close(got_dx, want_dx, dt)


def test_contrib_apply_and_half_to_float():
    x, y, _ = _inputs((5, 30), seed=7)
    y[2] = 0
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    got = SoftmaxCrossEntropyLoss.apply(xt.half(), yt, 0.1, 0, True)
    assert got.dtype == torch.float32
    want = RefLossFn.apply(jnp.asarray(x).astype(jnp.float16),
                           jnp.asarray(y), 0.1, 0, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    same = softmax_cross_entropy(xt.half(), yt, 0.1, 0, False)
    assert torch.equal(got, same)


def _ref_vpce(smoothing):
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("tensor",))
    return shard_map(lambda l, t: ref_vpce(l, t, smoothing), mesh=mesh,
                     in_specs=(P(None, None, "tensor"), P()), out_specs=P(),
                     check_vma=False)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("smoothing", [0.0, 0.1, 0.2])
def test_vocab_parallel_cross_entropy_matches_reference(dt, smoothing):
    x, y, g = _inputs((3, 7, 64), seed=8)
    xj, xt = _pair(x, dt)
    fn = _ref_vpce(smoothing)
    want, want_dx = _ref_vjp(lambda l: fn(l, jnp.asarray(y)), xj, g)
    got, got_dx, _ = _port_vjp(
        lambda l: vocab_parallel_cross_entropy(l, torch.from_numpy(y),
                                               smoothing), xt, g)
    np.testing.assert_allclose(got, want, rtol=LOSS_TOL, atol=LOSS_TOL)
    _assert_grad_close(got_dx, want_dx, dt)


@pytest.mark.parametrize("smoothing", [0.1, 0.2])
def test_the_two_smoothing_conventions_differ(smoothing):
    """xentropy weighs the mean log-probability by s, the vocab-parallel
    loss by s * V / (V - 1): at the same s they differ, and the second at
    s is the first at s * V / (V - 1) — on both sides."""
    v = 16
    x, y, _ = _inputs((6, v), seed=10)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    vp = vocab_parallel_cross_entropy(xt, yt, smoothing).numpy()
    xe = softmax_cross_entropy_loss(xt, yt, smoothing).numpy()
    xe_scaled = softmax_cross_entropy_loss(xt, yt,
                                           smoothing * v / (v - 1)).numpy()
    assert np.abs(vp - xe).min() > 100 * LOSS_TOL
    np.testing.assert_allclose(vp, xe_scaled, rtol=LOSS_TOL, atol=LOSS_TOL)
    ref_vp = np.asarray(_ref_vpce(smoothing)(jnp.asarray(x[None]),
                                             jnp.asarray(y[None])))[0]
    ref_xe = np.asarray(ref_loss(jnp.asarray(x), jnp.asarray(y), smoothing,
                                 "xla"))
    assert np.abs(ref_vp - ref_xe).min() > 100 * LOSS_TOL
    np.testing.assert_allclose(ref_vp, vp, rtol=LOSS_TOL, atol=LOSS_TOL)
