"""The fused softmax family of apex_tpu_torch against apex_tpu.

The four functions of ``ops/softmax.py`` (scaled, causal, masked and the
generic masked variant) forward and backward (``jax.vjp`` of the
reference against the port's autograd on the same numpy inputs and
cotangent), and ``FusedScaleMaskSoftmax``'s dispatch: causal, padding
with and without a mask, and the unfused path with and without
``mask_func``. The reference runs its XLA path and its Pallas kernels in
interpret mode; the port runs its plain versions on CPU tensors (the
CUDA kernels are held against those on the card,
``tests/test_torch_kernels_cuda.py``).

Tolerances. fp32: outputs within 2e-6 and gradients within 1e-4 of each
row's largest |value|, floored at 1e-3 (exp and fp32 sums in other
orders; where g and sum(g * y) nearly cancel, a few fp32 ulps of y move
dx by more than 1e-5 of the row's largest). bf16 inputs:
outputs within one bf16 ulp of the reference's (2^-7 of the value: both
round the same fp32 softmax once, and values a few fp32 ulps apart may
round to neighbouring bf16 values); gradients within 2^-6 of each row's
largest |value| (two bf16 ulps: the cotangent's products and dx round
once each on either side).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from apex_tpu.ops import softmax as ref
from apex_tpu.transformer.functional import AttnMaskType as RefMaskType
from apex_tpu.transformer.functional import (
    FusedScaleMaskSoftmax as RefFused,
)

from apex_tpu_torch.ops import softmax as port
from apex_tpu_torch.transformer.functional import (
    AttnMaskType,
    FusedScaleMaskSoftmax,
)

FP32_ATOL = 2e-6
FP32_GRAD_RTOL = 1e-4
BF16_RTOL = 2.0 ** -7
BF16_GRAD_RTOL = 2.0 ** -6
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pad_mask(b, sq, sk, seed):
    """BERT's outer-product padding mask (b, 1, sq, sk), True = masked:
    each sequence has a real prefix; its pad query rows have every key
    masked."""
    lens = np.random.RandomState(seed).randint(sk // 3, sk, b)
    lens[0] = sk // 2
    keep = np.arange(sk)[None, :] < lens[:, None]
    qkeep = np.arange(sq)[None, :] < lens[:, None]
    return ~(qkeep[:, :, None] & keep[:, None, :])[:, None]


def _inputs(shape, seed):
    rng = np.random.RandomState(seed)
    x = (3.0 * rng.randn(*shape)).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    return x, g


def _ref_vjp(fn, x, g, jdt):
    xj = jnp.asarray(x).astype(jdt)
    y, vjp = jax.vjp(fn, xj)
    (dx,) = vjp(jnp.asarray(g).astype(y.dtype))
    return (np.asarray(y.astype(jnp.float32)),
            np.asarray(dx.astype(jnp.float32)))


def _port_grad(fn, x, g, tdt):
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    y = fn(xt)
    assert y.dtype == tdt
    y.backward(torch.from_numpy(g).to(tdt))
    return y.detach().float().numpy(), xt.grad.float().numpy()


def _close(got, want, dt):
    y, dx = got
    wy, wdx = want
    if dt == "fp32":
        np.testing.assert_allclose(y, wy, rtol=0, atol=FP32_ATOL)
        grad_rtol = FP32_GRAD_RTOL
    else:
        assert np.all(np.abs(y - wy) <= BF16_RTOL * np.abs(wy)), (
            float(np.abs(y - wy).max()))
        grad_rtol = BF16_GRAD_RTOL
    # rows whose gradient is all rounding noise (a causal row 0: y = [1,
    # 0, ...]) are held against 1e-3, a thousandth of a typical |dx|
    row = np.maximum(np.abs(wdx).max(axis=-1, keepdims=True), 1e-3)
    err = np.abs(dx - wdx) / row
    assert float(err.max()) <= grad_rtol, float(err.max())


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 3, 7, 37), (5, 64)],
                         ids=["4d", "2d"])
def test_scaled_softmax_matches_reference(impl, dt, shape):
    x, g = _inputs(shape, 1)
    jdt, tdt = DTYPES[dt]
    want = _ref_vjp(lambda a: ref.scaled_softmax(a, 0.7, impl), x, g, jdt)
    got = _port_grad(lambda a: port.scaled_softmax(a, 0.7), x, g, tdt)
    _close(got, want, dt)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("sq,sk", [(24, 24), (16, 40), (33, 9)])
def test_causal_softmax_matches_reference(impl, dt, sq, sk):
    x, g = _inputs((6, sq, sk), 2)
    jdt, tdt = DTYPES[dt]
    want = _ref_vjp(lambda a: ref.scaled_upper_triang_masked_softmax(
        a, 1.3, impl), x, g, jdt)
    got = _port_grad(lambda a: port.scaled_upper_triang_masked_softmax(
        a, 1.3), x, g, tdt)
    _close(got, want, dt)
    # key j > query i is exactly 0, with no gradient
    upper = np.arange(sk)[None, :] > np.arange(sq)[:, None]
    assert np.all(got[0][:, upper] == 0.0)
    assert np.all(got[1][:, upper] == 0.0)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("mask_batch", ["b", "1"])
def test_masked_softmax_matches_reference(impl, dt, mask_batch):
    b, h, sq, sk = 3, 2, 16, 16
    x, g = _inputs((b, h, sq, sk), 3)
    mask = _pad_mask(b, sq, sk, 4)
    if mask_batch == "1":
        mask = mask[1:2]
    jdt, tdt = DTYPES[dt]
    want = _ref_vjp(lambda a: ref.scaled_masked_softmax(
        a, jnp.asarray(mask), 0.5, impl), x, g, jdt)
    got = _port_grad(lambda a: port.scaled_masked_softmax(
        a, torch.from_numpy(mask), 0.5), x, g, tdt)
    _close(got, want, dt)


def test_fully_masked_rows_add_the_fill():
    """A pad query row has every key masked: the fused path adds -10000
    to each score, so the row is softmax(scale * x - 10000) rounded on
    the grid of fp32 values near 10000, neither zeros nor uniform."""
    b, h, sq, sk = 1, 1, 4, 12
    x, _ = _inputs((b, h, sq, sk), 5)
    mask = np.zeros((1, 1, sq, sk), bool)
    mask[..., 2, :] = True                  # query 2: every key masked
    y = port.scaled_masked_softmax(torch.from_numpy(x),
                                   torch.from_numpy(mask), 0.5).numpy()
    s = (x[0, 0, 2] * np.float32(0.5)).astype(np.float32) - np.float32(1e4)
    e = np.exp((s - s.max()).astype(np.float32))
    np.testing.assert_allclose(y[0, 0, 2], e / e.sum(), rtol=0, atol=1e-6)
    assert np.all(y[0, 0, 2] > 0) and np.ptp(y[0, 0, 2]) > 1e-3
    # and not the unshifted softmax: 10000 is not exact on that grid
    exact = np.exp(x[0, 0, 2] * 0.5 - (x[0, 0, 2] * 0.5).max())
    assert np.abs(y[0, 0, 2] - exact / exact.sum()).max() > 1e-6


MASKS = {
    # name: mask shape for x (2, 3, 8, 10)
    "standard_b": (2, 1, 8, 10),
    "standard_1": (1, 1, 8, 10),
    "key_padding": (2, 1, 1, 10),
    "per_head": (2, 3, 8, 10),
    "two_d": (8, 10),
}


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("variant", sorted(MASKS))
def test_generic_masked_softmax_broadcasts(impl, dt, variant):
    """Any broadcastable mask. The reference sends the non-standard ones
    through XLA and differentiates the fp32 softmax there; the port
    broadcasts them to one mask row per score row and takes the fused
    path, whose backward reads the saved y in x's dtype. In bf16 the
    gradient is therefore held against the reference's fused variant on
    that broadcast mask (the output against the generic function)."""
    x, g = _inputs((2, 3, 8, 10), 6)
    mask = np.random.RandomState(7).rand(*MASKS[variant]) < 0.3
    jdt, tdt = DTYPES[dt]
    want = _ref_vjp(lambda a: ref.generic_scaled_masked_softmax(
        a, jnp.asarray(mask), 0.9, impl), x, g, jdt)
    got = _port_grad(lambda a: port.generic_scaled_masked_softmax(
        a, torch.from_numpy(mask), 0.9), x, g, tdt)
    if dt == "bf16" and not variant.startswith("standard"):
        flat = (-1, 1, 8, 10)
        m4 = jnp.asarray(np.broadcast_to(mask, x.shape).reshape(flat))
        fused = _ref_vjp(lambda a: ref.scaled_masked_softmax(
            a.reshape(flat), m4, 0.9, impl).reshape(x.shape), x, g, jdt)
        want = (want[0], fused[1])
    _close(got, want, dt)


def _dispatch_case(kind):
    """(reference module, port module, mask or None) for one dispatcher
    configuration."""
    kw, rkw, mask = {}, {}, None
    if kind == "causal":
        kw["attn_mask_type"] = AttnMaskType.causal
        rkw["attn_mask_type"] = RefMaskType.causal
    if kind in ("padding", "unfused", "unfused_mask_func"):
        mask = _pad_mask(2, 12, 12, 8)
    if kind.startswith("unfused"):
        kw["scaled_masked_softmax_fusion"] = False
        rkw["scaled_masked_softmax_fusion"] = False
        kw["scale"] = rkw["scale"] = 0.8
    if kind == "unfused_mask_func":
        kw["mask_func"] = lambda s, m: torch.where(m, -30.0, s)
        rkw["mask_func"] = lambda s, m: jnp.where(m, -30.0, s)
    return RefFused(impl="xla", **rkw), FusedScaleMaskSoftmax(**kw), mask


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("kind", ["causal", "padding", "no_mask", "unfused",
                                  "unfused_mask_func"])
def test_dispatcher_matches_reference(dt, kind):
    x, g = _inputs((2, 3, 12, 12), 9)
    jdt, tdt = DTYPES[dt]
    rmod, pmod, mask = _dispatch_case(kind)
    rmask = None if mask is None else jnp.asarray(mask)
    pmask = None if mask is None else torch.from_numpy(mask)
    want = _ref_vjp(lambda a: rmod(a, rmask), x, g, jdt)
    got = _port_grad(lambda a: pmod(a, pmask), x, g, tdt)
    _close(got, want, dt)


def test_fused_adds_where_unfused_replaces():
    """The reference's own inconsistency, kept: on a row whose keys are
    all masked the fused kernels add -10000 (softmax of the shifted
    scores) and the unfused path replaces every score by -10000
    (uniform)."""
    x, _ = _inputs((2, 3, 12, 12), 10)
    mask = torch.from_numpy(_pad_mask(2, 12, 12, 8))
    xt = torch.from_numpy(x)
    fused = FusedScaleMaskSoftmax()(xt, mask)
    unfused = FusedScaleMaskSoftmax(scaled_masked_softmax_fusion=False)(
        xt, mask)
    pad = mask[:, 0].all(dim=-1)                    # (b, sq) pad rows
    assert pad.any() and (~pad).any()
    real = ~pad[:, None].expand(2, 3, 12)
    torch.testing.assert_close(fused[real], unfused[real], rtol=0,
                               atol=FP32_ATOL)
    rows = pad[:, None].expand(2, 3, 12)
    torch.testing.assert_close(unfused[rows],
                               torch.full_like(unfused[rows], 1 / 12))
    assert float((fused[rows] - 1 / 12).abs().max()) > 1e-2


def test_plain_entry_matches_dispatcher_on_cpu():
    x, _ = _inputs((2, 3, 12, 12), 11)
    xt = torch.from_numpy(x)
    mask = torch.from_numpy(_pad_mask(2, 12, 12, 12))
    for causal, m, mod in (
            (True, None, FusedScaleMaskSoftmax(
                attn_mask_type=AttnMaskType.causal)),
            (False, mask, FusedScaleMaskSoftmax()),
            (False, None, FusedScaleMaskSoftmax())):
        torch.testing.assert_close(port.softmax_plain(xt, m, causal=causal),
                                   mod(xt, m), rtol=0, atol=0)


def test_bad_shapes_raise():
    x = torch.zeros(2, 3, 4, 4)
    with pytest.raises(ValueError, match="attn_batches"):
        port.scaled_upper_triang_masked_softmax(x)
    with pytest.raises(ValueError, match="broadcast"):
        port.scaled_masked_softmax(x, torch.zeros(3, 1, 4, 4, dtype=bool))
    with pytest.raises(ValueError, match="broadcast"):
        port.scaled_masked_softmax(x, torch.zeros(2, 3, 4, 4, dtype=bool))
    with pytest.raises(ValueError, match="np, sq, sk"):
        FusedScaleMaskSoftmax()(torch.zeros(3, 4, 4))
    with pytest.raises(ValueError, match="fp32"):
        FusedScaleMaskSoftmax(softmax_in_fp32=False, scale=0.5)


def test_no_grad_call_skips_the_autograd_function():
    x = torch.randn(4, 9, requires_grad=True)
    with torch.no_grad():
        y = port.scaled_softmax(x, 2.0)
    assert y.grad_fn is None
    y2 = port.scaled_softmax(x, 2.0)
    assert type(y2.grad_fn).__name__ == "_SoftmaxFnBackward"
    torch.testing.assert_close(y, y2.detach(), rtol=0, atol=0)
