"""fp16 LayerNorm, RMSNorm and the fused softmax family of apex_tpu_torch
against apex_tpu, forward and backward.

fp16 is amp's compute type (O1-O3). ``jax.vjp`` of the reference with
``impl="interpret"`` (its Pallas kernels interpreted on the CPU) against
the port's autograd on the same numpy inputs and cotangent; the port runs
its plain versions on CPU tensors, which the fp16 kernels are held to on
the card (``chip_smoke.py``, ``tests/test_torch_kernels_cuda.py``).

Tolerances. Both sides compute in fp32 and round once to fp16, so an
output is within one fp16 ulp of the reference's (2^-10 of its value:
values a few fp32 ulps apart, sums taken in other orders, may round to
neighbouring fp16 values), plus 2^-14 absolute for values near zero,
where the fp32 results' own differences (a few 1e-7 of the row's scale)
span several of fp16's small ulps. Gradients within 2^-9 of each row's
largest |value| (two fp16 ulps: the cotangent's products and dx round
once each on either side, and where g and the row's dot product nearly
cancel that moves dx by a share of the row's scale); LayerNorm's fp32
dw and db within 1e-5 of their largest |value| (fp32 sums over rows in
other orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from apex_tpu.ops import layer_norm as ref_ln
from apex_tpu.ops import softmax as ref_sm

from apex_tpu_torch.ops import layer_norm as port_ln
from apex_tpu_torch.ops import softmax as port_sm

Y_RTOL, Y_ATOL = 2.0 ** -10, 2.0 ** -14
GRAD_RTOL = 2.0 ** -9
PARAM_RTOL = 1e-5


def _close_y(y, wy):
    excess = np.abs(y - wy) - Y_RTOL * np.abs(wy)
    assert float(excess.max()) <= Y_ATOL, float(excess.max())


def _close_rows(dx, wdx, floor=1e-3):
    row = np.maximum(np.abs(wdx).max(axis=-1, keepdims=True), floor)
    err = float((np.abs(dx - wdx) / row).max())
    assert err <= GRAD_RTOL, err


@pytest.mark.parametrize("rms", [False, True], ids=["layer", "rms"])
@pytest.mark.parametrize("rows,h", [(8, 96), (33, 256), (4, 100),
                                    (37, 1024)])
def test_fp16_norm_matches_reference(rms, rows, h):
    rng = np.random.RandomState(rows + h)
    x = (2.0 * rng.randn(rows, h) + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.randn(h)).astype(np.float32)
    b = (0.1 * rng.randn(h)).astype(np.float32)
    g = rng.randn(rows, h).astype(np.float32)

    if rms:
        def ref_fn(x_, w_):
            return ref_ln.fused_rms_norm(x_, w_, impl="interpret")
        args = (x, w)
    else:
        def ref_fn(x_, w_, b_):
            return ref_ln.fused_layer_norm(x_, w_, b_, impl="interpret")
        args = (x, w, b)
    jargs = [jnp.asarray(args[0]).astype(jnp.float16),
             *(jnp.asarray(a) for a in args[1:])]
    y, vjp = jax.vjp(ref_fn, *jargs)
    assert y.dtype == jnp.float16
    grads = vjp(jnp.asarray(g).astype(jnp.float16))
    want = [np.asarray(t.astype(jnp.float32)) for t in (y, *grads)]

    ts = [torch.from_numpy(args[0]).half().requires_grad_(),
          *(torch.from_numpy(a).requires_grad_() for a in args[1:])]
    fn = port_ln.fused_rms_norm if rms else port_ln.fused_layer_norm
    out = fn(*ts)
    assert out.dtype == torch.float16
    out.backward(torch.from_numpy(g).half())
    got = [out.detach().float().numpy()] + [
        t.grad.float().numpy() for t in ts]
    _close_y(got[0], want[0])
    _close_rows(got[1], want[1])
    for a, w_ in zip(got[2:], want[2:]):
        assert float(np.abs(a - w_).max()) <= PARAM_RTOL * float(
            np.abs(w_).max())


def _pad_mask(b, sq, sk, seed):
    lens = np.random.RandomState(seed).randint(sk // 3, sk, b)
    keep = np.arange(sk)[None, :] < lens[:, None]
    qkeep = np.arange(sq)[None, :] < lens[:, None]
    return ~(qkeep[:, :, None] & keep[:, None, :])[:, None]


def _softmax_case(mode, shape):
    rng = np.random.RandomState(len(mode))
    x = (3.0 * rng.randn(*shape)).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    mask = _pad_mask(shape[0], shape[2], shape[3], 4) \
        if mode == "masked" else None
    return x, g, mask


SOFTMAX = {
    "scaled": ((2, 3, 7, 37), lambda m: (
        lambda a: ref_sm.scaled_softmax(a, 0.7, "interpret"),
        lambda a: port_sm.scaled_softmax(a, 0.7))),
    "causal": ((6, 24, 24), lambda m: (
        lambda a: ref_sm.scaled_upper_triang_masked_softmax(
            a, 1.3, "interpret"),
        lambda a: port_sm.scaled_upper_triang_masked_softmax(a, 1.3))),
    "causal_wide": ((2, 16, 40), lambda m: (
        lambda a: ref_sm.scaled_upper_triang_masked_softmax(
            a, 1.3, "interpret"),
        lambda a: port_sm.scaled_upper_triang_masked_softmax(a, 1.3))),
    "masked": ((3, 2, 16, 16), lambda m: (
        lambda a: ref_sm.scaled_masked_softmax(a, jnp.asarray(m), 0.5,
                                               "interpret"),
        lambda a: port_sm.scaled_masked_softmax(a, torch.from_numpy(m),
                                                0.5))),
}


@pytest.mark.parametrize("mode", sorted(SOFTMAX))
def test_fp16_softmax_matches_reference(mode):
    shape, fns = SOFTMAX[mode]
    x, g, mask = _softmax_case(mode, shape)
    ref_fn, port_fn = fns(mask)
    y, vjp = jax.vjp(ref_fn, jnp.asarray(x).astype(jnp.float16))
    assert y.dtype == jnp.float16
    (dx,) = vjp(jnp.asarray(g).astype(jnp.float16))
    xt = torch.from_numpy(x).half().requires_grad_()
    out = port_fn(xt)
    assert out.dtype == torch.float16
    out.backward(torch.from_numpy(g).half())
    _close_y(out.detach().float().numpy(), np.asarray(y.astype(jnp.float32)))
    _close_rows(xt.grad.float().numpy(), np.asarray(dx.astype(jnp.float32)))
    if mode.startswith("causal"):
        sq, sk = shape[-2:]
        upper = np.arange(sk)[None, :] > np.arange(sq)[:, None]
        assert np.all(out.detach().numpy()[:, upper] == 0.0)


@pytest.mark.parametrize("mod,base", [(port_ln, "layer_norm_fwd"),
                                      (port_ln, "layer_norm_bwd"),
                                      (port_sm, "softmax_causal_fwd"),
                                      (port_sm, "softmax_bwd")])
def test_fp16_launches_count_apart(mod, base):
    assert mod.kernel_name(base, torch.float16) == base + "_fp16"
    for dtype in (torch.float32, torch.bfloat16):
        assert mod.kernel_name(base, dtype) == base
    assert mod._DTYPE_CODES[torch.float16] == 2
