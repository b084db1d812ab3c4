"""The LayerNorm / RMSNorm backward of apex_tpu_torch against apex_tpu.

``jax.vjp`` of the reference's ``fused_layer_norm`` / ``fused_rms_norm``
(its XLA path, and its Pallas backward kernel in interpret mode) against
the port's autograd on the same numpy inputs and cotangents. On CPU
tensors the port's ``_NormFn`` runs the plain backward ``_bwd_torch``,
which the CUDA kernel is held against on the card
(``tests/test_torch_kernels_cuda.py``).

Tolerances: fp32 dx within 2e-5 absolute (a few fp32 roundings of values
of order 1-10, sums in other orders); dw and db, sums over up to 129
rows, within 1e-5 relative to the largest |value| of each. bf16 x: dx
within one bf16 ulp of |dx| plus 1e-5 (the fp32 values before the cast
may differ in their last bits and round to neighbouring bf16 values),
dw and db as in fp32 (they stay fp32).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from apex_tpu.ops import layer_norm as ref

from apex_tpu_torch.ops import layer_norm as port

DX_ATOL = 2e-5
PARAM_RTOL = 1e-5


def _inputs(shape, h, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape, h) * 2 + 0.5).astype(np.float32)
    w = (1 + 0.1 * rng.randn(h)).astype(np.float32)
    b = (0.1 * rng.randn(h)).astype(np.float32)
    g = rng.randn(*shape, h).astype(np.float32)
    return x, w, b, g


def _to_jax(a, dtype):
    return jnp.asarray(a).astype(dtype)


def _to_torch(a, dtype):
    t = torch.from_numpy(a)
    return t.to(dtype) if dtype == torch.bfloat16 else t


def _ref_grads(x, w, b, g, rms, affine, jdt, impl):
    xj, gj = _to_jax(x, jdt), _to_jax(g, jdt)
    args = [xj]
    if affine:
        args.append(jnp.asarray(w))
        if not rms:
            args.append(jnp.asarray(b))

    def f(*a):
        if rms:
            return ref.fused_rms_norm(*a, impl=impl)
        return ref.fused_layer_norm(*a, impl=impl)

    _, vjp = jax.vjp(f, *args)
    return [np.asarray(c.astype(jnp.float32)) for c in vjp(gj)]


def _port_grads(x, w, b, g, rms, affine, tdt):
    xt = _to_torch(x, tdt).requires_grad_()
    args = [xt]
    if affine:
        args.append(torch.from_numpy(w).requires_grad_())
        if not rms:
            args.append(torch.from_numpy(b).requires_grad_())
    f = port.fused_rms_norm if rms else port.fused_layer_norm
    y = f(*args)
    assert y.dtype == tdt
    y.backward(_to_torch(g, tdt))
    return [a.grad.float().numpy() for a in args]


def _check(got, want, bf16):
    dx, dx_want = got[0], want[0]
    if bf16:
        assert (np.abs(dx - dx_want)
                <= 2.0 ** -7 * np.abs(dx_want) + 1e-5).all()
    else:
        np.testing.assert_allclose(dx, dx_want, rtol=0, atol=DX_ATOL)
    for p, p_want in zip(got[1:], want[1:]):
        np.testing.assert_allclose(
            p, p_want, rtol=0, atol=PARAM_RTOL * np.abs(p_want).max())


# h: a narrow row, GPT-2 345M's and BERT-Large's 1024, and 1000 (the last
# 16-byte packs of a lane's row ragged)
WIDTHS = [128, 1024, 1000]


@pytest.mark.parametrize("h", WIDTHS)
@pytest.mark.parametrize("rows", [64, 7, 129])   # tiles, and does not
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("rms", [False, True])
def test_fp32_matches_reference(impl, rows, affine, rms, h):
    x, w, b, g = _inputs((rows,), h, seed=rows)
    want = _ref_grads(x, w, b, g, rms, affine, jnp.float32, impl)
    got = _port_grads(x, w, b, g, rms, affine, torch.float32)
    _check(got, want, bf16=False)


@pytest.mark.parametrize("h", WIDTHS)
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("rows", [32, 9])
def test_bf16_x_fp32_weights(impl, rows, rms, h):
    x, w, b, g = _inputs((rows,), h, seed=10 + rows)
    # the same bf16 values on both sides
    x = np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    g = np.array(jnp.asarray(g).astype(jnp.bfloat16).astype(jnp.float32))
    want = _ref_grads(x, w, b, g, rms, True, jnp.bfloat16, impl)
    got = _port_grads(x, w, b, g, rms, True, torch.bfloat16)
    _check(got, want, bf16=True)


def test_3d_input(impl):
    x, w, b, g = _inputs((3, 5), 96, seed=3)
    want = _ref_grads(x, w, b, g, False, True, jnp.float32, impl)
    got = _port_grads(x, w, b, g, False, True, torch.float32)
    assert got[0].shape == (3, 5, 96)
    _check(got, want, bf16=False)


def test_plain_backward_mirrors_reference_bwd_xla():
    """``_bwd_torch`` against ``_bwd_xla`` on the same saved
    statistics, outside autograd."""
    x, w, _, g = _inputs((33,), 64, seed=4)
    _, mean, rstd = ref._fwd_xla(jnp.asarray(x), jnp.asarray(w), None, 1e-5,
                                 False, True, False)
    want = ref._bwd_xla(jnp.asarray(x), jnp.asarray(w), mean, rstd,
                        jnp.asarray(g), False, True)
    got = port._bwd_torch(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(np.asarray(mean)),
                          torch.from_numpy(np.asarray(rstd)),
                          torch.from_numpy(g), False)
    _check([t.numpy() for t in got], [np.asarray(a) for a in want],
           bf16=False)


def test_no_grad_skips_the_autograd_function():
    x, w, b, _ = _inputs((4,), 16, seed=5)
    xt = torch.from_numpy(x).requires_grad_()
    with torch.no_grad():
        y = port.fused_layer_norm(xt, torch.from_numpy(w),
                                  torch.from_numpy(b))
    assert y.grad_fn is None
    y = port.fused_layer_norm(xt, torch.from_numpy(w), torch.from_numpy(b))
    # the reshape back to x's shape sits on top of the norm's node
    assert type(y.grad_fn.next_functions[0][0]).__name__ == "_NormFnBackward"
