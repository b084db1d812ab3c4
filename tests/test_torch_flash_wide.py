"""Flash attention of apex_tpu_torch against apex_tpu at head widths past
128 (160, zero-padded by the kernels to the built 256, and 256 itself),
in bf16 and fp16, and the errors past the built widths.

``jax.vjp`` of the reference's ``flash_attention`` with ``impl="xla"``
(its plain XLA path) and ``impl="interpret"`` (its Pallas forward and
backward kernels, interpreted on the CPU) against the port's forward and
autograd on the same numpy inputs and cotangent: GQA 2:1, causal, with
segment ids. The port runs its plain versions on CPU tensors
(``_attention_torch``, ``_flash_bwd_torch``): the versions the CUDA
kernels are held against on the card (``chip_smoke.py``,
``tests/test_torch_kernels_cuda.py``).

Tolerances, those of ``test_torch_flash_dtypes.py``, relative to each
output's (and gradient's) largest |value|: bf16 within 2^-6, two bf16
ulps; fp16 within 2^-9, two fp16 ulps (both round dS to the input dtype
before its products, where fp32 values that differ in their last bits
may round to neighbouring values; the reference rounds P before P.V, the
plain forward keeps it fp32). The fp32 log-sum-exp within 1e-5 absolute.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from apex_tpu.ops.attention import flash_attention as ref_flash

from apex_tpu_torch.ops import attention as port

RTOL = {"fp16": 2.0 ** -9, "bf16": 2.0 ** -6}
DTYPES = {"fp16": (jnp.float16, torch.float16),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
B, H, HK, S = 2, 2, 1, 64


def _inputs(d, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, S, d).astype(np.float32)
    k = rng.randn(B, HK, S, d).astype(np.float32)
    v = rng.randn(B, HK, S, d).astype(np.float32)
    g = rng.randn(B, H, S, d).astype(np.float32)
    seg = np.zeros((B, S), np.int32)
    seg[0, 40:] = 1
    seg[1, 17:] = 1
    seg[1, 50:] = 2
    return (q, k, v, g), seg


def _ref(qkvg, seg, jdt, impl):
    q, k, v, g = (jnp.asarray(a).astype(jdt) for a in qkvg)

    def f(q_, k_, v_):
        return ref_flash(q_, k_, v_, causal=True,
                         segment_ids=jnp.asarray(seg), impl=impl,
                         return_lse=True)

    (out, lse), vjp = jax.vjp(f, q, k, v)
    grads = vjp((g, jnp.zeros_like(lse)))
    return [np.asarray(t.astype(jnp.float32)) for t in (out, *grads)], \
        np.asarray(lse)


def _port(qkvg, seg, tdt):
    q, k, v, g = (torch.from_numpy(a).to(tdt) for a in qkvg)
    for t in (q, k, v):
        t.requires_grad_()
    out, lse = port.flash_attention(q, k, v, causal=True,
                                    segment_ids=torch.from_numpy(seg),
                                    return_lse=True)
    assert out.dtype == tdt
    out.backward(g)
    return [t.detach().float().numpy() for t in (out, q.grad, k.grad,
                                                 v.grad)], lse.detach().numpy()


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("d", [160, 256])
@pytest.mark.parametrize("dt", ["bf16", "fp16"])
def test_wide_heads_match_reference(dt, d, impl):
    qkvg, seg = _inputs(d)
    jdt, tdt = DTYPES[dt]
    want, wlse = _ref(qkvg, seg, jdt, impl)
    got, glse = _port(qkvg, seg, tdt)
    for name, a, w in zip(("out", "dq", "dk", "dv"), got, want):
        scale = float(np.abs(w).max())
        err = float(np.abs(a - w).max())
        assert err <= RTOL[dt] * scale, (name, err, scale)
    np.testing.assert_allclose(glse, wlse, rtol=0, atol=1e-5)


@pytest.mark.parametrize("d", [20, 40, 160])
def test_zero_columns_leave_the_backward_unchanged(d):
    """The wgmma backward reads heads padded with zero columns to
    ``tma_width`` (TMA's 16-byte strides) and keeps the first d columns
    of each gradient: the plain backward on the padded inputs, cut, is
    the plain backward on the inputs (the same scale passed)."""
    width = port.tma_width(d)
    assert width % 8 == 0 and width >= max(d, 32)
    rng = np.random.RandomState(d)
    q, k, v, do = (torch.from_numpy(rng.randn(1, 2, 48, d).astype(
        np.float32)).to(torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    out, lse = port._attention_torch(q, k, v, None, None, None, scale, True,
                                     return_lse=True)
    delta = (out.float() * do.float()).sum(-1)
    want = port._flash_bwd_torch(q, k, v, lse, do, delta, None, None,
                                 scale, True, None)
    pad = [torch.nn.functional.pad(t, (0, width - d)) for t in (q, k, v, do)]
    got = port._flash_bwd_torch(pad[0], pad[1], pad[2], lse, pad[3], delta,
                                None, None, scale, True, None)
    for g_, w_ in zip(got, want):
        assert g_.shape[-1] == width
        assert not g_[..., d:].float().abs().any()
        top = float(w_.float().abs().max())
        np.testing.assert_allclose(g_[..., :d].float().numpy(),
                                   w_.float().numpy(), rtol=0,
                                   atol=2.0 ** -8 * top)


@pytest.mark.parametrize("d", [129, 200, 256])
def test_fp32_past_128_raises_with_its_reason(d):
    with pytest.raises(NotImplementedError,
                       match=f"head_dim {d} in fp32.*384 KB of shared memory"):
        port.check_head_dim(d, torch.float32)
    z = torch.zeros(1, 2, 8, d)
    with pytest.raises(NotImplementedError, match="in fp32"):
        port._check_kernel_args(z, z, z, None, None)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("d", [257, 512])
def test_widths_past_256_raise(dtype, d):
    with pytest.raises(NotImplementedError, match=f"head_dim {d}"):
        port.check_head_dim(d, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_widths_to_256_pass_in_16_bits(dtype):
    for d in (1, 100, 129, 192, 256):
        port.check_head_dim(d, dtype)
        assert port.tma_width(d) <= 256
    port.check_head_dim(128, torch.float32)
