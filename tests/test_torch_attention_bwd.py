"""The flash-attention backward of apex_tpu_torch against apex_tpu.

``jax.vjp`` of the reference's ``flash_attention`` against the port's
autograd, for dq, dk and dv, on the same numpy inputs and cotangent. The
reference runs its Pallas backward kernels in interpret mode (and, in
fp32, also its XLA path, which autograd differentiates); the port's
``_FlashFn`` runs the plain backward ``_flash_bwd_torch`` on CPU
tensors — the version the CUDA kernels are held against on the card
(``tests/test_torch_kernels_cuda.py``).

Tolerances, relative to the largest |value| of each gradient: fp32
within 1e-5 (fp32 products and sums in other orders, blockwise on the
interpret side); bf16 within 2^-6, two bf16 ulps of the largest value
(both sides round dS to bf16 before its products, and fp32 values that
differ in their last bits may round dS, and the result, to neighbouring
bf16 values).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from apex_tpu.ops.attention import flash_attention as ref_flash

from apex_tpu_torch.ops import attention as port

FP32_RTOL = 1e-5
BF16_RTOL = 2.0 ** -6

# name: (b, h, hk, sq, sk, d, causal, window, segments)
CASES = {
    "causal": (2, 2, 2, 32, 32, 16, True, None, None),
    "chunk_offset": (2, 2, 2, 16, 48, 16, True, None, None),
    "gqa": (1, 4, 2, 32, 32, 16, True, None, None),
    "segments_masked_row": (2, 2, 2, 24, 24, 16, True, None, "masked_row"),
    "window": (1, 2, 2, 40, 40, 16, True, 9, None),
    "non_causal": (2, 2, 1, 20, 28, 16, False, None, None),
}


def _inputs(case, seed=0):
    b, h, hk, sq, sk, d, causal, window, segs = CASES[case]
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k = rng.randn(b, hk, sk, d).astype(np.float32)
    v = rng.randn(b, hk, sk, d).astype(np.float32)
    g = rng.randn(b, h, sq, d).astype(np.float32)
    kw = {"causal": causal, "window_size": window}
    if segs == "masked_row":
        # two packed segments, and a query of segment 2, which no key
        # has: its row is fully masked (output 0, lse NEG_INF, no grad)
        q_seg = np.zeros((b, sq), np.int32)
        q_seg[:, sq // 2:] = 1
        q_seg[:, sq - 3] = 2
        k_seg = np.zeros((b, sk), np.int32)
        k_seg[:, sk // 2:] = 1
        kw.update(segment_ids=q_seg, kv_segment_ids=k_seg)
    return (q, k, v, g), kw


def _ref(qkvg, kw, jdt, impl):
    q, k, v, g = (jnp.asarray(a).astype(jdt) for a in qkvg)
    jkw = {n: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()}
    _, vjp = jax.vjp(lambda q_, k_, v_: ref_flash(q_, k_, v_, impl=impl,
                                                  **jkw), q, k, v)
    return [np.asarray(c.astype(jnp.float32)) for c in vjp(g)]


def _port(qkvg, kw, tdt):
    q, k, v, g = (torch.from_numpy(a).to(tdt) for a in qkvg)
    for t in (q, k, v):
        t.requires_grad_()
    tkw = {n: (torch.from_numpy(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()}
    out = port.flash_attention(q, k, v, **tkw)
    assert out.dtype == tdt
    out.backward(g)
    return [t.grad.float().numpy() for t in (q, k, v)]


def _close(got, want, rtol):
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        scale = max(float(np.abs(b).max()), 1e-6)
        err = float(np.abs(a - b).max())
        assert err <= rtol * scale, (name, err, scale)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fp32_matches_reference(impl, case):
    qkvg, kw = _inputs(case)
    _close(_port(qkvg, kw, torch.float32),
           _ref(qkvg, kw, jnp.float32, impl), FP32_RTOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_matches_reference_kernels(case):
    qkvg, kw = _inputs(case, seed=1)
    # the same bf16 values on both sides
    qkvg = [np.array(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))
            for a in qkvg]
    _close(_port(qkvg, kw, torch.bfloat16),
           _ref(qkvg, kw, jnp.bfloat16, "interpret"), BF16_RTOL)


def test_fully_masked_row_has_no_gradient():
    qkvg, kw = _inputs("segments_masked_row")
    dq, _, _ = _port(qkvg, kw, torch.float32)
    sq = CASES["segments_masked_row"][3]
    assert (dq[:, :, sq - 3] == 0).all()


def test_options_without_kernel_differentiate_by_autograd():
    """bias, dropout and a returned lse's gradient, once left to ordinary
    autograd through the plain forward, now take ``_FlashFn`` and its
    flash backward (their kernels are ported): its gradients, dbias
    included, agree with ordinary autograd through the plain forward."""
    qkvg, _ = _inputs("causal")
    g = torch.from_numpy(qkvg[3])
    bias0 = np.random.RandomState(3).randn(1, 1, 32, 32).astype(np.float32)
    kw = dict(causal=True, dropout_rate=0.2, dropout_rng=7)
    grads = []
    for flash in (True, False):
        q, k, v = (torch.from_numpy(a).requires_grad_() for a in qkvg[:3])
        bias = torch.from_numpy(bias0).requires_grad_()
        if flash:
            out, lse = port.flash_attention(q, k, v, bias=bias,
                                            return_lse=True, **kw)
            assert "FlashFn" in type(out.grad_fn).__name__
        else:
            out, lse = port._attention_torch(
                q, k, v, bias, None, None, 16 ** -0.5, True, None, 0.2, 7,
                return_lse=True)
        (out * g).sum().add(lse.sum()).backward()
        grads.append([t.grad.numpy() for t in (q, k, v, bias)])
    _close(grads[0], grads[1], FP32_RTOL)
    scale = float(np.abs(grads[1][3]).max())
    assert float(np.abs(grads[0][3] - grads[1][3]).max()) <= \
        FP32_RTOL * scale
