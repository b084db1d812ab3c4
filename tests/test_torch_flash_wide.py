"""Flash attention of apex_tpu_torch against apex_tpu at head widths past
128: in bf16 and fp16 160 (zero-padded by the wgmma kernels to the built
256) and 256 itself, and the wide route's widths (``csrc/flash_wide.cu``:
fp32 past 128, any dtype past 256) with every option the kernels take.

``jax.vjp`` of the reference's ``flash_attention`` with ``impl="xla"``
(its plain XLA path) and ``impl="interpret"`` (its Pallas forward and
backward kernels, interpreted on the CPU) against the port's forward and
autograd on the same numpy inputs and cotangent: GQA 2:1, causal, with
segment ids. The port runs its plain versions on CPU tensors
(``_attention_torch``, ``_flash_bwd_torch``): the versions the CUDA
kernels are held against on the card (``chip_smoke.py``,
``tests/test_torch_kernels_cuda.py``).

Tolerances, those of ``test_torch_flash_dtypes.py``, relative to each
output's (and gradient's) largest |value|: fp32 within 1e-5 (fp32
products and sums in other orders); bf16 within 2^-6, two bf16
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

RTOL = {"fp32": 1e-5, "fp16": 2.0 ** -9, "bf16": 2.0 ** -6}
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "fp16": (jnp.float16, torch.float16),
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


# The wide route's widths (fp32 d 160 and 256, bf16 and fp16 d 320), each
# with options of the flash kernels. name: (dtype, b, h, hk, sq, sk, d,
# options)
WIDE_CASES = {
    "fp32_d160_causal_gqa_segments": ("fp32", 2, 2, 1, 64, 64, 160,
                                      "causal_segments"),
    "fp32_d160_window": ("fp32", 1, 2, 2, 64, 64, 160, "window"),
    "fp32_d256_key_segments": ("fp32", 2, 2, 2, 32, 64, 256,
                               "key_segments"),
    "fp32_d256_positions_glse": ("fp32", 1, 2, 1, 32, 64, 256, "positions"),
    "bf16_d320_bias": ("bf16", 2, 2, 1, 32, 48, 320, "bias"),
    "bf16_d320_dropout": ("bf16", 1, 2, 2, 64, 64, 320, "dropout"),
    "fp16_d320_causal_gqa_segments": ("fp16", 2, 4, 2, 32, 32, 320,
                                      "causal_segments"),
    "fp16_d320_key_segments_bias": ("fp16", 2, 2, 2, 16, 48, 320,
                                    "key_segments_bias"),
}
DROPOUT_KEY = 7


def _wide_case(case, seed=3):
    dt, b, h, hk, sq, sk, d, opt = WIDE_CASES[case]
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k = rng.randn(b, hk, sk, d).astype(np.float32)
    v = rng.randn(b, hk, sk, d).astype(np.float32)
    g = rng.randn(b, h, sq, d).astype(np.float32)
    glse = rng.randn(b, h, sq).astype(np.float32)
    kw = {"causal": opt in ("causal_segments", "window", "positions")}
    if opt == "causal_segments":
        seg = np.zeros((b, sq), np.int32)
        seg[:, sq // 2:] = 1
        seg[-1, 3 * sq // 4:] = 2
        kw["segment_ids"] = seg
    if opt.startswith("key_segments"):
        kseg = (rng.rand(b, sk) < 0.3).astype(np.int32)
        kseg[:, 0] = 0                    # every row keeps a live key
        kw["kv_segment_ids"] = kseg
    if opt == "window":
        kw["window_size"] = 21
    if opt == "positions":
        kw["q_positions"] = np.arange(48, 48 + sq, dtype=np.int32)
        kw["kv_positions"] = np.arange(sk, dtype=np.int32)
    if opt.endswith("bias"):
        kw["bias"] = rng.randn(b, 1, 1, sk).astype(np.float32)
    if opt == "dropout":
        kw["dropout_rate"] = 0.1
    return dt, (q, k, v, g), kw, glse if opt == "positions" else None


def _wide_ref(qkvg, kw, jdt, impl, glse):
    q, k, v, g = (jnp.asarray(a).astype(jdt) for a in qkvg)
    jkw = {n: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()}
    if "bias" in jkw:
        jkw["bias"] = jkw["bias"].astype(jdt)
    if "dropout_rate" in jkw:
        jkw["dropout_rng"] = jax.random.PRNGKey(DROPOUT_KEY)

    def f(q_, k_, v_):
        return ref_flash(q_, k_, v_, impl=impl, return_lse=True, **jkw)

    (out, lse), vjp = jax.vjp(f, q, k, v)
    cot = jnp.zeros_like(lse) if glse is None else jnp.asarray(glse)
    grads = vjp((g, cot))
    return [np.asarray(t.astype(jnp.float32)) for t in (out, *grads)], \
        np.asarray(lse)


def _wide_port(qkvg, kw, tdt, glse):
    q, k, v, g = (torch.from_numpy(a).to(tdt) for a in qkvg)
    for t in (q, k, v):
        t.requires_grad_()
    tkw = {n: (torch.from_numpy(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()}
    if "bias" in tkw:
        tkw["bias"] = tkw["bias"].to(tdt)
    if "dropout_rate" in tkw:
        tkw["dropout_rng"] = np.asarray(jax.random.key_data(
            jax.random.PRNGKey(DROPOUT_KEY))).astype(np.uint32).ravel()
    out, lse = port.flash_attention(q, k, v, return_lse=True, **tkw)
    assert out.dtype == tdt
    if glse is None:
        out.backward(g)
    else:
        torch.autograd.backward([out, lse], [g, torch.from_numpy(glse)])
    return [t.detach().float().numpy() for t in (out, q.grad, k.grad,
                                                 v.grad)], lse.detach().numpy()


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("case", sorted(WIDE_CASES))
def test_wide_route_widths_match_reference(case, impl):
    """fp32 past 128 and any dtype past 256 take the wide route (no
    width raises any more): its plain versions, forward and vjp, against
    the reference's XLA path and its interpreted Pallas kernels."""
    dt, qkvg, kw, glse = _wide_case(case)
    jdt, tdt = DTYPES[dt]
    d = qkvg[0].shape[-1]
    assert port.wide_route(d, tdt) and port.kernel_width(d, tdt) == d
    port.check_head_dim(d, tdt)
    want, wlse = _wide_ref(qkvg, kw, jdt, impl, glse)
    got, glse_out = _wide_port(qkvg, kw, tdt, glse)
    for name, a, w in zip(("out", "dq", "dk", "dv"), got, want):
        scale = float(np.abs(w).max())
        err = float(np.abs(a - w).max())
        assert err <= RTOL[dt] * scale, (case, name, err, scale)
    np.testing.assert_allclose(glse_out, wlse, rtol=0, atol=1e-5)


def test_the_route_follows_width_and_dtype_alone():
    """The wgmma kernels keep every width they are built for; the wide
    route takes the rest, and head_dim 0 is the only width refused."""
    for dtype in (torch.bfloat16, torch.float16):
        for d in (1, 100, 129, 192, 256):
            assert not port.wide_route(d, dtype)
            assert port.kernel_width(d, dtype) == port.tma_width(d) <= 256
        for d in (257, 320, 512, 4096):
            assert port.wide_route(d, dtype)
    for d in (1, 64, 128):
        assert not port.wide_route(d, torch.float32)
    for d in (129, 160, 256, 512):
        assert port.wide_route(d, torch.float32)
        assert port.kernel_width(d, torch.float32) == d
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        port.check_head_dim(4096, dtype)
        with pytest.raises(ValueError, match="head_dim 0"):
            port.check_head_dim(0, dtype)
