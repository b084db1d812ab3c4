"""Flash attention of apex_tpu_torch against apex_tpu in fp16 and fp32,
and at head widths between the built ones (48, 96).

``jax.vjp`` of the reference's ``flash_attention`` with ``impl=
"interpret"`` (its Pallas forward and backward kernels, interpreted on the
CPU) against the port's forward and autograd on the same numpy inputs and
cotangent. The port runs its plain versions on CPU tensors
(``_attention_torch``, ``_flash_bwd_torch``): the versions the CUDA
kernels are held against on the card (``chip_smoke.py``,
``tests/test_torch_kernels_cuda.py``), whatever the dtype and head width.

Tolerances, relative to each output's (and gradient's) largest |value|:
fp32 within 1e-5 (fp32 products and sums in other orders, blockwise on
the interpret side); fp16 within 2^-9, two fp16 ulps of the largest value
(the reference rounds P to fp16 before P.V, the plain forward keeps it
fp32; both round dS to fp16 before its products, where fp32 values that
differ in their last bits may round to neighbouring fp16 values); bf16
within 2^-6, two bf16 ulps, as in ``test_torch_attention_bwd.py``. The
fp32 log-sum-exp within 1e-5 absolute.
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

# name: (dtype, b, h, hk, sq, sk, d, causal, extra)
CASES = {
    "fp32_causal": ("fp32", 1, 2, 2, 32, 32, 64, True, None),
    "fp32_gqa_offset": ("fp32", 1, 4, 2, 16, 40, 32, True, None),
    "fp32_d48": ("fp32", 1, 2, 2, 32, 32, 48, True, None),
    "fp32_d96_segments": ("fp32", 2, 2, 2, 24, 24, 96, False, "segments"),
    "fp16_causal": ("fp16", 1, 2, 2, 32, 32, 64, True, None),
    "fp16_d96": ("fp16", 1, 2, 1, 32, 32, 96, True, None),
    "fp16_d48_window": ("fp16", 1, 2, 2, 40, 40, 48, True, "window"),
    "fp16_bias": ("fp16", 2, 2, 2, 16, 24, 32, False, "bias"),
    "bf16_d96": ("bf16", 1, 2, 2, 32, 32, 96, True, None),
    "bf16_d48": ("bf16", 1, 2, 2, 32, 32, 48, False, None),
}


def _inputs(case, seed=0):
    dt, b, h, hk, sq, sk, d, causal, extra = CASES[case]
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k = rng.randn(b, hk, sk, d).astype(np.float32)
    v = rng.randn(b, hk, sk, d).astype(np.float32)
    g = rng.randn(b, h, sq, d).astype(np.float32)
    kw = {"causal": causal}
    if extra == "window":
        kw["window_size"] = 9
    elif extra == "segments":
        seg = np.zeros((b, sq), np.int32)
        seg[:, sq // 2:] = 1
        kw.update(segment_ids=seg, kv_segment_ids=seg.copy())
    elif extra == "bias":
        kw["bias"] = rng.randn(b, 1, 1, sk).astype(np.float32)
    return dt, (q, k, v, g), kw


def _ref(qkvg, kw, jdt):
    q, k, v, g = (jnp.asarray(a).astype(jdt) for a in qkvg)
    jkw = {n: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()}
    if "bias" in jkw:
        jkw["bias"] = jkw["bias"].astype(jdt)

    def f(q_, k_, v_):
        return ref_flash(q_, k_, v_, impl="interpret", return_lse=True,
                         **jkw)

    (out, lse), vjp = jax.vjp(f, q, k, v)
    grads = vjp((g, jnp.zeros_like(lse)))
    return [np.asarray(t.astype(jnp.float32)) for t in (out, *grads)], \
        np.asarray(lse)


def _port(qkvg, kw, tdt):
    q, k, v, g = (torch.from_numpy(a).to(tdt) for a in qkvg)
    for t in (q, k, v):
        t.requires_grad_()
    tkw = {n: (torch.from_numpy(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()}
    if "bias" in tkw:
        tkw["bias"] = tkw["bias"].to(tdt)
    out, lse = port.flash_attention(q, k, v, return_lse=True, **tkw)
    assert out.dtype == tdt
    out.backward(g)
    return [t.detach().float().numpy() for t in (out, q.grad, k.grad,
                                                 v.grad)], lse.detach().numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_matches_reference_in_its_dtype(case):
    dt, qkvg, kw = _inputs(case)
    jdt, tdt = DTYPES[dt]
    want, wlse = _ref(qkvg, kw, jdt)
    got, glse = _port(qkvg, kw, tdt)
    for name, a, w in zip(("out", "dq", "dk", "dv"), got, want):
        scale = float(np.abs(w).max())
        err = float(np.abs(a - w).max())
        assert err <= RTOL[dt] * scale, (case, name, err, scale)
    np.testing.assert_allclose(glse, wlse, rtol=0, atol=1e-5)


def test_head_widths_pad_to_the_built_ones():
    """The wgmma kernels' width for each head_dim: the next built one, up
    to 256 (128 in fp32); wider heads take the wide route, at their own
    width."""
    assert port.BUILT_WIDTHS == (32, 64, 96, 128, 256)
    want = {1: 32, 17: 32, 32: 32, 33: 64, 48: 64, 64: 64, 65: 96, 96: 96,
            97: 128, 128: 128, 129: 256, 160: 256, 256: 256}
    for d, w in want.items():
        assert min(x for x in port.BUILT_WIDTHS if x >= d) == w
    assert port.MAX_HEAD_DIM == 256 and port.FP32_MAX_HEAD_DIM == 128
    for dtype, d in ((torch.float32, 129), (torch.bfloat16, 257),
                     (torch.float16, 300)):
        assert port.wide_route(d, dtype) and port.kernel_width(d, dtype) == d


@pytest.mark.parametrize("dtype,suffix", [(torch.bfloat16, ""),
                                          (torch.float16, "_fp16"),
                                          (torch.float32, "_fp32")])
def test_launch_counters_are_kept_per_dtype(dtype, suffix):
    for base in (port.KERNEL, port.BWD_DQ_KERNEL, port.BWD_DKV_KERNEL):
        assert port.kernel_name(base, dtype) == base + suffix
    assert port.DTYPE_CODES[dtype] == {torch.float32: 0, torch.bfloat16: 1,
                                       torch.float16: 2}[dtype]


def test_kernel_args_take_every_dtype_and_refuse_the_rest():
    """The checks the wrappers run before a launch, on CPU tensors of a
    fake device: fp16, fp32 and every head width pass (the wgmma kernels'
    to 128 in fp32 and to 256 in fp16 and bf16, the wide route's past
    them: fp32 160, fp16 257); a mixed dtype, an integer tensor and head_dim
    0 raise."""
    def z(d=64, dtype=torch.float16):
        return torch.zeros(1, 2, 8, d, dtype=dtype)
    for dtype in (torch.float16, torch.float32, torch.bfloat16):
        for d in (8, 48, 96, 128):
            port._check_kernel_args(z(d, dtype), z(d, dtype), z(d, dtype),
                                    None, None)
    for dtype in (torch.float16, torch.bfloat16):
        for d in (160, 256):
            port._check_kernel_args(z(d, dtype), z(d, dtype), z(d, dtype),
                                    None, None)
    f32 = torch.float32
    port._check_kernel_args(z(160, f32), z(160, f32), z(160, f32), None,
                            None)
    port._check_kernel_args(z(257), z(257), z(257), None, None)
    with pytest.raises(ValueError, match="head_dim 0"):
        port._check_kernel_args(z(0), z(0), z(0), None, None)
    with pytest.raises(TypeError):
        port._check_kernel_args(z(), z(dtype=torch.float32), z(), None,
                                None)
    with pytest.raises(TypeError):
        port._check_kernel_args(z(dtype=torch.int32), z(dtype=torch.int32),
                                z(dtype=torch.int32), None, None)
    bias = torch.zeros(1, 1, 8, 8, dtype=torch.float16)
    args = port._extra_args(z(), bias, None, None)
    assert args[3] == 2 and args[4:] == (0, 0, 8, 1)
