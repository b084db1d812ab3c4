"""The bf16/fp16 flash forward's wrapper (``csrc/flash_fwd_sm90.cuh``: wgmma,
TMA) and the shapes it adds, against apex_tpu on the CPU.

The CUDA kernel reads heads padded with zero columns to ``tma_width`` (TMA's
16-byte row strides) and its wrapper cuts the output back: here the same
pad, the plain forward on the padded inputs and the cut, against the
reference's ``flash_attention`` with ``impl="xla"`` (its plain XLA path) on
the same numpy inputs. Then the plain forward at the two shapes whose blocks
the kernel gives one warpgroup: decode (sq 1, key-side segment ids, the
serving path's context mask) and the multi-head attention stacks' 64 tokens
with a (b, 1, 1, sk) key-padding bias. The kernel itself is held to the same
plain forward on the card (``tests/test_torch_kernels_cuda.py``,
``chip_smoke.py``).

Tolerances, those of ``test_torch_flash_dtypes.py``, relative to each
output's largest |value|: bf16 within 2^-6, two bf16 ulps; fp16 within
2^-9, two fp16 ulps (the reference rounds P to the input dtype before P.V,
the plain forward keeps it fp32). The fp32 log-sum-exp within 1e-5
absolute.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from apex_tpu.ops.attention import flash_attention as ref_flash

from apex_tpu_torch.ops import attention as port

RTOL = {"fp16": 2.0 ** -9, "bf16": 2.0 ** -6}
DTYPES = {"fp16": (jnp.float16, torch.float16),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(b, h, hk, sq, sk, d, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32)
            for shape in ((b, h, sq, d), (b, hk, sk, d), (b, hk, sk, d))]


def _ref(qkv, jdt, **kw):
    q, k, v = (jnp.asarray(a).astype(jdt) for a in qkv)
    kw = {n: jnp.asarray(a) if isinstance(a, np.ndarray) else a
          for n, a in kw.items()}
    out, lse = ref_flash(q, k, v, impl="xla", return_lse=True, **kw)
    return np.asarray(out.astype(jnp.float32)), np.asarray(lse)


def _check(got, want, dt):
    (out, lse), (wout, wlse) = got, want
    scale = float(np.abs(wout).max())
    err = float(np.abs(out - wout).max())
    assert err <= RTOL[dt] * scale, (err, scale)
    np.testing.assert_allclose(lse, wlse, rtol=0, atol=1e-5)


@pytest.mark.parametrize("d", [20, 40, 60, 72])
@pytest.mark.parametrize("dt", ["bf16", "fp16"])
def test_padded_heads_give_the_reference_forward(dt, d):
    """The wrapper's pad path: q, k and v padded to ``tma_width`` and the
    output cut again, through the plain forward (the scale of d passed),
    against the reference's forward at d (GQA 2:1, causal, ragged sk)."""
    jdt, tdt = DTYPES[dt]
    width = port.kernel_width(d, tdt)
    assert width == port.tma_width(d) and width % 8 == 0 and width >= 32
    qkv = _qkv(2, 4, 2, 80, 100, d, seed=d)
    q, k, v = (torch.from_numpy(a).to(tdt) for a in qkv)
    qp, kp, vp = port.pad_head_dim((q, k, v), width)
    assert all(t.shape[-1] == width for t in (qp, kp, vp))
    assert not qp[..., d:].float().abs().any()
    out, lse = port._attention_torch(qp, kp, vp, None, None, None, d ** -0.5,
                                     True, return_lse=True)
    assert not out[..., d:].float().abs().any()
    got = (out[..., :d].float().numpy(), lse.numpy())
    _check(got, _ref(qkv, jdt, causal=True), dt)


def test_pad_head_dim_leaves_fp32_and_full_widths():
    """Every dtype's kernels read TMA's width: bf16 and fp16 tensors are
    padded to it, fp32's split pass writes its planes at it (the fp32
    tensors keep d); a tensor already at the width passes as it is."""
    z = torch.zeros(1, 2, 8, 48)
    assert port.kernel_width(48, torch.float32) == 48
    assert port.kernel_width(20, torch.float32) == 32
    assert port._split3_torch(torch.ones(2, 20), 32).shape == (3, 2, 32)
    assert port.kernel_width(20, torch.bfloat16) == 32
    assert port.kernel_width(60, torch.float16) == 64
    same, none = port.pad_head_dim((z, None), 48)
    assert same is z and none is None
    (wide,) = port.pad_head_dim((z,), 64)
    assert wide.shape == (1, 2, 8, 64) and not wide.abs().any()


@pytest.mark.parametrize("dt", ["bf16", "fp16"])
def test_decode_with_key_segments_matches_reference(dt):
    """One query a sequence over 129 keys: the context's unwritten tail in
    segment 1, queries in segment 0 (key-side segment ids alone)."""
    jdt, tdt = DTYPES[dt]
    b, h, sk, d = 2, 4, 129, 64
    qkv = _qkv(b, h, h, 1, sk, d, seed=3)
    kv_seg = (np.arange(sk)[None, :] >= np.array([[100], [37]])).astype(
        np.int32)
    q, k, v = (torch.from_numpy(a).to(tdt) for a in qkv)
    out, lse = port.flash_attention(q, k, v,
                                    kv_segment_ids=torch.from_numpy(kv_seg),
                                    return_lse=True)
    assert out.shape == (b, h, 1, d) and out.dtype == tdt
    got = (out.float().numpy(), lse.numpy())
    _check(got, _ref(qkv, jdt, kv_segment_ids=kv_seg), dt)


@pytest.mark.parametrize("bias_dt", ["fp32", "same"])
@pytest.mark.parametrize("dt", ["bf16", "fp16"])
def test_sixty_four_tokens_with_key_padding_bias_match_reference(dt,
                                                                 bias_dt):
    """The multi-head attention stacks' shape: 64 tokens, a (b, 1, 1, sk)
    additive key-padding bias of -10000 past each sequence's length."""
    jdt, tdt = DTYPES[dt]
    b, h, s, d = 3, 4, 64, 64
    qkv = _qkv(b, h, h, s, s, d, seed=11)
    lens = np.array([64, 40, 33])
    bias = np.where(np.arange(s)[None, :] >= lens[:, None], -10000.0,
                    0.0).astype(np.float32).reshape(b, 1, 1, s)
    tb = torch.from_numpy(bias)
    jb = jnp.asarray(bias)
    if bias_dt == "same":
        tb, jb = tb.to(tdt), jb.astype(jdt)
    q, k, v = (torch.from_numpy(a).to(tdt) for a in qkv)
    out, lse = port.flash_attention(q, k, v, bias=tb, return_lse=True)
    got = (out.float().numpy(), lse.numpy())
    _check(got, _ref(qkv, jdt, bias=jb), dt)
