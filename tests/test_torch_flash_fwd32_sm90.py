"""The fp32 flash forward of apex_tpu_torch against apex_tpu, and the planes
its kernel hands the backward.

On the card the fp32 forward runs ``csrc/flash_fwd32_sm90.cuh`` (wgmma,
TMA, exact products from three bf16 parts a value) on the bf16 part planes
of q, k and v that the split pass writes, and a differentiated call hands
those planes to the fp32 backward (``csrc/flash_bwd32_sm90.cuh``), which
then splits dO alone. Here, on the CPU, the port runs the plain versions
those kernels are held against (``_attention_torch``, ``_flash_bwd_torch``,
``_split3_torch``; the kernels against them: ``chip_smoke.py`` and
``tests/test_torch_kernels_cuda.py``).

The reference is ``flash_attention`` with ``impl="xla"`` (its plain XLA
path) on the same numpy inputs: head widths 20, 60, 100 and 128 (none a
built width but 128), causal with GQA 2:1 over 128 tokens, and non-causal
over 64 tokens with a (b, 1, 1, sk) key-padding bias (the multi-head
attention stacks' shape); single-token decode over key-side segment ids
(the serving path's context mask); dropout 0.1 and 0.4 with the reference's
counter-based mask on both sides. Outputs within 1e-5 of their largest
|value| (fp32 products and sums in other orders), the lse within 1e-5
absolute. The planes: summed back, bitwise q, k and v, so the backward that
reads them differentiates the inputs themselves; its gradients on them
against ``jax.vjp`` within 1e-5 of each one's largest |value|. Planes handed
to the forward are checked as the backward's are.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from apex_tpu.ops.attention import flash_attention as ref_flash

from apex_tpu_torch.ops import attention as port

RTOL = 1e-5
LSE_ATOL = 1e-5
# name: (b, h, hk, s, causal, key-padding bias)
CASES = {"causal_gqa": (2, 4, 2, 128, True, False),
         "mha_bias": (2, 4, 4, 64, False, True)}


def _inputs(case, d, seed=0):
    b, h, hk, s, causal, padded = CASES[case]
    rng = np.random.RandomState(seed + d)
    qkv = [rng.randn(*shape).astype(np.float32)
           for shape in ((b, h, s, d), (b, hk, s, d), (b, hk, s, d))]
    kw = {"causal": causal}
    if padded:
        # the last keys of each sequence padded away, as the stacks' mask
        bias = np.zeros((b, 1, 1, s), np.float32)
        bias[0, ..., 50:] = -10000.0
        bias[1, ..., 37:] = -10000.0
        kw["bias"] = bias
    return qkv, kw


def _jax_kw(kw):
    return {n: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
            for n, a in kw.items()}


def _torch_kw(kw):
    return {n: (torch.from_numpy(a) if isinstance(a, np.ndarray) else a)
            for n, a in kw.items()}


def _ref(qkv, kw):
    out, lse = ref_flash(*(jnp.asarray(a) for a in qkv), impl="xla",
                         return_lse=True, **_jax_kw(kw))
    return np.asarray(out), np.asarray(lse)


def _check(got, want):
    (out, lse), (wout, wlse) = got, want
    assert out.shape == wout.shape and np.isfinite(out).all()
    scale = float(np.abs(wout).max())
    err = float(np.abs(out - wout).max())
    assert err <= RTOL * scale, (err, scale)
    np.testing.assert_allclose(lse, wlse, rtol=0, atol=LSE_ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("d", [20, 60, 100, 128])
def test_fp32_forward_matches_reference(d, case):
    qkv, kw = _inputs(case, d)
    out, lse = port.flash_attention(*(torch.from_numpy(a) for a in qkv),
                                    return_lse=True, **_torch_kw(kw))
    assert out.dtype == torch.float32 and lse.dtype == torch.float32
    _check((out.numpy(), lse.numpy()), _ref(qkv, kw))


@pytest.mark.parametrize("d", [20, 64])
def test_fp32_decode_with_key_segments_matches_reference(d):
    """One query a sequence over 129 keys: the context's unwritten tail in
    segment 1, queries in segment 0 (key-side segment ids alone)."""
    b, h, sk = 2, 4, 129
    rng = np.random.RandomState(d)
    qkv = [rng.randn(*shape).astype(np.float32)
           for shape in ((b, h, 1, d), (b, h, sk, d), (b, h, sk, d))]
    kv_seg = (np.arange(sk)[None, :] >= np.array([[100], [37]])).astype(
        np.int32)
    out, lse = port.flash_attention(*(torch.from_numpy(a) for a in qkv),
                                    kv_segment_ids=torch.from_numpy(kv_seg),
                                    return_lse=True)
    assert out.shape == (b, h, 1, d)
    _check((out.numpy(), lse.numpy()), _ref(qkv, {"kv_segment_ids": kv_seg}))


@pytest.mark.parametrize("rate", [0.1, 0.4])
def test_fp32_dropout_matches_reference(rate):
    """The reference's counter-based keep mask on both sides (the key's two
    words xor-ed into the seed): the kept probabilities divided by 1 -
    rate, the lse of the undropped ones."""
    qkv, kw = _inputs("causal_gqa", 64, seed=9)
    key = jax.random.PRNGKey(11)
    words = np.asarray(jax.random.key_data(key)).astype(np.uint32).ravel()
    want = ref_flash(*(jnp.asarray(a) for a in qkv), impl="xla",
                     return_lse=True, dropout_rate=rate, dropout_rng=key,
                     **_jax_kw(kw))
    got = port.flash_attention(*(torch.from_numpy(a) for a in qkv),
                               return_lse=True, dropout_rate=rate,
                               dropout_rng=torch.from_numpy(
                                   words.astype(np.int64)),
                               **_torch_kw(kw))
    _check(tuple(t.numpy() for t in got), tuple(np.asarray(t) for t in want))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("d", [20, 100, 128])
def test_backward_on_the_forwards_planes_matches_reference(d, case):
    """The planes the forward's kernel reads (q, k and v split at
    ``tma_width(d)``), summed back in fp32, are the inputs bitwise: the fp32
    backward that takes them from the forward reads exactly q, k and v.
    Autograd's plain backward on the summed-back tensors against
    ``jax.vjp`` of the reference on the inputs."""
    qkv, kw = _inputs(case, d, seed=4)
    width = port.tma_width(d)
    back = []
    for a in qkv:
        planes = port._split3_torch(torch.from_numpy(a), width)
        assert planes.shape == (3, *a.shape[:-1], width)
        assert not planes[..., d:].float().any()
        x = (planes[0].float() + planes[1].float() + planes[2].float())
        x = x[..., :d].contiguous()
        assert np.array_equal(x.numpy().view(np.uint32), a.view(np.uint32))
        back.append(x.requires_grad_())
    rng = np.random.RandomState(d + 1)
    g = rng.randn(*qkv[0].shape).astype(np.float32)

    def f(q_, k_, v_):
        return ref_flash(q_, k_, v_, impl="xla", **_jax_kw(kw))

    _, vjp = jax.vjp(f, *(jnp.asarray(a) for a in qkv))
    want = [np.asarray(t) for t in vjp(jnp.asarray(g))]
    out = port.flash_attention(*back, **_torch_kw(kw))
    out.backward(torch.from_numpy(g))
    for name, x, w in zip(("dq", "dk", "dv"), back, want):
        got = x.grad.numpy()
        assert got.shape == w.shape and np.isfinite(got).all(), name
        scale = float(np.abs(w).max())
        assert float(np.abs(got - w).max()) <= RTOL * scale, name


@pytest.mark.parametrize("kind", ["ok", "dtype", "width", "rows", "count"])
def test_forward_planes_are_checked(kind):
    """Planes handed to the forward (``_flash_cuda(..., planes=)``) must be
    what the split pass gives for q, k and v at ``tma_width(d)``: one
    contiguous bf16 (3, ..., width) tensor each; anything else raises."""
    rng = np.random.RandomState(5)
    ts = [torch.from_numpy(rng.randn(2, 2, 17, 20).astype(np.float32))
          for _ in range(3)]
    width = port.kernel_width(20, torch.float32)
    assert width == port.tma_width(20) == 32
    planes = [port._split3_torch(t, width) for t in ts]
    if kind == "ok":
        port._check_planes(planes, ts, width)
        return
    spoilt = {"dtype": lambda p: p.float(),
              "width": lambda p: torch.nn.functional.pad(p, (0, 8)),
              "rows": lambda p: p[:, :, :, :-1].contiguous()}
    bad = planes[:-1] if kind == "count" else [spoilt[kind](planes[0]),
                                                *planes[1:]]
    with pytest.raises((TypeError, ValueError)):
        port._check_planes(bad, ts, width)
