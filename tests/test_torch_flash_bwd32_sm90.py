"""The fp32 flash backward of apex_tpu_torch against apex_tpu, and the
plain version of its split pass.

On the card the fp32 backward runs ``csrc/flash_bwd32_sm90.cuh`` (wgmma,
TMA, exact products from three bf16 parts a value) on the bf16 part planes
that the split pass writes; here, on the CPU, the port runs the plain
versions those kernels are held against (``_flash_bwd_torch`` and
``_split3_torch``; the kernels against them: ``chip_smoke.py`` and
``tests/test_torch_kernels_cuda.py``).

``jax.vjp`` of the reference's ``flash_attention`` with ``impl="xla"`` (its
plain XLA path) against the port's autograd, which runs the plain
backward on CPU tensors, on the same numpy inputs and cotangent: head
widths 20, 60, 100 and 128 (none of them a built width but 128), causal
with GQA 2:1 over 128 tokens, and non-causal over 64 tokens with a (b, 1,
1, sk) key-padding bias (the multi-head attention stacks' shape). Every
output and gradient within 1e-5 of its largest |value| (fp32 products and
sums in other orders on the two sides), the lse within 1e-5 absolute.

The split pass: the parts of normal values sum back to x bitwise (hi +
mid + lo, in fp32), the padded columns are zero, and on normal values,
subnormals, signed zeros and infinities the parts are those of the rule
``split3`` (``csrc/flash_common.cuh``) states, computed here in numpy
with a round-to-nearest-even of its own. Planes handed to the backward
instead of made by it are checked for count, dtype, shape and layout.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from apex_tpu.ops.attention import flash_attention as ref_flash

from apex_tpu_torch.ops import attention as port

RTOL = 1e-5
# name: (b, h, hk, s, causal, key-padding bias)
CASES = {"causal": (1, 4, 2, 128, True, False),
         "mha_bias": (2, 4, 4, 64, False, True)}


def _inputs(case, d, seed=0):
    b, h, hk, s, causal, padded = CASES[case]
    rng = np.random.RandomState(seed + d)
    q = rng.randn(b, h, s, d).astype(np.float32)
    k = rng.randn(b, hk, s, d).astype(np.float32)
    v = rng.randn(b, hk, s, d).astype(np.float32)
    g = rng.randn(b, h, s, d).astype(np.float32)
    kw = {"causal": causal}
    if padded:
        # the last keys of each sequence padded away, as the stacks' mask
        bias = np.zeros((b, 1, 1, s), np.float32)
        bias[0, ..., 50:] = -10000.0
        bias[1, ..., 37:] = -10000.0
        kw["bias"] = bias
    return (q, k, v, g), kw


def _ref(qkvg, kw):
    q, k, v, g = (jnp.asarray(a) for a in qkvg)
    jkw = {n: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()}

    def f(q_, k_, v_):
        return ref_flash(q_, k_, v_, impl="xla", return_lse=True, **jkw)

    (out, lse), vjp = jax.vjp(f, q, k, v)
    grads = vjp((g, jnp.zeros_like(lse)))
    return [np.asarray(t) for t in (out, *grads)], np.asarray(lse)


def _port(qkvg, kw):
    q, k, v, g = (torch.from_numpy(a) for a in qkvg)
    for t in (q, k, v):
        t.requires_grad_()
    tkw = {n: (torch.from_numpy(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()}
    out, lse = port.flash_attention(q, k, v, return_lse=True, **tkw)
    assert out.dtype == torch.float32
    out.backward(g)
    return [t.detach().numpy() for t in (out, q.grad, k.grad, v.grad)], \
        lse.detach().numpy()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("d", [20, 60, 100, 128])
def test_fp32_backward_matches_reference(d, case):
    qkvg, kw = _inputs(case, d)
    want, wlse = _ref(qkvg, kw)
    got, glse = _port(qkvg, kw)
    for name, a, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.shape == w.shape and np.isfinite(a).all(), name
        scale = float(np.abs(w).max())
        err = float(np.abs(a - w).max())
        assert err <= RTOL * scale, (name, err, scale)
    np.testing.assert_allclose(glse, wlse, rtol=0, atol=1e-5)


def _bf16_rn(x: np.ndarray) -> np.ndarray:
    """fp32 values rounded to the nearest bf16 (ties to even), as fp32: the
    top 16 bits after adding 0x7FFF plus the lowest kept bit; NaN stays
    NaN, a finite value past bf16's largest rounds to inf."""
    u = x.view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    return np.where(np.isnan(x), np.float32(np.nan), r.view(np.float32))


def _rule(x: np.ndarray):
    """The parts ``split3`` states: hi = rn(x), mid = rn(x - hi), lo =
    rn((x - hi) - mid), each difference in fp32."""
    with np.errstate(invalid="ignore"):
        hi = _bf16_rn(x)
        r = (x - hi).astype(np.float32)
        mid = _bf16_rn(r)
        lo = _bf16_rn((r - mid).astype(np.float32))
    return hi, mid, lo


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    """Equal bit patterns (the sign of 0 included), any NaN equal to any
    other."""
    nan = np.isnan(a)
    return bool((nan == np.isnan(b)).all()
                and (a.view(np.uint32)[~nan] == b.view(np.uint32)[~nan])
                .all())


@pytest.mark.parametrize("d", [20, 64, 100])
def test_split_parts_sum_back_and_pad_with_zeros(d):
    rng = np.random.RandomState(d)
    x = (rng.randn(2, 3, 17, d) * np.exp(rng.uniform(-20, 20, (2, 3, 17, d)))
         ).astype(np.float32)
    width = port.tma_width(d)
    planes = port._split3_torch(torch.from_numpy(x), width)
    assert planes.dtype == torch.bfloat16
    assert planes.shape == (3, 2, 3, 17, width)
    parts = planes.float().numpy()
    assert not parts[..., d:].any()
    hi, mid, lo = (parts[j, ..., :d] for j in range(3))
    assert _same_bits((hi + mid + lo).astype(np.float32), x)
    # each part at most half an ulp of bf16 below the one before
    assert (np.abs(mid) <= np.abs(hi) * 2.0 ** -8).all()
    assert (np.abs(lo) <= np.abs(mid) * 2.0 ** -8).all()


SPECIALS = {
    "normal": lambda rng: (rng.randn(4096) * 1e3).astype(np.float32),
    "subnormal": lambda rng: (rng.uniform(-1, 1, 4096) * 2.0 ** -126
                              ).astype(np.float32),
    "signed_zero": lambda rng: np.array([0.0, -0.0] * 8, np.float32),
    "infinity": lambda rng: np.array([np.inf, -np.inf, 1.0, -2.5],
                                     np.float32),
}


@pytest.mark.parametrize("kind", sorted(SPECIALS))
def test_split_follows_the_split3_rule(kind):
    x = SPECIALS[kind](np.random.RandomState(7))
    planes = port._split3_torch(torch.from_numpy(x), 8 * -(-x.size // 8))
    got = planes.float().numpy()[:, :x.size]
    for j, want in enumerate(_rule(x)):
        assert _same_bits(got[j], want), (kind, j)
    if kind == "subnormal":
        # bf16 keeps fp32's exponent range: subnormals split, not flush
        assert (got[0] != 0).any()


def _bad_planes(planes, kind):
    """``planes`` spoilt one way: another dtype, width, batch or layout,
    or one plane missing."""
    p = planes[0]
    spoilt = {"dtype": lambda: p.float(),
              "width": lambda: torch.nn.functional.pad(p, (0, 8)),
              "rows": lambda: p[:, :, :, :-1].contiguous(),
              "layout": lambda: p.transpose(3, 4).contiguous().transpose(
                  3, 4)}
    if kind == "count":
        return planes[:-1]
    return [spoilt[kind](), *planes[1:]]


@pytest.mark.parametrize("kind", ["ok", "dtype", "width", "rows",
                                  "layout", "count"])
def test_given_planes_are_checked(kind):
    """Planes handed to the backward (``_flash_bwd_cuda(..., planes=)``)
    must be what the split pass gives for q, k, v and dO at
    ``tma_width(d)``; anything else raises before a tensor map is made."""
    rng = np.random.RandomState(3)
    ts = [torch.from_numpy(rng.randn(2, 2, 17, 20).astype(np.float32))
          for _ in range(4)]
    width = port.tma_width(20)
    planes = [port._split3_torch(t, width) for t in ts]
    if kind == "ok":
        port._check_planes(planes, ts, width)
        return
    with pytest.raises((TypeError, ValueError)):
        port._check_planes(_bad_planes(planes, kind), ts, width)
