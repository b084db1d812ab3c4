"""How the masked softmax kernel reads its mask, and T5's cross-attention
mask on the plain path against apex_tpu.

``ops.softmax.mask_layout`` turns a (b or 1, 1, sq or 1, sk) mask into the
kernel's arguments: a bool tensor whose keys lie at unit stride and two
strides, the batch's and the query's, 0 where the mask broadcasts. The
kernel reads score row r of x (b, h, sq, sk) at mask + (r / (h * sq)) *
batch_stride + (r % sq) * query_stride; here that read is made on the
host over the tensor's storage and held bitwise against the mask
broadcast to x's shape. Only a mask broadcast along the keys (or strided
there) is copied.

T5's cross attention passes its (b, 1, 1, s_enc) key mask to
``FusedScaleMaskSoftmax`` as ``apex_tpu/models/t5.py:172-175`` does: the
port's plain path against the reference's XLA path and its Pallas kernel
in interpret mode, forward and backward, at fp32 (outputs within 2e-6 of
each row's largest |value|, gradients within 1e-4, floored at 1e-3: exp
and fp32 sums in other orders) and bf16 (one bf16 ulp of the value, 2^-7;
gradients within 2^-6 of each row's largest |value|: both round the
cotangent's products and dx once on either side).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from apex_tpu.transformer.functional import AttnMaskType as RefMaskType
from apex_tpu.transformer.functional import (
    FusedScaleMaskSoftmax as RefFused,
)

from apex_tpu_torch.ops import softmax
from apex_tpu_torch.transformer.functional import (
    AttnMaskType,
    FusedScaleMaskSoftmax,
)

B, H, SQ, SK = 3, 2, 5, 24


def _kernel_rows(x_shape, mask, bstride, qstride) -> torch.Tensor:
    """Every score row's mask as the kernel reads it, from the storage."""
    b, h, sq, sk = x_shape
    raw = torch.frombuffer(bytearray(bytes(mask.untyped_storage())),
                           dtype=torch.uint8)
    base = mask.storage_offset()
    rows = []
    for r in range(b * h * sq):
        start = base + (r // (h * sq)) * bstride + (r % sq) * qstride
        rows.append(raw[start:start + sk] != 0)
    return torch.stack(rows).reshape(b, h, sq, sk)


def _random_mask(shape, seed, dtype=torch.bool):
    m = np.random.RandomState(seed).rand(*shape) < 0.4
    return torch.from_numpy(m).to(dtype)


# name: (mask shape, expected (batch stride, query stride), copied)
LAYOUTS = {
    "keys_b11k": ((B, 1, 1, SK), (SK, 0), False),
    "queries_11qk": ((1, 1, SQ, SK), (0, SK), False),
    "full_b1qk": ((B, 1, SQ, SK), (SQ * SK, SK), False),
    "one_row_111k": ((1, 1, 1, SK), (0, 0), False),
    "keys_broadcast_b1q1": ((B, 1, SQ, 1), (SQ * SK, SK), True),
}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
@pytest.mark.parametrize("dtype", [torch.bool, torch.int32, torch.float32],
                         ids=str)
def test_mask_layout_reads_each_row_as_broadcast(name, dtype):
    shape, strides, copied = LAYOUTS[name]
    x = torch.zeros(B, H, SQ, SK)
    mask = _random_mask(shape, len(name), dtype)
    got, bs, qs = softmax.mask_layout(x, mask)
    assert got.dtype == torch.bool
    assert (bs, qs) == strides
    if dtype == torch.bool:
        # the caller's tensor, not a copy, unless the keys broadcast
        assert (got.data_ptr() == mask.data_ptr()) == (not copied)
    want = (mask != 0).expand(B, H, SQ, SK)
    assert torch.equal(_kernel_rows(x.shape, got, bs, qs), want)


@pytest.mark.parametrize("mask_shape", [(B, 1, 1, SK), (1, 1, SQ, SK)])
def test_expanded_view_keeps_its_strides(mask_shape):
    """``_masked_args`` hands the kernel an expanded view of the caller's
    mask: its strides are 0 where it broadcasts, and nothing is copied."""
    x = torch.zeros(B, H, SQ, SK)
    mask = _random_mask(mask_shape, 7)
    view = softmax._masked_args(x, mask)
    assert view.shape == (mask_shape[0], 1, SQ, SK)
    got, bs, qs = softmax.mask_layout(x, view)
    assert got.data_ptr() == mask.data_ptr()
    assert (bs, qs) == ((SK, 0) if mask_shape[0] == B else (0, SK))
    assert torch.equal(_kernel_rows(x.shape, got, bs, qs),
                       mask.expand(B, H, SQ, SK))


def test_strided_keys_are_copied_to_unit_stride():
    x = torch.zeros(B, H, SQ, SK)
    mask = _random_mask((B, 1, SK, SQ), 3).transpose(2, 3)   # (B, 1, SQ, SK)
    got, bs, qs = softmax.mask_layout(x, mask)
    assert got.stride(3) == 1 and got.data_ptr() != mask.data_ptr()
    assert torch.equal(_kernel_rows(x.shape, got, bs, qs),
                       mask.expand(B, H, SQ, SK))


@pytest.mark.parametrize("x_shape,mask_shape", [
    ((B, H, SQ, SK), (2, 1, SQ, SK)),       # a batch neither 1 nor b
    ((B, H, SQ, SK), (B, H, SQ, SK)),       # a mask per head
    ((B, H, SQ, SK), (B, 1, 2, SK)),        # queries neither 1 nor sq
    ((B, H, SQ, SK), (B, 1, SQ, 3)),        # keys neither 1 nor sk
    ((B, H, SQ, SK), (B, SQ, SK)),          # not 4-D
    ((H, SQ, SK), (1, 1, SQ, SK)),          # x not 4-D
])
def test_mask_layout_refuses_other_shapes(x_shape, mask_shape):
    with pytest.raises(ValueError, match="mask|expected"):
        softmax.mask_layout(torch.zeros(x_shape),
                            torch.zeros(mask_shape, dtype=torch.bool))


def _row_rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    row = np.maximum(np.abs(b).max(axis=-1, keepdims=True), 1e-3)
    return float((np.abs(a - b) / row).max())


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_t5_cross_mask_plain_path_matches_reference(impl, dt):
    """T5-like cross scores (b, h, 8 decoder queries, 32 encoder keys)
    under the (b, 1, 1, s_enc) key mask, called as the T5 layer calls the
    dispatcher."""
    b, h, sq, sk = 2, 3, 8, 32
    rng = np.random.RandomState(11)
    x = (3.0 * rng.randn(b, h, sq, sk)).astype(np.float32)
    g = rng.randn(b, h, sq, sk).astype(np.float32)
    lens = np.array([sk, 19])
    keep = np.arange(sk)[None, :] < lens[:, None]
    cross = (keep.astype(np.float32) < 0.5)[:, None, None, :]
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    ref = RefFused(attn_mask_type=RefMaskType.padding, impl=impl)
    y_ref, vjp = jax.vjp(lambda a: ref(a, mask=jnp.asarray(cross)),
                         jnp.asarray(x).astype(jdt))
    (dx_ref,) = vjp(jnp.asarray(g).astype(y_ref.dtype))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    y = FusedScaleMaskSoftmax(attn_mask_type=AttnMaskType.padding)(
        xt, torch.from_numpy(cross))
    assert y.dtype == tdt
    y.backward(torch.from_numpy(g).to(tdt))
    y_ref = np.asarray(y_ref.astype(jnp.float32))
    dx_ref = np.asarray(dx_ref.astype(jnp.float32))
    y, dx = y.detach().float().numpy(), xt.grad.float().numpy()
    if dt == "fp32":
        assert _row_rel(y, y_ref) <= 2e-6
        assert _row_rel(dx, dx_ref) <= 1e-4
    else:
        excess = np.abs(y - y_ref) - 2.0 ** -7 * np.maximum(np.abs(y),
                                                            np.abs(y_ref))
        assert float(excess.max()) <= 0.0
        assert _row_rel(dx, dx_ref) <= 2.0 ** -6
    # masked keys take exp(-10000 + ...) = 0 in every row
    assert np.all(y[1][..., 19:] == 0.0)
