"""Dropout in apex_tpu_torch against the reference.

``ops/dropout.py`` against Flax's ``nn.Dropout`` (what the reference's
GPT and BERT call for hidden dropout and for the softmax backend's
probabilities): the output and the input gradient bitwise, in fp32 and
bf16, on the same key. Flax divides by the keep probability rounded to
the input's dtype (0.9 is 0.8984375 in bf16), in fp32, rounded once:
``bf16(3) / 0.9`` gives 3.34375 there, where PyTorch's bf16 ``x / 0.9``
(fp32 opmath with the exact 0.9) gives 3.328125; the port follows Flax.

The flash attention's plain forward and backward with dropout against
``apex_tpu.ops.attention.flash_attention(..., impl="interpret")`` (the
Pallas kernels run by the interpreter, blocks of 16 or 32): the outputs
within 2e-6 and the gradients within 5e-6 (fp32 sums in other orders),
and the keep masks bitwise. A mask is read off an output: with q = 0 the
probabilities are uniform, and with V the identity over d = sk keys
output column j is nonzero exactly where key j was kept. The mask hashes
the global query row and key column and the flat q-head index, not block
indices, so the reference's blocks of 16 and the port's whole-matrix
plain version (and the card's 64 x 64 tiles) give one mask.
"""

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp
from apex_tpu.ops.attention import _dropout_keep as ref_keep
from apex_tpu.ops.attention import flash_attention as ref_flash

from apex_tpu_torch.ops import attention as port_attention
from apex_tpu_torch.ops.dropout import dropout, dropout_plain

FWD_ATOL = 2e-6
BWD_ATOL = 5e-6
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _key_words(key):
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


def _to_torch(a, dt):
    return torch.from_numpy(np.array(a.astype(jnp.float32))).to(dt)


@pytest.mark.parametrize("dt", sorted(DTYPES))
@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("shape", [(8, 33), (4, 16, 32, 32), (2, 3, 1025)])
def test_dropout_is_flax_s_bitwise(dt, rate, shape):
    jdt, tdt = DTYPES[dt]
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(*shape).astype(np.float32) * 3).astype(jdt)
    g = jnp.asarray(rng.randn(*shape).astype(np.float32)).astype(jdt)
    key = jax.random.PRNGKey(7)
    layer = nn.Dropout(rate)

    def f(x):
        return layer.apply({}, x, deterministic=False, rng=key)

    want, vjp = jax.vjp(f, x)
    (want_dx,) = vjp(g)
    xt = _to_torch(x, tdt).requires_grad_()
    got = dropout(xt, rate, _key_words(key))
    got.backward(_to_torch(g, tdt))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    np.testing.assert_array_equal(xt.grad.float().numpy(),
                                  np.asarray(want_dx.astype(jnp.float32)))
    kept = float((got != 0).float().mean())
    assert abs(kept - (1 - rate)) < 0.05


def test_bf16_divides_by_the_rounded_keep_probability():
    x = jnp.full((4096,), 3.0, jnp.bfloat16)
    key = jax.random.PRNGKey(1)
    want = np.asarray(nn.Dropout(0.1).apply(
        {}, x, deterministic=False, rng=key).astype(jnp.float32))
    got = dropout(torch.full((4096,), 3.0, dtype=torch.bfloat16), 0.1,
                  _key_words(key)).float().numpy()
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == {0.0, 3.34375}
    # PyTorch's own bf16 division by 0.9 lands one bf16 value lower
    assert float(torch.tensor(3.0, dtype=torch.bfloat16) / 0.9) == 3.328125


def test_rate_edges_and_the_plain_yardstick():
    x = torch.randn(5, 7)
    assert dropout(x, 0.0, (0, 1)) is x
    assert (dropout(x, 1.0, (0, 1)) == 0).all()
    assert torch.equal(dropout(x, 0.3, (4, 9)), dropout_plain(x, 0.3, (4, 9)))
    with pytest.raises(ValueError, match="rate"):
        dropout(x, 1.5, (0, 1))
    with pytest.raises(ValueError, match="two uint32 words"):
        dropout(x, 0.3, (1, 2, 3))


def test_no_grad_call_skips_autograd():
    x = torch.randn(6, 6, requires_grad=True)
    with torch.no_grad():
        y = dropout(x, 0.2, (3, 3))
    assert y.grad_fn is None
    y = dropout(x, 0.2, (3, 3))
    assert "DropoutFn" in type(y.grad_fn).__name__


# -- flash attention with dropout ---------------------------------------------

FLASH_CASES = {
    # b, h, hk, sq, sk, d, causal, window, segments
    "causal": (2, 4, 4, 64, 64, 32, True, None, False),
    "gqa": (2, 4, 2, 48, 48, 32, True, None, False),
    "mqa_offset": (1, 4, 1, 32, 80, 32, True, None, False),
    "segments": (2, 4, 4, 48, 48, 32, False, None, True),
    "window": (1, 2, 2, 64, 64, 32, True, 20, False),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_with_dropout_matches_interpret(case):
    b, h, hk, sq, sk, d, causal, window, segs = FLASH_CASES[case]
    rng = np.random.RandomState(3)
    q = rng.randn(b, h, sq, d).astype(np.float32)
    k, v = (rng.randn(b, hk, sk, d).astype(np.float32) for _ in range(2))
    g = rng.randn(b, h, sq, d).astype(np.float32)
    seg = (rng.rand(b, sq) < 0.6).astype(np.int32) if segs else None
    key = jax.random.PRNGKey(9)
    kw = dict(causal=causal, window_size=window, dropout_rate=0.1)

    def f(q, k, v):
        o = ref_flash(q, k, v, dropout_rng=key, impl="interpret",
                      segment_ids=None if seg is None else jnp.asarray(seg),
                      block_q=16, block_k=16, **kw)
        return jnp.sum(o * g), o

    (_, want), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                          has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    got = port_attention.flash_attention(
        qt, kt, vt, dropout_rng=_key_words(key),
        segment_ids=None if seg is None else torch.from_numpy(seg), **kw)
    assert "FlashFn" in type(got.grad_fn).__name__
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=FWD_ATOL)
    for t, w in zip((qt, kt, vt), grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=0,
                                   atol=BWD_ATOL)


def _mask_probe(b, h, sq, sk):
    """q = 0 (uniform probabilities) and V the identity over sk keys."""
    q = np.zeros((b, h, sq, sk), np.float32)
    k = np.random.RandomState(4).randn(b, h, sk, sk).astype(np.float32)
    v = np.broadcast_to(np.eye(sk, dtype=np.float32), (b, h, sk, sk)).copy()
    return q, k, v


@pytest.mark.parametrize("rate", [0.1, 0.3])
def test_flash_dropout_masks_bitwise(rate):
    b, h, sq, sk = 2, 3, 96, 32
    q, k, v = _mask_probe(b, h, sq, sk)
    key = jax.random.PRNGKey(12)
    want = np.asarray(ref_flash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), dropout_rate=rate,
        dropout_rng=key, impl="interpret", block_q=16, block_k=16))
    got = port_attention.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        dropout_rate=rate, dropout_rng=_key_words(key)).numpy()
    np.testing.assert_array_equal(got != 0, want != 0)
    # and it is the counter hash of global indices, row-major heads
    kd = _key_words(key)
    seed = int(kd[0] ^ kd[1])
    bh = np.arange(b * h).reshape(b, h, 1, 1)
    row = np.arange(sq).reshape(sq, 1)
    col = np.arange(sk).reshape(1, sk)
    np.testing.assert_array_equal(
        got != 0, np.asarray(ref_keep(jnp.uint32(seed), bh, row, col, rate)))
    kept = float((got != 0).mean())
    assert abs(kept - (1 - rate)) < 0.02


def test_dropout_seed_folds_a_key_as_the_reference():
    key = jax.random.PRNGKey(77)
    kd = _key_words(key)
    want = int(kd[0]) ^ int(kd[1])
    assert port_attention.dropout_seed(kd) == want
    assert port_attention.dropout_seed(torch.from_numpy(kd)) == want
    assert port_attention.dropout_seed(tuple(kd.tolist())) == want
    assert port_attention.dropout_seed(123) == 123
    assert port_attention.dropout_seed(np.array([5], np.uint32)) == 5
