"""apex_tpu_torch.contrib.multihead_attn against apex_tpu's.

The reference module is initialised from a key, its parameters cross
through ``multihead_attn_params_from_jax`` into the port's module, and
the same numpy inputs, masks, dropout key and output cotangent go
through both: the output, the input's gradient and every parameter's
gradient are compared. The reference runs ``impl="default"`` (its XLA
path) and ``"interpret"`` (its Pallas kernels in interpret mode); the
port runs the same ``impl``, which on CPU tensors is the plain path
either way (``attention_plain``, or ``flash_attention``'s plain version
and ``_FlashFn``'s plain backward).

Tolerances, in fp32: outputs within 2e-5 absolute, gradients within
2e-5 of each one's largest |value| — fp32 products, softmax and
LayerNorm with sums in other orders. A projection bias is held against
the larger of its own and its weight's gradient: the key bias's true
gradient is exactly 0, and both sides read fp32 noise there.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from apex_tpu.contrib.multihead_attn import (
    EncdecMultiheadAttn as RefEncdec,
    SelfMultiheadAttn as RefSelf,
)

from apex_tpu_torch.contrib.multihead_attn import (
    EncdecMultiheadAttn,
    SelfMultiheadAttn,
)
from apex_tpu_torch.models import multihead_attn_params_from_jax

ATOL = 2e-5
GRAD_RTOL = 2e-5
S, SK, B, E, H = 12, 10, 3, 32, 4

# name: (module kwargs, masks)
CASES = {
    "plain": (dict(), ()),
    "norm_add_bias": (dict(include_norm_add=True, bias=True), ()),
    "separate_qkv": (dict(separate_qkv_params=True, bias=True), ()),
    "bool_padding": (dict(bias=True), ("padding",)),
    "additive_padding": (dict(mask_additive=True, include_norm_add=True),
                         ("padding",)),
    "future": (dict(include_norm_add=True, bias=True), ("future",)),
    "both_masks": (dict(mask_additive=True, bias=True),
                   ("padding", "future")),
    "dropout": (dict(dropout=0.3, include_norm_add=True, bias=True,
                     mask_additive=True), ("padding", "future")),
}


def _masks(kind, names, sq, sk, additive, rng):
    lens = rng.randint(sk // 2, sk + 1, size=B)
    pad = np.arange(sk)[None, :] >= lens[:, None]
    kpm = None
    if "padding" in names:
        kpm = (np.where(pad, -10000.0, 0.0).astype(np.float32) if additive
               else pad)
    am = None
    if "future" in names:
        # query i sees keys up to i: every row keeps key 0, never padded
        # (a row with every key masked by -10000 would compare fp32
        # roundings of scores near -1e4, not the attention)
        am = np.triu(np.ones((sq, sk), bool), k=1)
    return kpm, am


def _run(case, impl, encdec):
    kw, names = CASES[case]
    if encdec:
        kw = {k: v for k, v in kw.items() if k != "separate_qkv_params"}
    rng = np.random.RandomState(sorted(CASES).index(case) + 100 * encdec)
    sk = SK if encdec else S
    x = rng.randn(S, B, E).astype(np.float32)
    mem = rng.randn(sk, B, E).astype(np.float32)
    g = rng.randn(S, B, E).astype(np.float32)
    kpm, am = _masks(case, names, S, sk, kw.get("mask_additive", False), rng)
    ref_impl = {"xla": "default", "interpret": "interpret"}[impl]
    ref_mod = (RefEncdec if encdec else RefSelf)(
        embed_dim=E, num_heads=H, impl=ref_impl, **kw)
    inputs = (x, mem) if encdec else (x,)
    params = ref_mod.init(jax.random.PRNGKey(1),
                          *(jnp.asarray(a) for a in inputs),
                          is_training=False)
    # LayerNorm's scale and bias away from 1 and 0, so that a swap shows
    params = jax.tree_util.tree_map(
        lambda p: p + 0.05 * jnp.asarray(
            np.random.RandomState(p.size).randn(*p.shape), p.dtype), params)
    key = jax.random.PRNGKey(7)
    jkw = dict(key_padding_mask=None if kpm is None else jnp.asarray(kpm),
               attn_mask=None if am is None else jnp.asarray(am))

    def loss(p, *ins):
        out, _ = ref_mod.apply(p, *ins, **jkw, is_training=True,
                               rngs={"dropout": key})
        return jnp.sum(out * jnp.asarray(g)), out
    (_, want_out), want = jax.value_and_grad(
        loss, argnums=tuple(range(len(inputs) + 1)), has_aux=True)(
        params, *(jnp.asarray(a) for a in inputs))

    port_impl = {"xla": "default", "interpret": "fast"}[impl]
    mod = (EncdecMultiheadAttn if encdec else SelfMultiheadAttn)(
        E, H, impl=port_impl, device="cpu", **kw)
    state = multihead_attn_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params))
    mod.load_state_dict(state, strict=True)
    leaves = [torch.from_numpy(a).requires_grad_() for a in inputs]
    out, none = mod(*leaves,
                    key_padding_mask=None if kpm is None
                    else torch.from_numpy(kpm),
                    attn_mask=None if am is None else torch.from_numpy(am),
                    is_training=True,
                    dropout_key=np.asarray(jax.random.key_data(key)))
    assert none is None
    out.backward(torch.from_numpy(g))
    return want_out, want, out, leaves, mod


def _check(want_out, want, out, leaves, mod):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               rtol=0, atol=ATOL)
    ref_grads = multihead_attn_params_from_jax(
        jax.tree_util.tree_map(np.asarray, want[0]))
    got = {n: p.grad for n, p in mod.named_parameters()}
    assert set(got) == set(ref_grads)
    pairs = [(n, got[n].numpy(), ref_grads[n].numpy()) for n in got]
    pairs += [(f"input {i}", t.grad.numpy(), np.asarray(w))
              for i, (t, w) in enumerate(zip(leaves, want[1:]))]
    for name, a, b in pairs:
        scale = max(float(np.abs(b).max()), 1e-6)
        if name.endswith("_proj.bias"):
            # the key projection's bias adds a constant along each score
            # row: its true gradient is exactly 0, read as fp32 noise on
            # both sides, so it is held against its weight's gradient
            weight = ref_grads[name.replace(".bias", ".weight")].numpy()
            scale = max(scale, float(np.abs(weight).max()))
        err = float(np.abs(a - b).max())
        assert err <= GRAD_RTOL * scale, (name, err, scale)


@pytest.mark.parametrize("case", sorted(CASES))
def test_self_multihead_attn_matches_reference(impl, case):
    _check(*_run(case, impl, encdec=False))


@pytest.mark.parametrize("case", ["norm_add_bias", "bool_padding",
                                  "additive_padding", "both_masks",
                                  "dropout"])
def test_encdec_multihead_attn_matches_reference(impl, case):
    _check(*_run(case, impl, encdec=True))


def test_dropout_is_applied_and_keyed():
    mod = SelfMultiheadAttn(E, H, dropout=0.5, device="cpu",
                            generator=torch.Generator().manual_seed(0))
    x = torch.randn(S, B, E)
    a, _ = mod(x, dropout_key=(1, 2))
    b, _ = mod(x, dropout_key=(1, 2))
    c, _ = mod(x, dropout_key=(1, 3))
    d, _ = mod(x, is_training=False)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, d)
    with pytest.raises(ValueError, match="dropout_key"):
        mod(x)


def test_bad_impl_and_unknown_parameters_raise():
    with pytest.raises(ValueError, match="impl"):
        SelfMultiheadAttn(E, H, impl="xla", device="cpu")
    with pytest.raises(KeyError, match="unexpected"):
        multihead_attn_params_from_jax({"params": {"attn": {"kernel": 0}}})
