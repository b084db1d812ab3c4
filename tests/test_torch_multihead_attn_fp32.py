"""Contrib multi-head attention at its fp32 default with ``impl="fast"``,
at head widths between the flash kernels' built ones: apex_tpu_torch
against apex_tpu.

The modules default to ``dtype=float32``, as the reference's do; on the
card ``impl="fast"`` now runs the flash kernels in fp32 at any head_dim
up to 128 (before, fp32 and widths other than 32, 64 and 128 raised).
Here the reference's ``impl="interpret"`` (its Pallas kernels in
interpret mode) against the port's ``"fast"`` (on CPU tensors the flash
op's plain version and ``_FlashFn``'s plain backward), self and
encoder-decoder attention at head_dim 48 and 96, with the additive
key-padding mask and dropout 0.1 of the perf test.

Tolerances, as ``test_torch_multihead_attn.py``: outputs within 2e-5
absolute, gradients within 2e-5 of each one's largest |value| (fp32
products, softmax and LayerNorm with sums in other orders); a
projection bias against the larger of its own and its weight's gradient
(the key bias's true gradient is exactly 0).
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
S, SK, B = 10, 12, 2


@pytest.mark.parametrize("encdec", [False, True], ids=["self", "encdec"])
@pytest.mark.parametrize("embed,heads", [(96, 2), (192, 2)],
                         ids=["d48", "d96"])
def test_fp32_fast_matches_reference(encdec, embed, heads):
    kw = dict(dropout=0.1, bias=True, include_norm_add=True,
              mask_additive=True)
    rng = np.random.RandomState(embed + encdec)
    sk = SK if encdec else S
    x = rng.randn(S, B, embed).astype(np.float32)
    mem = rng.randn(sk, B, embed).astype(np.float32)
    g = rng.randn(S, B, embed).astype(np.float32)
    lens = np.array([sk, sk // 2 + 1])
    kpm = np.where(np.arange(sk)[None, :] >= lens[:, None], -10000.0,
                   0.0).astype(np.float32)
    inputs = (x, mem) if encdec else (x,)
    ref_mod = (RefEncdec if encdec else RefSelf)(
        embed_dim=embed, num_heads=heads, impl="interpret", **kw)
    params = ref_mod.init(jax.random.PRNGKey(1),
                          *(jnp.asarray(a) for a in inputs),
                          is_training=False)
    key = jax.random.PRNGKey(7)

    def loss(p, *ins):
        out, _ = ref_mod.apply(p, *ins, key_padding_mask=jnp.asarray(kpm),
                               is_training=True, rngs={"dropout": key})
        return jnp.sum(out * jnp.asarray(g)), out

    (_, want_out), want = jax.value_and_grad(
        loss, argnums=tuple(range(len(inputs) + 1)), has_aux=True)(
        params, *(jnp.asarray(a) for a in inputs))

    mod = (EncdecMultiheadAttn if encdec else SelfMultiheadAttn)(
        embed, heads, impl="fast", device="cpu", **kw)
    mod.load_state_dict(multihead_attn_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    leaves = [torch.from_numpy(a).requires_grad_() for a in inputs]
    out, _ = mod(*leaves, key_padding_mask=torch.from_numpy(kpm),
                 is_training=True,
                 dropout_key=np.asarray(jax.random.key_data(key)))
    assert out.dtype == torch.float32
    out.backward(torch.from_numpy(g))

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
            weight = ref_grads[name.replace(".bias", ".weight")].numpy()
            scale = max(scale, float(np.abs(weight).max()))
        err = float(np.abs(a - b).max())
        assert err <= GRAD_RTOL * scale, (name, err, scale)
