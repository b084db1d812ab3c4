"""apex_tpu_torch GPT against apex_tpu GPT on converted weights.

A tiny fp32 config (the one tests/test_serving.py uses: 2 layers, 4
heads over 2 kv heads, width 32) is initialised in flax, its params are
converted with ``load_jax_params``, and the same tokens go through both
models: the full forward, the ``return_kv`` prefill, the ``kv_ctx``
single-token decode path and the chunked-prefill path (``s > 1`` over
``[ctx | chunk]``), for both flax layer layouts and both attention
backends (``"softmax"``: GQA by repeated kv heads, the causal fused
softmax; the serving hooks run flash attention under either). The
reference runs its XLA paths. Tolerances: logits within 1e-4 absolute (fp32 products and
reductions in other orders, through 2 layers and a 64-way LM head); the
``return_kv`` K/V within 1e-5 (one fp32 projection of the same inputs).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from apex_tpu.models.gpt import GPTConfig as RefConfig
from apex_tpu.models.gpt import GPTModel as RefModel

from apex_tpu_torch.models import (
    GPTConfig,
    GPTModel,
    gpt_params_from_jax,
    load_jax_params,
)

VOCAB, SEQ, HID, LAYERS, HEADS, KV = 64, 64, 32, 2, 4, 2
LOGIT_ATOL = 1e-4
KV_ATOL = 1e-5


def ref_config(**kw):
    base = dict(vocab_size=VOCAB, max_seq_len=SEQ, hidden_size=HID,
                num_layers=LAYERS, num_heads=HEADS, num_kv_heads=KV,
                dtype=jnp.float32, param_dtype=jnp.float32,
                softmax_impl="xla")
    base.update(kw)
    return RefConfig(**base)


def port_config(**kw):
    return GPTConfig(vocab_size=VOCAB, max_seq_len=SEQ, hidden_size=HID,
                     num_layers=LAYERS, num_heads=HEADS, num_kv_heads=KV,
                     dtype=torch.float32, param_dtype=torch.float32, **kw)


@pytest.fixture(scope="module",
                params=[(True, "flash"), (False, "flash"),
                        (True, "softmax"), (False, "softmax")],
                ids=["scan", "unrolled", "scan-softmax", "unrolled-softmax"])
def pair(request):
    scan, backend = request.param
    ref = RefModel(ref_config(scan_layers=scan, attention_backend=backend))
    toks = jnp.asarray(np.random.RandomState(0).randint(0, VOCAB, (1, 8)),
                       jnp.int32)
    params = ref.init(jax.random.PRNGKey(0), toks)
    params_np = jax.tree_util.tree_map(np.asarray, params)
    port = load_jax_params(
        GPTModel(port_config(attention_backend=backend), device="cpu"),
        params_np)
    return ref, params, port


def _tokens(b, s, seed):
    return np.random.RandomState(seed).randint(0, VOCAB, (b, s)).astype(
        np.int32)


def test_full_forward_and_return_kv(pair):
    ref, params, port = pair
    toks = _tokens(2, 12, 1)
    want, (wk, wv) = ref.apply(params, jnp.asarray(toks), return_kv=True)
    with torch.no_grad():
        got, (gk, gv) = port(torch.from_numpy(toks).long(), return_kv=True)
    assert got.shape == (12, 2, VOCAB)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_ATOL)
    assert gk.shape == (LAYERS, 2, KV, 12, HID // HEADS)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), rtol=0,
                               atol=KV_ATOL)
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), rtol=0,
                               atol=KV_ATOL)


def _ctx(b, L, written, seed):
    """A cache context (num_layers, b, kv, L, d) and its mask: random
    rows past each lane's written prefix stand for stale cache slots."""
    rng = np.random.RandomState(seed)
    k = rng.randn(LAYERS, b, KV, L, HID // HEADS).astype(np.float32)
    v = rng.randn(LAYERS, b, KV, L, HID // HEADS).astype(np.float32)
    mask = np.arange(L)[None, :] < np.asarray(written)[:, None]
    return k, v, mask


@pytest.mark.parametrize("s", [1, 5], ids=["decode", "chunk"])
def test_kv_ctx_paths(pair, s):
    ref, params, port = pair
    b, L = 2, 12
    written = [9, 4]
    k, v, mask = _ctx(b, L, written, seed=2)
    toks = _tokens(b, s, 3)
    pos = (np.asarray(written)[:, None] + np.arange(s)[None, :]).astype(
        np.int32)
    want, (wk, _) = ref.apply(
        params, jnp.asarray(toks), positions=jnp.asarray(pos),
        kv_ctx=(jnp.asarray(k), jnp.asarray(v)), ctx_mask=jnp.asarray(mask),
        return_kv=True)
    with torch.no_grad():
        got, (gk, _) = port(
            torch.from_numpy(toks).long(), positions=torch.from_numpy(pos),
            kv_ctx=(torch.from_numpy(k), torch.from_numpy(v)),
            ctx_mask=torch.from_numpy(mask), return_kv=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(gk.numpy(), np.asarray(wk), rtol=0,
                               atol=KV_ATOL)


def test_forward_plain_equals_forward_on_cpu(pair):
    _, _, port = pair
    toks = torch.from_numpy(_tokens(2, 10, 4)).long()
    with torch.no_grad():
        a = port(toks)
        b = port.forward_plain(toks)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_converter_rejects_missing_and_extra_keys(pair):
    ref, params, _ = pair
    params_np = jax.tree_util.tree_map(np.asarray, params)
    tree = dict(params_np["params"])
    dropped = dict(tree)
    dropped.pop("final_norm")
    with pytest.raises(KeyError, match="final_norm"):
        gpt_params_from_jax(dropped, port_config())
    tree["stray"] = {"kernel": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match="stray"):
        gpt_params_from_jax(tree, port_config())


def test_converter_bf16_leaves_cross_as_bits(pair):
    ref, params, _ = pair
    bf = jax.tree_util.tree_map(
        lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)), params)
    state = gpt_params_from_jax(bf, port_config())
    w = state["layers.1.attention.qkv.weight"]
    assert w.dtype == torch.bfloat16
    want = np.asarray(bf["params"]["layers"]["layer"]["attention"]["qkv"]
                      ["kernel"][1] if "layers" in bf["params"] else
                      bf["params"]["layer_1"]["attention"]["qkv"]["kernel"])
    np.testing.assert_array_equal(w.float().numpy(), want.astype(np.float32))


def test_unported_config_options_raise():
    with pytest.raises(NotImplementedError, match="ring"):
        GPTConfig(attention_backend="ring")
    # the reference's rule: a sliding window needs the flash backend
    with pytest.raises(ValueError, match="attention_window"):
        GPTConfig(attention_backend="softmax", attention_window=4)
    with pytest.raises(ValueError, match="attention_backend"):
        GPTConfig(attention_backend="dense")
    with pytest.raises(NotImplementedError, match="MoE"):
        GPTConfig(num_experts=4)
