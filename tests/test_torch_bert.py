"""apex_tpu_torch BERT against apex_tpu BERT on converted weights.

A tiny fp32 BERT (vocab 128, hidden 64, 2 layers, 4 heads, seq 32,
batch 3 with padded tails) is initialised in flax in both layer layouts
(``scan_layers`` True and False), converted with ``load_jax_params``,
and the same tokens, keep-mask and tokentypes go through both models
under both attention backends: the LM and binary logits, the extended
attention mask, the loss with and without NSP, a config without the
binary head, and every parameter's gradient of the loss (``jax.grad``
against autograd). The reference runs its XLA paths; the port its plain
versions on CPU tensors.

Tolerances: logits within 1e-4 absolute (fp32 products and reductions in
other orders through 2 layers and a 128-way tied head; the same bound as
the GPT test); the loss within 1e-5; each gradient within 1e-4 of its
parameter's largest |value| (floored at 1e-6), except the key bias,
whose true gradient is exactly zero (a per-row shift of the scores):
held within 1e-6 absolute.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from apex_tpu.models.bert import BertConfig as RefConfig
from apex_tpu.models.bert import BertModel as RefModel
from apex_tpu.models.bert import bert_extended_attention_mask as ref_mask
from apex_tpu.models.bert import bert_loss_fn as ref_loss

from apex_tpu_torch.models import (
    BertConfig,
    BertModel,
    bert_extended_attention_mask,
    bert_loss_fn,
    bert_params_from_jax,
    load_jax_params,
)

VOCAB, SEQ, HID, LAYERS, HEADS, BATCH = 128, 32, 64, 2, 4, 3
LENS = (32, 20, 9)
LOGIT_ATOL = 1e-4
LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-4


def ref_config(**kw):
    base = dict(vocab_size=VOCAB, max_seq_len=SEQ, hidden_size=HID,
                num_layers=LAYERS, num_heads=HEADS, dtype=jnp.float32,
                param_dtype=jnp.float32, softmax_impl="xla")
    base.update(kw)
    return RefConfig(**base)


def port_config(**kw):
    base = dict(vocab_size=VOCAB, max_seq_len=SEQ, hidden_size=HID,
                num_layers=LAYERS, num_heads=HEADS, dtype=torch.float32,
                param_dtype=torch.float32)
    base.update(kw)
    return BertConfig(**base)


def batch(seed=0):
    """tokens, keep-mask, tokentypes, MLM labels, loss mask (real tokens
    only), NSP labels; (b, s) numpy arrays, pads after each length."""
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, VOCAB, (BATCH, SEQ)).astype(np.int32)
    keep = (np.arange(SEQ)[None, :] < np.asarray(LENS)[:, None])
    tt = (np.arange(SEQ)[None, :] >= np.asarray(LENS)[:, None] // 2)
    labels = rng.randint(0, VOCAB, (BATCH, SEQ)).astype(np.int32)
    loss_mask = (keep & (rng.rand(BATCH, SEQ) < 0.3)).astype(np.float32)
    nsp = rng.randint(0, 2, (BATCH,)).astype(np.int32)
    return (tokens, keep.astype(np.int32), (tt & keep).astype(np.int32),
            labels, loss_mask, nsp)


def _ref_params(scan, **kw):
    toks, keep = batch()[:2]
    model = RefModel(ref_config(scan_layers=scan, **kw))
    return model, model.init(jax.random.PRNGKey(0), jnp.asarray(toks),
                             jnp.asarray(keep))


@pytest.fixture(scope="module", params=[True, False],
                ids=["scan", "unrolled"])
def params(request):
    return _ref_params(request.param)[1]


def _pair(params, backend, **kw):
    scan = "layers" in params["params"]
    ref = RefModel(ref_config(attention_backend=backend, scan_layers=scan,
                              **kw))
    port = load_jax_params(
        BertModel(port_config(attention_backend=backend, **kw),
                  device="cpu"),
        jax.tree_util.tree_map(np.asarray, params))
    return ref, port


@pytest.mark.parametrize("backend", ["softmax", "flash"])
def test_forward_matches_reference(params, backend):
    ref, port = _pair(params, backend)
    toks, keep, tt = batch()[:3]
    want_lm, want_bin = ref.apply(params, jnp.asarray(toks),
                                  jnp.asarray(keep), jnp.asarray(tt))
    with torch.no_grad():
        lm, binary = port(torch.from_numpy(toks), torch.from_numpy(keep),
                          torch.from_numpy(tt))
        plain_lm, plain_bin = port.forward_plain(
            torch.from_numpy(toks), torch.from_numpy(keep),
            torch.from_numpy(tt))
    assert lm.shape == (SEQ, BATCH, VOCAB) and lm.dtype == torch.float32
    np.testing.assert_allclose(lm.numpy(), np.asarray(want_lm), rtol=0,
                               atol=LOGIT_ATOL)
    np.testing.assert_allclose(binary.numpy(), np.asarray(want_bin),
                               rtol=0, atol=LOGIT_ATOL)
    torch.testing.assert_close(plain_lm, lm, rtol=0, atol=0)
    torch.testing.assert_close(plain_bin, binary, rtol=0, atol=0)


def test_extended_attention_mask_matches_reference():
    keep = batch()[1]
    want = np.asarray(ref_mask(jnp.asarray(keep)))
    got = bert_extended_attention_mask(torch.from_numpy(keep)).numpy()
    assert got.shape == (BATCH, 1, SEQ, SEQ) and got.dtype == np.bool_
    np.testing.assert_array_equal(got, want)


def test_no_tokentypes_and_no_binary_head():
    _, params = _ref_params(False, add_binary_head=False)
    ref, port = _pair(params, "softmax", add_binary_head=False)
    toks, keep = batch()[:2]
    want_lm, want_bin = ref.apply(params, jnp.asarray(toks),
                                  jnp.asarray(keep))
    with torch.no_grad():
        lm, binary = port(torch.from_numpy(toks), torch.from_numpy(keep))
    assert want_bin is None and binary is None
    np.testing.assert_allclose(lm.numpy(), np.asarray(want_lm), rtol=0,
                               atol=LOGIT_ATOL)


@pytest.mark.parametrize("nsp", [True, False], ids=["nsp", "mlm_only"])
def test_loss_matches_reference(nsp):
    rng = np.random.RandomState(3)
    lm = rng.randn(SEQ, BATCH, VOCAB).astype(np.float32)
    binary = rng.randn(BATCH, 2).astype(np.float32)
    _, _, _, labels, loss_mask, nsp_labels = batch()
    want = ref_loss(jnp.asarray(lm), jnp.asarray(binary),
                    jnp.asarray(labels), jnp.asarray(loss_mask),
                    jnp.asarray(nsp_labels) if nsp else None)
    got = bert_loss_fn(torch.from_numpy(lm), torch.from_numpy(binary),
                       torch.from_numpy(labels), torch.from_numpy(loss_mask),
                       torch.from_numpy(nsp_labels) if nsp else None)
    assert abs(float(got) - float(want)) <= LOSS_ATOL


def _key_bias(name):
    """True on the key slots of a fused qkv bias ([q | k | v] per head)."""
    mask = torch.zeros(HEADS, 3, HID // HEADS, dtype=torch.bool)
    mask[:, 1] = True
    return mask.reshape(-1) if name.endswith("qkv.bias") else None


@pytest.mark.parametrize("backend", ["softmax", "flash"])
def test_gradients_match_jax_grad(params, backend):
    ref, port = _pair(params, backend)
    toks, keep, tt, labels, loss_mask, nsp = batch(1)

    def loss_of(p):
        lm, binary = ref.apply(p, jnp.asarray(toks), jnp.asarray(keep),
                               jnp.asarray(tt))
        return ref_loss(lm, binary, jnp.asarray(labels),
                        jnp.asarray(loss_mask), jnp.asarray(nsp))

    want_loss, grads = jax.value_and_grad(loss_of)(params)
    want = bert_params_from_jax(jax.tree_util.tree_map(np.asarray, grads),
                                port.config)
    loss = bert_loss_fn(*port(toks, keep, tt), torch.from_numpy(labels),
                        torch.from_numpy(loss_mask), torch.from_numpy(nsp))
    loss.backward()
    assert abs(float(loss.detach()) - float(want_loss)) <= LOSS_ATOL
    got = dict(port.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name].grad
        assert g is not None, name
        diff = (g - w).abs()
        key = _key_bias(name)
        if key is not None:
            assert float(diff[key].max()) <= 1e-6, name
            diff, w = diff[~key], w[~key]
        scale = max(float(w.abs().max()), 1e-6)
        assert float(diff.max()) <= GRAD_RTOL * scale, (
            name, float(diff.max()), scale)


def test_backends_agree_on_real_rows(params):
    """Real query rows see only real keys under both backends, and pad
    positions are outside the loss and the pooler: same loss."""
    _, soft = _pair(params, "softmax")
    _, flash = _pair(params, "flash")
    toks, keep, tt, labels, loss_mask, nsp = batch(2)
    with torch.no_grad():
        a = bert_loss_fn(*soft(toks, keep, tt), torch.from_numpy(labels),
                         torch.from_numpy(loss_mask), torch.from_numpy(nsp))
        b = bert_loss_fn(*flash(toks, keep, tt), torch.from_numpy(labels),
                         torch.from_numpy(loss_mask), torch.from_numpy(nsp))
        lm_a, _ = soft(toks, keep, tt)
        lm_b, _ = flash(toks, keep, tt)
    assert abs(float(a) - float(b)) <= LOSS_ATOL
    real = torch.from_numpy(keep.T.astype(bool))        # (s, b)
    torch.testing.assert_close(lm_a[real], lm_b[real], rtol=0,
                               atol=LOGIT_ATOL)
    # pad rows differ: the softmax backend's see every key, shifted
    assert float((lm_a[~real] - lm_b[~real]).abs().max()) > LOGIT_ATOL


def test_converter_rejects_missing_and_extra_keys(params):
    tree = dict(jax.tree_util.tree_map(np.asarray, params)["params"])
    dropped = dict(tree)
    dropped.pop("pooler")
    with pytest.raises(KeyError, match="pooler"):
        bert_params_from_jax(dropped, port_config())
    tree["mlp"] = {"kernel": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match="mlp"):
        bert_params_from_jax(tree, port_config())


def test_config_checks():
    with pytest.raises(ValueError, match="attention_backend"):
        BertConfig(attention_backend="ring")
    # dropout is ported (tests/test_torch_pretrain_dropout.py): rates in
    # [0, 1) are taken, others refused
    for kw in ({"attention_dropout": 0.1}, {"hidden_dropout": 0.1}):
        assert BertConfig(**kw).scan_layers
    for kw in ({"attention_dropout": 1.0}, {"hidden_dropout": -0.1}):
        with pytest.raises(ValueError, match="dropout"):
            BertConfig(**kw)
    cfg = BertConfig.bert_large()
    assert (cfg.hidden_size, cfg.num_layers, cfg.num_heads, cfg.max_seq_len,
            cfg.vocab_size, cfg.attention_backend) == (
                1024, 24, 16, 512, 30528, "softmax")
