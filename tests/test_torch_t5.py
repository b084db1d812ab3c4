"""apex_tpu_torch T5 against apex_tpu T5 on converted weights.

A tiny T5 (vocab 96, hidden 64, 2 encoder and 2 decoder layers, 4 heads
of 16, 24 encoder and 12 decoder tokens, batch 3 with padded encoder
tails) is initialised in flax in both layer layouts (``scan_layers`` True
and False), converted with ``load_jax_params``, and the same tokens and
keep-mask go through both models under both attention backends. The
reference runs its XLA softmax path (``softmax_impl="xla"``) and, on the
flash backend, its Pallas kernels interpreted on the CPU
(``softmax_impl="interpret"``); the port its plain versions on CPU
tensors (the kernels are held against those on the card by
``chip_smoke.py``). Covered: forward logits in fp32 and bf16, the loss
and every parameter's gradient, encoder-padding invariance, decoder
causality, the two backends agreeing, ``encoder_decoder_stage_layout``
and its errors, the backend check and the converter's key checks.

Tolerances: fp32 logits within 1e-4 absolute (fp32 products and sums in
other orders through four layers and a 96-way tied head; BERT's and
GPT's bound); the loss within 1e-5; each gradient within 1e-4 of its
parameter's largest |value| (floored at 1e-6), except the key bias of
self attention and of cross attention, whose true gradient is exactly
zero (a per-row shift of the scores), held within 1e-6 absolute. bf16
logits within 2^-5 of their largest |value|: the two frameworks round
activations to bf16 at other points (~2^-8 each) through twelve rounded
ops a layer, and the tied head multiplies them into the logits.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from apex_tpu.models.t5 import T5Config as RefConfig
from apex_tpu.models.t5 import T5Model as RefModel
from apex_tpu.models.t5 import encoder_decoder_stage_layout as ref_layout
from apex_tpu.models.t5 import t5_loss_fn as ref_loss

from apex_tpu_torch.models import (
    T5Config,
    T5Model,
    encoder_decoder_stage_layout,
    load_jax_params,
    t5_loss_fn,
    t5_params_from_jax,
)
from apex_tpu_torch.transformer.enums import (
    AttnMaskType,
    AttnType,
    LayerType,
    ModelType,
)
from apex_tpu_torch.transformer.testing.standalone_t5 import (
    t5_model_provider,
)

VOCAB, SEQ, HID, LAYERS, HEADS, BATCH = 96, 32, 64, 2, 4, 3
S_ENC, S_DEC = 24, 12
LENS = (24, 17, 9)
LOGIT_ATOL = 1e-4
BF16_LOGIT_REL = 2.0 ** -5
LOSS_ATOL = 1e-5
GRAD_RTOL = 1e-4
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def ref_config(backend="softmax", dt="fp32", **kw):
    base = dict(vocab_size=VOCAB, max_seq_len=SEQ, hidden_size=HID,
                num_encoder_layers=LAYERS, num_decoder_layers=LAYERS,
                num_heads=HEADS, dtype=DTYPES[dt][0],
                param_dtype=jnp.float32, attention_backend=backend,
                softmax_impl="interpret" if backend == "flash" else "xla")
    base.update(kw)
    return RefConfig(**base)


def port_config(backend="softmax", dt="fp32"):
    return T5Config(vocab_size=VOCAB, max_seq_len=SEQ, hidden_size=HID,
                    num_encoder_layers=LAYERS, num_decoder_layers=LAYERS,
                    num_heads=HEADS, dtype=DTYPES[dt][1],
                    attention_backend=backend)


def batch(seed=0):
    """encoder tokens, keep-mask (pads after each length), decoder
    tokens, labels, loss mask; (b, s) numpy arrays."""
    rng = np.random.RandomState(seed)
    enc = rng.randint(0, VOCAB, (BATCH, S_ENC)).astype(np.int32)
    keep = (np.arange(S_ENC)[None, :] < np.asarray(LENS)[:, None])
    dec = rng.randint(0, VOCAB, (BATCH, S_DEC + 1)).astype(np.int32)
    loss_mask = (rng.rand(BATCH, S_DEC) < 0.8).astype(np.float32)
    return enc, keep.astype(np.int32), dec[:, :-1], dec[:, 1:], loss_mask


def _ref_params(scan):
    enc, keep, dec = batch()[:3]
    model = RefModel(ref_config(scan_layers=scan))
    return model.init(jax.random.PRNGKey(0), jnp.asarray(enc),
                      jnp.asarray(keep), jnp.asarray(dec))


@pytest.fixture(scope="module", params=[True, False],
                ids=["scan", "unrolled"])
def params(request):
    return _ref_params(request.param)


def _pair(params, backend, dt="fp32"):
    scan = "encoder_layers" in params["params"]
    ref = RefModel(ref_config(backend, dt, scan_layers=scan))
    port = load_jax_params(T5Model(port_config(backend, dt), device="cpu"),
                           jax.tree_util.tree_map(np.asarray, params))
    return ref, port


def _run(port, enc, keep, dec, plain=False):
    fwd = port.forward_plain if plain else port
    with torch.no_grad():
        return fwd(torch.from_numpy(enc), torch.from_numpy(keep),
                   torch.from_numpy(dec))


@pytest.mark.parametrize("backend", ["softmax", "flash"])
def test_forward_matches_reference(params, backend):
    ref, port = _pair(params, backend)
    enc, keep, dec = batch()[:3]
    want = np.asarray(ref.apply(params, jnp.asarray(enc), jnp.asarray(keep),
                                jnp.asarray(dec)))
    got = _run(port, enc, keep, dec)
    assert got.shape == (S_DEC, BATCH, VOCAB) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_ATOL)
    torch.testing.assert_close(_run(port, enc, keep, dec, plain=True), got,
                               rtol=0, atol=0)


@pytest.mark.parametrize("backend", ["softmax", "flash"])
def test_bf16_forward_matches_reference(params, backend):
    ref, port = _pair(params, backend, "bf16")
    enc, keep, dec = batch(4)[:3]
    want = np.asarray(ref.apply(params, jnp.asarray(enc), jnp.asarray(keep),
                                jnp.asarray(dec)))
    got = _run(port, enc, keep, dec)
    assert got.dtype == torch.float32 and np.isfinite(got.numpy()).all()
    top = float(np.abs(want).max())
    err = float(np.abs(got.numpy() - want).max())
    assert err <= BF16_LOGIT_REL * top, (err, top)


def _key_bias(name):
    """True on the key slots of a self attention's fused qkv bias ([q | k
    | v] per head) or of a cross attention's kv bias ([k | v] per head)."""
    hd = HID // HEADS
    if name.endswith("qkv.bias"):
        mask = torch.zeros(HEADS, 3, hd, dtype=torch.bool)
    elif name.endswith("inter_attention.kv.bias"):
        mask = torch.zeros(HEADS, 2, hd, dtype=torch.bool)
    else:
        return None
    mask[:, -2 if name.endswith("qkv.bias") else 0] = True
    return mask.reshape(-1)


@pytest.mark.parametrize("backend", ["softmax", "flash"])
def test_gradients_match_jax_grad(params, backend):
    ref, port = _pair(params, backend)
    enc, keep, dec, labels, loss_mask = batch(1)

    def loss_of(p):
        logits = ref.apply(p, jnp.asarray(enc), jnp.asarray(keep),
                           jnp.asarray(dec))
        return ref_loss(logits, jnp.asarray(labels), jnp.asarray(loss_mask))

    want_loss, grads = jax.value_and_grad(loss_of)(params)
    want = t5_params_from_jax(jax.tree_util.tree_map(np.asarray, grads),
                              port.config)
    loss = t5_loss_fn(port(enc, keep, dec), torch.from_numpy(labels),
                      torch.from_numpy(loss_mask))
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


def test_loss_matches_reference():
    rng = np.random.RandomState(3)
    logits = (4 * rng.randn(S_DEC, BATCH, VOCAB)).astype(np.float32)
    _, _, _, labels, loss_mask = batch()
    want = ref_loss(jnp.asarray(logits), jnp.asarray(labels),
                    jnp.asarray(loss_mask))
    got = t5_loss_fn(torch.from_numpy(logits), torch.from_numpy(labels),
                     torch.from_numpy(loss_mask))
    assert abs(float(got) - float(want)) <= LOSS_ATOL
    # an all-zero loss mask divides by 1, as the reference's maximum
    zero = t5_loss_fn(torch.from_numpy(logits), torch.from_numpy(labels),
                      torch.zeros(BATCH, S_DEC))
    assert float(zero) == 0.0


@pytest.mark.parametrize("backend", ["softmax", "flash"])
def test_encoder_padding_does_not_reach_the_logits(params, backend):
    """Changing an encoder token under the mask leaves every decoder
    logit as it was (both backends mask pads out of the cross keys)."""
    _, port = _pair(params, backend)
    enc, keep, dec = batch()[:3]
    other = enc.copy()
    other[keep == 0] = (other[keep == 0] + 7) % VOCAB
    torch.testing.assert_close(_run(port, other, keep, dec),
                               _run(port, enc, keep, dec), rtol=0, atol=0)


@pytest.mark.parametrize("backend", ["softmax", "flash"])
def test_decoder_is_causal(params, backend):
    """A later decoder token changes no earlier position's logits."""
    _, port = _pair(params, backend)
    enc, keep, dec = batch()[:3]
    other = dec.copy()
    other[:, 7:] = (other[:, 7:] + 5) % VOCAB
    a, b = _run(port, enc, keep, dec), _run(port, enc, keep, other)
    torch.testing.assert_close(a[:7], b[:7], rtol=0, atol=1e-6)
    assert float((a[7:] - b[7:]).abs().max()) > 1e-3


def test_backends_agree_on_real_rows(params):
    """The encoder's pad rows differ between the two masking conventions,
    but both backends keep them out of the cross keys: every decoder
    logit agrees (the reference's tests/test_t5.py holds its own two
    backends so)."""
    _, soft = _pair(params, "softmax")
    _, flash = _pair(params, "flash")
    enc, keep, dec = batch(2)[:3]
    torch.testing.assert_close(_run(flash, enc, keep, dec),
                               _run(soft, enc, keep, dec), rtol=0,
                               atol=LOGIT_ATOL)


def test_stage_layout_matches_reference():
    for args in ((12, 12, 4, 2), (12, 4, 4, 3), (2, 2, 2, 1), (24, 6, 5, 4)):
        assert encoder_decoder_stage_layout(*args) == ref_layout(*args)
    for bad in ((12, 12, 4, 0), (12, 12, 4, 4), (10, 12, 4, 3),
                (12, 10, 4, 1)):
        with pytest.raises(ValueError):
            ref_layout(*bad)
        with pytest.raises(ValueError):
            encoder_decoder_stage_layout(*bad)


def test_config_checks_and_enums():
    with pytest.raises(ValueError, match="attention_backend"):
        T5Config(attention_backend="Flash")
    cfg = T5Config()
    assert (cfg.vocab_size, cfg.max_seq_len, cfg.hidden_size,
            cfg.num_encoder_layers, cfg.num_decoder_layers, cfg.num_heads,
            cfg.ffn, cfg.attention_backend) == (
                32128, 512, 768, 12, 12, 12, 3072, "softmax")
    assert cfg.dtype == torch.bfloat16 and cfg.param_dtype == torch.float32
    from apex_tpu.transformer import enums as ref_enums
    for mine, theirs in ((LayerType, ref_enums.LayerType),
                         (AttnType, ref_enums.AttnType),
                         (ModelType, ref_enums.ModelType),
                         (AttnMaskType, ref_enums.AttnMaskType)):
        assert {m.name: m.value for m in mine} == {
            m.name: m.value for m in theirs}


def test_model_provider_builds_the_config():
    model = t5_model_provider(port_config(), device="cpu",
                              generator=torch.Generator().manual_seed(0))
    again = t5_model_provider(device="cpu",
                              generator=torch.Generator().manual_seed(0),
                              **{f.name: getattr(port_config(), f.name)
                                 for f in T5Config.__dataclass_fields__
                                 .values()})
    assert model.config == port_config()
    for (n, a), (m, b) in zip(model.state_dict().items(),
                              again.state_dict().items()):
        assert n == m and torch.equal(a, b)


def test_converter_rejects_missing_and_extra_keys(params):
    tree = dict(jax.tree_util.tree_map(np.asarray, params)["params"])
    dropped = dict(tree)
    dropped.pop("decoder_norm")
    with pytest.raises(KeyError, match="decoder_norm"):
        t5_params_from_jax(dropped, port_config())
    tree["pooler"] = {"kernel": np.zeros(3, np.float32)}
    with pytest.raises(KeyError, match="pooler"):
        t5_params_from_jax(tree, port_config())
