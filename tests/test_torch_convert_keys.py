"""The converters' key check, pinned word for word for GPT and T5 (both
layer layouts) and the DCGAN modules: every model family reads the
reference's tree through one path (``convert._params_from_jax``: scanned
stacks unrolled by ``migrate.unstack_scan_params``, then one lookup a
name), and a missing or an unexpected key raises the same message."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from apex_tpu.models.gpt import GPTConfig as RefGPTConfig
from apex_tpu.models.gpt import GPTModel as RefGPT
from apex_tpu.models.t5 import T5Config as RefT5Config
from apex_tpu.models.t5 import T5Model as RefT5

from apex_tpu_torch.models import (
    GPTConfig,
    T5Config,
    gpt_params_from_jax,
    t5_params_from_jax,
)

SMALL = dict(vocab_size=64, max_seq_len=16, hidden_size=32, num_heads=4)


def _gpt(scan):
    ref = RefGPT(RefGPTConfig(num_layers=2, scan_layers=scan,
                              softmax_impl="xla", **SMALL))
    params = jax.jit(ref.init)(jax.random.PRNGKey(0),
                               jnp.zeros((1, 8), jnp.int32))
    return (jax.tree_util.tree_map(np.asarray, params)["params"],
            GPTConfig(num_layers=2, **SMALL))


def _t5(scan):
    ref = RefT5(RefT5Config(num_encoder_layers=2, num_decoder_layers=2,
                            scan_layers=scan, softmax_impl="xla", **SMALL))
    toks = jnp.ones((1, 8), jnp.int32)
    params = jax.jit(ref.init)(jax.random.PRNGKey(0), toks, toks, toks)
    return (jax.tree_util.tree_map(np.asarray, params)["params"],
            T5Config(num_encoder_layers=2, num_decoder_layers=2, **SMALL))


def _message(fn, tree, cfg):
    with pytest.raises(KeyError) as err:
        fn(tree, cfg)
    return err.value.args[0]


@pytest.mark.parametrize("scan", [True, False], ids=["scan", "unrolled"])
def test_gpt_messages(scan):
    tree, cfg = _gpt(scan)
    gpt_params_from_jax(tree, cfg)
    dropped = dict(tree)
    dropped.pop("final_norm")
    assert _message(gpt_params_from_jax, dropped, cfg) == (
        "reference GPT params do not match the config: missing "
        "['final_norm/bias', 'final_norm/scale'], unexpected []")
    extra = dict(tree, stray={"kernel": np.zeros(3, np.float32)})
    assert _message(gpt_params_from_jax, extra, cfg) == (
        "reference GPT params do not match the config: missing [], "
        "unexpected ['stray/kernel']")
    one = GPTConfig(num_layers=1, **SMALL)
    assert _message(gpt_params_from_jax, tree, one).endswith(
        "missing [], unexpected " + str(sorted(
            f"layer_1/{p}" for p in _layer_paths(tree, "layers", "layer"))))


def _layer_paths(tree, scanned, unrolled):
    """The paths inside one layer of a stack, in either layout."""
    body = tree[scanned]["layer"] if scanned in tree else \
        tree[f"{unrolled}_0"]
    out = []

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                out.append(prefix + k)
    walk(body, "")
    return out


@pytest.mark.parametrize("scan", [True, False], ids=["scan", "unrolled"])
def test_t5_messages(scan):
    tree, cfg = _t5(scan)
    t5_params_from_jax(tree, cfg)
    dropped = dict(tree)
    dropped.pop("decoder_norm")
    assert _message(t5_params_from_jax, dropped, cfg) == (
        "reference T5 params do not match the config: missing "
        "['decoder_norm/bias', 'decoder_norm/scale'], unexpected []")
    extra = dict(tree, pooler={"kernel": np.zeros(3, np.float32)})
    assert _message(t5_params_from_jax, extra, cfg) == (
        "reference T5 params do not match the config: missing [], "
        "unexpected ['pooler/kernel']")
    fewer = T5Config(num_encoder_layers=2, num_decoder_layers=1, **SMALL)
    assert _message(t5_params_from_jax, tree, fewer).endswith(
        "missing [], unexpected " + str(sorted(
            f"decoder_1/{p}" for p in _layer_paths(tree, "decoder_layers",
                                                   "decoder"))))
