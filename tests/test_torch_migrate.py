"""Checkpoint migration of apex_tpu_torch against apex_tpu's.

``stack_scan_params`` / ``unstack_scan_params`` of the port and of the
reference (``apex_tpu/models/migrate.py``) on the same trees: a GPT
tree's ``layers`` stack, a T5 tree's encoder and decoder stacks (the
reference models' own parameter trees, initialised in flax, as numpy
arrays), the same trees as torch tensors, and unrolled groups with a
missing index. Values are moved bit for bit: every comparison is exact,
bf16 leaves included.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from apex_tpu.models import migrate as ref_migrate
from apex_tpu.models.gpt import GPTConfig as RefGPTConfig
from apex_tpu.models.gpt import GPTModel as RefGPT
from apex_tpu.models.t5 import T5Config as RefT5Config
from apex_tpu.models.t5 import T5Model as RefT5

from apex_tpu_torch.models.migrate import (
    stack_scan_params,
    unstack_scan_params,
)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _same(a, b):
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb), (sorted(set(fa) ^ set(fb)))
    for k in fa:
        x, y = fa[k], fb[k]
        if isinstance(x, torch.Tensor):
            x = x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 \
                else x.numpy()
        if isinstance(y, torch.Tensor):
            y = y.view(torch.int16).numpy() if y.dtype == torch.bfloat16 \
                else y.numpy()
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape, k
        assert x.tobytes() == y.tobytes(), k


@pytest.fixture(scope="module")
def gpt_tree():
    cfg = RefGPTConfig(vocab_size=64, max_seq_len=16, hidden_size=32,
                       num_layers=3, num_heads=2, dtype=jnp.float32)
    tokens = jnp.zeros((1, 8), jnp.int32)
    return _np(RefGPT(cfg).init(jax.random.PRNGKey(0), tokens))


@pytest.fixture(scope="module")
def t5_tree():
    cfg = RefT5Config(vocab_size=64, max_seq_len=16, hidden_size=32,
                      num_encoder_layers=3, num_decoder_layers=2,
                      num_heads=2, dtype=jnp.float32)
    z = jnp.zeros((1, 8), jnp.int32)
    return _np(RefT5(cfg).init(jax.random.PRNGKey(0), z, z + 1, z))


@pytest.mark.parametrize("which", ["gpt", "t5"])
def test_unstack_and_stack_match_the_reference(which, gpt_tree, t5_tree):
    tree = gpt_tree if which == "gpt" else t5_tree
    unrolled = unstack_scan_params(tree)
    _same(unrolled, _np(ref_migrate.unstack_scan_params(tree)))
    names = set(unrolled["params"])
    if which == "gpt":
        assert {"layer_0", "layer_1", "layer_2"} <= names
        assert "layers" not in names
    else:
        assert {"encoder_0", "encoder_2", "decoder_0", "decoder_1"} <= names
        assert not names & {"encoder_layers", "decoder_layers"}
    stacked = stack_scan_params(unrolled)
    _same(stacked, _np(ref_migrate.stack_scan_params(unrolled)))
    _same(stacked, tree)                        # the round trip, bitwise


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_round_trip_on_tensors_is_bitwise(t5_tree, dtype):
    tree = jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)).to(dtype), t5_tree)
    unrolled = unstack_scan_params(tree)
    leaf = unrolled["params"]["encoder_1"]["mlp"]["fc1"]["kernel"]
    assert isinstance(leaf, torch.Tensor) and leaf.dtype == dtype
    _same(stack_scan_params(unrolled), tree)
    want = ref_migrate.unstack_scan_params(t5_tree)
    _same(jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)).to(dtype), _np(want)),
        unrolled)


def test_non_contiguous_layers_raise(gpt_tree):
    unrolled = unstack_scan_params(gpt_tree)
    body = dict(unrolled["params"])
    body.pop("layer_1")
    with pytest.raises(ValueError, match="not contiguous"):
        ref_migrate.stack_scan_params(body)
    with pytest.raises(ValueError, match=r"not contiguous.*missing \[1\]"):
        stack_scan_params(body)


def test_other_keys_and_empty_stacks_pass_through():
    tree = {"layers": {"layer": {}}, "head": {"w": np.ones(3)},
            "layers_extra": np.zeros(2)}
    out = unstack_scan_params(tree)
    assert out["layers"] == {"layer": {}}
    assert out["head"]["w"] is tree["head"]["w"]
    assert stack_scan_params({"x": 1}) == {"x": 1}
    assert unstack_scan_params(5) == 5
