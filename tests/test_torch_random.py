"""apex_tpu_torch.random and the Flax dropout keys against JAX and Flax.

The port's threefry2x32 generator is held bitwise against ``jax.random``
as installed (JAX 0.9.0, 64-bit types off, which the sampler and
``nn.Dropout`` run under): ``PRNGKey``, ``fold_in``, ``split``,
``bits``, ``uniform`` and ``bernoulli``. ``jax.random.bits`` lays its
counters over a shape according to ``jax_threefry_partitionable``; the
port follows the installed default (True), and the tests assert it.

``gumbel`` is ``-log(-log(u))`` with ``u`` bitwise the reference's; the
port takes both logs in fp64 on the CPU and rounds once, XLA's CPU takes
them in fp32, so the two differ by an fp32 ulp on some of the draws: it
is held within 2^-20 relative (four ulps) of the larger of |g| and 1.
The port's CPU draw is the same bits under every thread count.

Then ``models/_rng.py``: the keys the reference's GPT and BERT layers
draw under ``apply(..., deterministic=False, rngs={"dropout": key})``,
captured from Flax's ``Scope.make_rng`` while it runs, on both attention
backends and in both ``scan_layers`` layouts, equal to the port's
derivation. Flax folds the scope path with no separator between names
(``flax_fix_rng_separator`` off, asserted).
"""

import numpy as np
import pytest
import torch

import flax
import flax.core.scope as flax_scope
import jax
import jax.numpy as jnp
from apex_tpu.models.bert import BertConfig as RefBertConfig
from apex_tpu.models.bert import BertModel as RefBert
from apex_tpu.models.gpt import GPTConfig as RefGPTConfig
from apex_tpu.models.gpt import GPTModel as RefGPT

from apex_tpu_torch import random as port
from apex_tpu_torch.models._rng import fold_in_static, layer_keys

SEEDS = [0, 1, 42, 2 ** 31 - 1, 123456789]
GUMBEL_REL = 2.0 ** -20


def test_the_flags_the_port_follows():
    assert jax.config.jax_threefry_partitionable
    assert not jax.config.jax_enable_x64
    assert flax.config.flax_fix_rng_separator is False


def _words(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    np.testing.assert_array_equal(port.PRNGKey(seed).numpy(),
                                  _words(jax.random.PRNGKey(seed)))


def test_prng_key_of_a_uint32_seed():
    # the sampler's seeds are uint32, above int32's range too
    for seed in (2 ** 31, 2 ** 32 - 1):
        want = _words(jax.random.PRNGKey(jnp.uint32(seed)))
        np.testing.assert_array_equal(port.PRNGKey(seed).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 1, 7, 2 ** 31 + 5, 2 ** 32 - 1])
def test_fold_in(seed, data):
    key = jax.random.PRNGKey(seed)
    want = _words(jax.random.fold_in(key, jnp.uint32(data)))
    np.testing.assert_array_equal(port.fold_in(_words(key), data).numpy(),
                                  want)


@pytest.mark.parametrize("num", [1, 2, 3, 24])
def test_split(num):
    key = jax.random.PRNGKey(5)
    np.testing.assert_array_equal(port.split(_words(key), num).numpy(),
                                  _words(jax.random.split(key, num)))


@pytest.mark.parametrize("shape", [(1,), (7,), (3, 5, 2), (2, 1023),
                                   (4, 16, 33, 33)])
def test_bits(shape):
    key = jax.random.PRNGKey(9)
    want = np.asarray(jax.random.bits(key, shape)).astype(np.int64)
    got = port.bits(_words(key), shape)
    assert got.shape == shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_bits_of_a_stack_of_keys_is_each_key_s_draw():
    keys = jax.random.split(jax.random.PRNGKey(2), 4)
    got = port.bits(torch.from_numpy(_words(keys)), (3, 5))
    for i in range(4):
        np.testing.assert_array_equal(
            got[i].numpy(),
            np.asarray(jax.random.bits(keys[i], (3, 5))).astype(np.int64))


@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-2.0, 3.0),
                                    (float(np.finfo(np.float32).tiny), 1.0)])
def test_uniform(bounds):
    key = jax.random.PRNGKey(11)
    want = np.asarray(jax.random.uniform(key, (4097,), jnp.float32,
                                         *bounds))
    got = port.uniform(_words(key), (4097,), *bounds)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("p", [0.9, 0.5, 0.1, 0.999])
def test_bernoulli(p):
    key = jax.random.PRNGKey(13)
    want = np.asarray(jax.random.bernoulli(key, p, (64, 129)))
    np.testing.assert_array_equal(
        port.bernoulli(_words(key), p, (64, 129)).numpy(), want)


def test_gumbel_within_the_log_ulps():
    key = jax.random.PRNGKey(17)
    want = np.asarray(jax.random.gumbel(key, (100000,), jnp.float32))
    got = port.gumbel(_words(key), (100000,)).numpy()
    assert np.isfinite(got).all()
    tol = GUMBEL_REL * np.maximum(np.abs(want), 1.0)
    assert (np.abs(got - want) <= tol).all()
    # a fifth of the draws differ, all within the bound
    assert (got != want).mean() < 0.5


@pytest.mark.parametrize("threads", [1, 2, 3, 8])
def test_gumbel_bits_do_not_depend_on_the_thread_count(threads):
    key = _words(jax.random.PRNGKey(17))
    before = torch.get_num_threads()
    want = port.gumbel(key, (100000,)).numpy()
    try:
        torch.set_num_threads(threads)
        got = port.gumbel(key, (100000,)).numpy()
    finally:
        torch.set_num_threads(before)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_fold_in_static_is_flax_s():
    key = jax.random.PRNGKey(21)
    for data in (("layers",), ("layer_3", "attention", 1),
                 ("layers", "layer", "Dropout_1", 2), ("a", 300)):
        want = _words(flax_scope._fold_in_static(key, data))
        assert fold_in_static(_words(key), data) == tuple(want.tolist())


# -- the reference's make_rng keys ---------------------------------------------


def _captured_keys(monkeypatch, family, backend, scan_layers, seed=5):
    """(scope path, key words) of every dropout make_rng of one
    reference forward, in the order the device reports them."""
    rec = []
    orig = flax_scope.Scope.make_rng

    def make_rng(self, name="params"):
        key = orig(self, name)
        if name == "dropout":
            path = "/".join(self.path)
            jax.debug.callback(
                lambda k, path=path: rec.append(
                    (path, tuple(int(x) for x in np.asarray(k).ravel()))),
                key, ordered=True)
        return key

    monkeypatch.setattr(flax_scope.Scope, "make_rng", make_rng)
    kw = dict(vocab_size=64, max_seq_len=16, hidden_size=32, num_layers=3,
              num_heads=2, dtype=jnp.float32, attention_dropout=0.1,
              hidden_dropout=0.1, attention_backend=backend,
              scan_layers=scan_layers, softmax_impl="xla")
    toks = jnp.zeros((2, 16), jnp.int32)
    if family == "gpt":
        model = RefGPT(RefGPTConfig(**kw))
        args = (toks,)
    else:
        model = RefBert(RefBertConfig(**kw))
        args = (toks, jnp.ones((2, 16), jnp.int32))
    params = model.init(jax.random.PRNGKey(0), *args)
    model.apply(params, *args, deterministic=False,
                rngs={"dropout": jax.random.PRNGKey(seed)})
    jax.effects_barrier()
    return rec


@pytest.mark.parametrize("scan_layers", [True, False])
@pytest.mark.parametrize("backend", ["flash", "softmax"])
@pytest.mark.parametrize("family", ["gpt", "bert"])
def test_layer_keys_are_the_reference_s(monkeypatch, family, backend,
                                        scan_layers):
    rec = _captured_keys(monkeypatch, family, backend, scan_layers)
    keys = layer_keys([0, 5], 3, scan_layers=scan_layers,
                      softmax_backend=backend == "softmax")
    prefix = ("layers/layer" if scan_layers else "layer_{i}")
    attn = "attention/Dropout_0" if backend == "softmax" else "attention"
    want = {}
    for path, k in rec:
        want.setdefault(path, []).append(k)
    got = {}
    for i, lk in enumerate(keys):
        p = prefix.format(i=i)
        for name, k in ((attn, lk.attention), ("Dropout_0", lk.hidden[0]),
                        ("Dropout_1", lk.hidden[1])):
            got.setdefault(f"{p}/{name}", []).append(k)
    assert len(rec) == 9
    # under the scan one path draws once a layer, reported in layer order
    assert got == want
