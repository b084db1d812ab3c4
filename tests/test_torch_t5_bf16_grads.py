"""The port's bf16 T5 gradients on the flash backend against the
reference's bf16 ``jax.grad``.

On the card, at T5-base, the cross attention's query side
(``inter_attention.q.*`` and the ``post_attn_norm.*`` before it) reads
10-35% from its fp32 gradient in bf16 on the flash backend, where the
softmax backend reads within 4%. This file asks whether that is the
port's doing or the reference's design: a small T5 (vocab 96, hidden 64,
2 + 2 layers, 4 heads of 16) with 256 encoder keys and padded encoder
tails, the reference's weights carried across, goes through

- the reference's bf16 model on its Pallas flash kernels, interpreted on
  the CPU (``softmax_impl="interpret"``, as its own tests run them): the
  kernels' custom backward, whose delta is taken from the bf16 output;
- the reference's bf16 model on ``softmax_impl="xla"``: plain autodiff
  through the same attention, no custom backward;
- the port's plain bf16 path (the kernels' plain versions);

and each leaf's gradient is held in relative L2 against the reference's
fp32 gradient (``softmax_impl="xla"``, which its interpreted kernels
match within 4e-6).

Measured here (numpy and PRNG seed 0): on the query side the reference's
kernels read 2.5-3.7% from fp32 and its autodiff 0.9-1.9%; the other
leaves read a median 0.8% on both. The port reads 1.7-3.2% on the query
side, no farther than the reference's kernels leaf by leaf. Held against
the reference's bf16 kernels directly, the port reads 1.6-3.7% on the
query side (1.9% at worst on the other leaves), where the reference's
own autodiff reads 2.4-3.6% from its kernels. So the distance is the
flash backward's design, shared by both frameworks, not a fault of the
port. Held: the query side reads farther from fp32 than the other leaves
on the reference's kernels (``QSIDE_SPREAD``) and farther there than
under autodiff (the effect is present at this size, so the next checks
mean something); on each query-side leaf the port is no farther from fp32
than ``QSIDE_FACTOR`` times the reference's kernels, and no farther from
the reference's kernels than ``QSIDE_FACTOR`` times the reference's
autodiff is; on every leaf the port is within ``OTHER_TOL`` of the
reference's bf16 gradient. This size reads 2.5-3.7%, not the 10-35% of
T5-base on the card: the size effect itself is not reproduced here.
"""

import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from apex_tpu.models.t5 import T5Config as RefConfig
from apex_tpu.models.t5 import T5Model as RefModel
from apex_tpu.models.t5 import t5_loss_fn as ref_loss

from apex_tpu_torch.models import (
    T5Config,
    T5Model,
    load_jax_params,
    t5_loss_fn,
    t5_params_from_jax,
)

VOCAB, HID, LAYERS, HEADS, BATCH = 96, 64, 2, 4, 3
S_ENC, S_DEC = 256, 32
LENS = (256, 170, 90)
QSIDE = re.compile(r"decoder_layers\.\d+\.(inter_attention\.q|"
                   r"post_attn_norm)\.(weight|bias)")
QSIDE_SPREAD = 2.0
QSIDE_FACTOR = 1.5
OTHER_TOL = 0.05


def _batch():
    rng = np.random.RandomState(0)
    enc = rng.randint(1, VOCAB, (BATCH, S_ENC)).astype(np.int32)
    keep = (np.arange(S_ENC)[None, :] < np.asarray(LENS)[:, None])
    enc = np.where(keep, enc, 0).astype(np.int32)
    dec = rng.randint(1, VOCAB, (BATCH, S_DEC + 1)).astype(np.int32)
    loss_mask = (rng.rand(BATCH, S_DEC) < 0.8).astype(np.float32)
    return enc, keep.astype(np.int32), dec[:, :-1], dec[:, 1:], loss_mask


def _ref(dtype, impl):
    return RefModel(RefConfig(
        vocab_size=VOCAB, max_seq_len=S_ENC, hidden_size=HID,
        num_encoder_layers=LAYERS, num_decoder_layers=LAYERS,
        num_heads=HEADS, dtype=dtype, param_dtype=jnp.float32,
        attention_backend="flash", softmax_impl=impl, scan_layers=False))


def _ref_grads(model, params, b):
    enc, keep, dec, labels, loss_mask = (jnp.asarray(a) for a in b)

    def loss_of(p):
        return ref_loss(model.apply(p, enc, keep, dec), labels, loss_mask)

    grads = jax.jit(jax.grad(loss_of))(params)
    return t5_params_from_jax(jax.tree_util.tree_map(np.asarray, grads),
                              _port_config())


def _port_config():
    return T5Config(vocab_size=VOCAB, max_seq_len=S_ENC, hidden_size=HID,
                    num_encoder_layers=LAYERS, num_decoder_layers=LAYERS,
                    num_heads=HEADS, dtype=torch.bfloat16,
                    attention_backend="flash")


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.fixture(scope="module")
def grads():
    b = _batch()
    ref32 = _ref(jnp.float32, "xla")
    params = jax.jit(ref32.init)(jax.random.PRNGKey(0),
                                 *(jnp.asarray(a) for a in b[:3]))
    g32 = _ref_grads(ref32, params, b)
    g16 = _ref_grads(_ref(jnp.bfloat16, "interpret"), params, b)
    gx = _ref_grads(_ref(jnp.bfloat16, "xla"), params, b)
    port = load_jax_params(T5Model(_port_config(), device="cpu"),
                           jax.tree_util.tree_map(np.asarray, params))
    enc, keep, dec, labels, loss_mask = (torch.from_numpy(a) for a in b)
    t5_loss_fn(port.forward_plain(enc.long(), keep, dec.long()),
               labels.long(), loss_mask).backward()
    gp = {n: p.grad.detach().float() for n, p in port.named_parameters()}
    return g32, g16, gx, gp


def test_query_side_distance_is_the_references(grads):
    g32, g16, gx, gp = grads
    assert set(gp) == set(g32)
    kern = {n: _rel(g16[n], g32[n]) for n in g32}
    auto = {n: _rel(gx[n], g32[n]) for n in g32}
    port = {n: _rel(gp[n], g32[n]) for n in g32}
    port_vs_ref = {n: _rel(gp[n], g16[n]) for n in g32}
    qside = sorted(n for n in g32 if QSIDE.fullmatch(n))
    other = sorted(n for n in g32 if not QSIDE.fullmatch(n))
    assert len(qside) == 4 * LAYERS
    for n in qside:
        print(f"{n} from fp32: reference kernels {kern[n]:.4f}, reference "
              f"autodiff {auto[n]:.4f}, port {port[n]:.4f}; port from the "
              f"reference's bf16 {port_vs_ref[n]:.4f}, reference autodiff "
              f"from its kernels {_rel(gx[n], g16[n]):.4f}")
    print(f"other leaves from fp32, median: reference kernels "
          f"{np.median([kern[n] for n in other]):.4f}, autodiff "
          f"{np.median([auto[n] for n in other]):.4f}; port from the "
          f"reference's bf16, median "
          f"{np.median([port_vs_ref[n] for n in other]):.4f}, worst "
          f"{max(port_vs_ref[n] for n in other):.4f}")
    assert (np.median([kern[n] for n in qside])
            > QSIDE_SPREAD * np.median([kern[n] for n in other]))
    assert all(kern[n] > auto[n] for n in qside)
    for n in qside:
        assert port[n] <= QSIDE_FACTOR * kern[n], (n, port[n], kern[n])
        ref_spread = _rel(gx[n], g16[n])
        assert port_vs_ref[n] <= QSIDE_FACTOR * ref_spread, (
            n, port_vs_ref[n], ref_spread)
    for n in g32:
        assert port_vs_ref[n] <= OTHER_TOL, (n, port_vs_ref[n])
