"""Pretraining with dropout, apex_tpu_torch against apex_tpu.

A tiny GPT (vocab 128, hidden 64, 2 layers, 4 heads, seq 32, batch 4)
and a tiny BERT (the same widths, batch 3 with padded tails, tokentypes,
an MLM loss mask and NSP labels), both with ``attention_dropout=0.1`` and
``hidden_dropout=0.1`` (Megatron's GPT-2 and Google's BERT-Large
defaults), train three steps on each attention backend. The reference
step is its users' loop: ``jax.value_and_grad`` of the loss over
``model.apply(params, ..., deterministic=False, rngs={"dropout": key})``
then ``FusedAdam(lr=2e-3, weight_decay=0.01, impl="xla").step``; the
port's is ``PretrainStep(model, FusedAdam(...), loss_fn=...)`` called
with ``dropout_key=key``. The reference takes one step first, and its
weights and Adam state are loaded into the port (as
``test_torch_pretrain.py`` does); then both take three steps, each with
a new key, ``PRNGKey(100 + step)``.

Both run every dropout with the same masks: the hidden and the softmax
backend's probability dropout through threefry2x32 bits keyed as Flax
keys each scope, the flash backend's through the counter hash (the
reference's Pallas kernels in interpret mode). The GPT runs in both
``scan_layers`` layouts (the keys differ between them); BERT scanned,
its default.

Tolerances, as ``test_torch_pretrain.py`` states them. fp32: losses
within 2e-6; every parameter within 1e-5 of the larger of its leaf's
largest |value| and lr (BERT's NSP bias stays within ~1e-5 of 0: its two
gradient entries are opposite), except the key bias (an exactly-zero true gradient, whose rounding noise
Adam normalises to steps of up to about lr): within 6 lr. bf16 compute:
losses within 1e-3; the parameters all within 6 lr, their mean
difference within lr / 20, and at most 1% of them more than lr / 4
apart. A loss with dropout differs from the same step without it.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from apex_tpu.models.bert import BertConfig as RefBertConfig
from apex_tpu.models.bert import BertModel as RefBert
from apex_tpu.models.bert import bert_loss_fn as ref_bert_loss
from apex_tpu.models.gpt import GPTConfig as RefGPTConfig
from apex_tpu.models.gpt import GPTModel as RefGPT
from apex_tpu.models.gpt import gpt_loss_fn as ref_gpt_loss
from apex_tpu.optimizers import FusedAdam as RefAdam

from apex_tpu_torch.models import (
    BertConfig,
    BertModel,
    GPTConfig,
    GPTModel,
    PretrainStep,
    bert_loss_fn,
    bert_params_from_jax,
    gpt_params_from_jax,
    load_jax_opt_state,
    load_jax_params,
)
from apex_tpu_torch.optimizers import FusedAdam

VOCAB, SEQ, HID, LAYERS, HEADS = 128, 32, 64, 2, 4
GPT_BATCH = 4
BERT_LENS = (32, 20, 9)
LR = 2e-3
DROP = dict(attention_dropout=0.1, hidden_dropout=0.1)
LOSS_ATOL = {"fp32": 2e-6, "bf16": 1e-3}
PARAM_REL_FP32 = 1e-5
STEPS = 3

CASES = {
    # family, backend, dtype, scan_layers
    "gpt-flash": ("gpt", "flash", "fp32", True),
    "gpt-flash-unscanned": ("gpt", "flash", "fp32", False),
    "gpt-softmax": ("gpt", "softmax", "fp32", True),
    "gpt-flash-bf16": ("gpt", "flash", "bf16", True),
    "bert-flash": ("bert", "flash", "fp32", True),
    "bert-softmax": ("bert", "softmax", "fp32", True),
    "bert-softmax-bf16": ("bert", "softmax", "bf16", True),
}


def _dtypes(dt):
    return {"fp32": (jnp.float32, torch.float32),
            "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]


def _gpt_batches(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t = rng.randint(0, VOCAB, (GPT_BATCH, SEQ + 1)).astype(np.int32)
        out.append((t[:, :-1], t[:, 1:]))
    return out


def _bert_batches(n, seed=0):
    """n batches of (tokens, keep, tokentypes, labels, loss_mask, nsp)."""
    rng = np.random.RandomState(seed)
    b = len(BERT_LENS)
    keep = np.arange(SEQ)[None, :] < np.asarray(BERT_LENS)[:, None]
    tt = keep & (np.arange(SEQ)[None, :] >= np.asarray(BERT_LENS)[:, None]
                 // 2)
    return [(rng.randint(0, VOCAB, (b, SEQ)).astype(np.int32),
             keep.astype(np.int32), tt.astype(np.int32),
             rng.randint(0, VOCAB, (b, SEQ)).astype(np.int32),
             (keep & (rng.rand(b, SEQ) < 0.3)).astype(np.float32),
             rng.randint(0, 2, (b,)).astype(np.int32)) for _ in range(n)]


def _gpt_loss(model, tokens, labels, dropout_key=None):
    from apex_tpu_torch.models import gpt_loss_fn
    return gpt_loss_fn(model(tokens.long(), deterministic=dropout_key is None,
                             dropout_key=dropout_key), labels)


def _bert_loss(model, tokens, keep, tt, labels, loss_mask, nsp,
               dropout_key=None):
    return bert_loss_fn(*model(tokens, keep, tt,
                               deterministic=dropout_key is None,
                               dropout_key=dropout_key),
                        labels, loss_mask, nsp)


def _unpack(state, buf):
    return jax.tree_util.tree_map(
        np.asarray, state.space.unpack(buf, dtype="buffer"))


def _key_bias(cfg):
    """True on the key slots of each layer's fused qkv bias: GPT lays it
    out [q | k | v] per kv head, BERT per head."""
    hd = HID // HEADS
    mask = torch.zeros(HEADS, 3, hd, dtype=torch.bool)
    mask[:, 1] = True
    return mask.reshape(-1)


@pytest.fixture(scope="module", params=sorted(CASES))
def trained(request):
    family, backend, dt, scan = CASES[request.param]
    jdt, tdt = _dtypes(dt)
    shape = dict(vocab_size=VOCAB, max_seq_len=SEQ, hidden_size=HID,
                 num_layers=LAYERS, num_heads=HEADS,
                 attention_backend=backend, scan_layers=scan, **DROP)
    if family == "gpt":
        rcfg = RefGPTConfig(dtype=jdt, softmax_impl="interpret", **shape)
        cfg = GPTConfig(dtype=tdt, **shape)
        rmodel, batches = RefGPT(rcfg), _gpt_batches(STEPS)
        params = rmodel.init(jax.random.PRNGKey(0),
                             jnp.asarray(batches[0][0]))

        def ref_loss(p, key, tokens, labels):
            return ref_gpt_loss(rmodel.apply(
                p, tokens, deterministic=False, rngs={"dropout": key}),
                labels)
        model = GPTModel(cfg, device="cpu")
        loss_fn = _gpt_loss
    else:
        rcfg = RefBertConfig(dtype=jdt, softmax_impl="interpret", **shape)
        cfg = BertConfig(dtype=tdt, **shape)
        rmodel, batches = RefBert(rcfg), _bert_batches(STEPS)
        params = rmodel.init(jax.random.PRNGKey(0),
                             jnp.asarray(batches[0][0]),
                             jnp.asarray(batches[0][1]))

        def ref_loss(p, key, tokens, keep, tt, labels, loss_mask, nsp):
            lm, binary = rmodel.apply(p, tokens, keep, tt,
                                      deterministic=False,
                                      rngs={"dropout": key})
            return ref_bert_loss(lm, binary, labels, loss_mask, nsp)
        model = BertModel(cfg, device="cpu")
        loss_fn = _bert_loss
    ropt = RefAdam(lr=LR, weight_decay=0.01, impl="xla")
    rs = ropt.init(params)

    @jax.jit
    def ref_step(state, key, *batch):
        loss, grads = jax.value_and_grad(ref_loss)(
            state.space.unpack(state.master), key, *batch)
        _, state = ropt.step(state, grads)
        return state, loss

    # one reference step first, so that Adam's v is not the rounding
    # noise of a first gradient (a first step moves every element by
    # about lr whatever its gradient's size)
    rs, _ = ref_step(rs, jax.random.PRNGKey(99), *batches[0])
    model = load_jax_params(model, _unpack(rs, rs.master))
    step = PretrainStep(model, FusedAdam(lr=LR, weight_decay=0.01),
                        loss_fn=loss_fn)
    ps = load_jax_opt_state(step.init(), cfg, {
        "master": _unpack(rs, rs.master), "m": _unpack(rs, rs.slots["m"]),
        "v": _unpack(rs, rs.slots["v"]), "count": int(rs.count)})
    # the first batch without dropout, on the same weights
    with torch.no_grad():
        plain = float(loss_fn(model, *(torch.from_numpy(a)
                                       for a in batches[0])))
    losses = []
    for i, batch in enumerate(batches):
        key = jax.random.PRNGKey(100 + i)
        rs, rl = ref_step(rs, key, *batch)
        kd = np.asarray(jax.random.key_data(key))
        ps, pl = step(ps, *batch, dropout_key=kd)
        losses.append((float(rl), float(pl)))
    return family, dt, cfg, rs, ps, losses, plain


def test_losses_match_each_step(trained):
    _, dt, _, _, _, losses, plain = trained
    for want, got in losses:
        assert np.isfinite(got)
        assert abs(got - want) <= LOSS_ATOL[dt], losses
    assert abs(losses[0][1] - plain) > 10 * LOSS_ATOL[dt]   # dropout is live


def test_parameters_match_after_three_steps(trained):
    family, dt, cfg, rs, ps, _, _ = trained
    convert = gpt_params_from_jax if family == "gpt" else \
        bert_params_from_jax
    want = convert(_unpack(rs, rs.master), cfg)
    got = ps.space.unpack(ps.master, "buffer")
    assert set(got) == set(want)
    key = _key_bias(cfg)
    diffs = []
    for leaf, w in want.items():
        diff = (got[leaf] - w).abs()
        diffs.append(diff.reshape(-1))
        if dt == "bf16":
            continue                     # held as a whole below
        if leaf.endswith("qkv.bias"):
            assert float(diff[key].max()) <= 6 * LR, leaf
            diff, w = diff[~key], w[~key]
        scale = max(float(w.abs().max()), LR)
        assert float(diff.max()) <= PARAM_REL_FP32 * scale, (
            leaf, float(diff.max()))
    if dt == "bf16":
        d = torch.cat(diffs)
        assert float(d.max()) <= 6 * LR
        assert float(d.mean()) <= LR / 20
        assert float((d > LR / 4).float().mean()) <= 0.01


def test_step_without_a_key_is_deterministic(trained):
    family, _, cfg, _, _, _, _ = trained
    model = (GPTModel if family == "gpt" else BertModel)(
        cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    if family == "gpt":
        x = torch.from_numpy(_gpt_batches(1)[0][0]).long()
        args = (x,)
    else:
        b = _bert_batches(1)[0]
        args = tuple(torch.from_numpy(a) for a in b[:3])
    with torch.no_grad():
        a = model(*args)
        b_ = model(*args)
        c = model(*args, deterministic=False, dropout_key=(0, 1))
    first = (lambda o: o if family == "gpt" else o[0])
    assert torch.equal(first(a), first(b_))
    assert not torch.equal(first(a), first(c))
    with pytest.raises(ValueError, match="dropout_key"):
        model(*args, deterministic=False)
