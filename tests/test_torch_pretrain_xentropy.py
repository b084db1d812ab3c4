"""GPT pretraining with the contrib xentropy loss (label smoothing 0.1,
padded labels): apex_tpu_torch against apex_tpu.

A tiny GPT (2 layers, hidden 64, 4 heads, vocab 250, seq 32, batch 4)
whose label rows end in padding (real lengths 32, 20, 9 and 27; the
rest ``padding_idx`` 0) trains with the loss the reference user swaps
in: ``softmax_cross_entropy(logits, labels.T, smoothing=0.1,
padding_idx=0)`` summed and divided by the count of real labels. The
reference takes ``jax.value_and_grad`` of that composed loss over the
model's apply and ``FusedAdam(lr=2e-3, weight_decay=0.01).step``, with
its xentropy on the XLA path and on the Pallas kernels in interpret
mode; it takes one step first, its weights and Adam state are carried
into the port (``load_jax_params``, ``load_jax_opt_state``), and both
take the same three further steps, the port through ``PretrainStep(
model, FusedAdam(...), loss_fn=...)`` on its plain versions. The losses
are compared at each step, and every parameter, m and v after the
third, per parameter name.

Tolerances, as ``test_torch_pretrain.py`` states them for GPT's own
loss. fp32: losses within 2e-6; m, v and the parameters within 1e-5 of
each leaf's largest |value| (sums in other orders), except the key bias,
whose exactly-zero true gradient Adam turns into steps of up to ~lr on
each side: within 6 lr. bf16 compute: losses within 1e-3; m and v within
10% of each leaf's largest |value|; the parameters all within 6 lr, their
mean difference within lr / 20 and at most 1% of them more than lr / 4
apart.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from apex_tpu.contrib.xentropy import softmax_cross_entropy as ref_xent
from apex_tpu.models.gpt import GPTConfig as RefConfig
from apex_tpu.models.gpt import GPTModel as RefGPT
from apex_tpu.models.pretrain import init_gpt_pretrain_params as ref_init
from apex_tpu.optimizers import FusedAdam as RefAdam

from apex_tpu_torch.contrib.xentropy import softmax_cross_entropy
from apex_tpu_torch.models import (
    GPTConfig,
    GPTModel,
    PretrainStep,
    gpt_params_from_jax,
    load_jax_opt_state,
    load_jax_params,
)
from apex_tpu_torch.optimizers import FusedAdam

VOCAB, SEQ, HID, LAYERS, HEADS, BATCH = 250, 32, 64, 2, 4, 4
LENS = (32, 20, 9, 27)
PAD = 0
SMOOTHING = 0.1
LR = 2e-3
LOSS_ATOL = {"fp32": 2e-6, "bf16": 1e-3}
MV_REL = {"fp32": 1e-5, "bf16": 0.1}
PARAM_REL_FP32 = 1e-5


def _configs(dt):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    shape = dict(vocab_size=VOCAB, max_seq_len=SEQ, hidden_size=HID,
                 num_layers=LAYERS, num_heads=HEADS)
    return RefConfig(dtype=jdt, **shape), GPTConfig(dtype=tdt, **shape)


def _batches(n, seed=0):
    """n batches of (tokens, labels) (b, s) int32, each label row's tail
    past its real length set to PAD (real labels are never PAD)."""
    rng = np.random.RandomState(seed)
    real = np.arange(SEQ)[None, :] < np.asarray(LENS)[:, None]
    out = []
    for _ in range(n):
        tokens = rng.randint(0, VOCAB, (BATCH, SEQ)).astype(np.int32)
        labels = rng.randint(1, VOCAB, (BATCH, SEQ)).astype(np.int32)
        out.append((tokens, np.where(real, labels, PAD).astype(np.int32)))
    return out


def _port_loss(model, tokens, labels):
    losses = softmax_cross_entropy(model(tokens.long()), labels.T,
                                   smoothing=SMOOTHING, padding_idx=PAD)
    return losses.sum() / (labels != PAD).sum()


def _unpack(state, buf):
    return jax.tree_util.tree_map(
        np.asarray, state.space.unpack(buf, dtype="buffer"))


def _key_bias_mask(cfg):
    hd = cfg.hidden_size // cfg.num_heads
    group = cfg.num_heads // cfg.kv_heads
    mask = torch.zeros(cfg.kv_heads, group + 2, hd, dtype=torch.bool)
    mask[:, group] = True
    return mask.reshape(-1)


@pytest.fixture(scope="module",
                params=["fp32-xla", "fp32-interpret", "bf16-xla"])
def trained(request):
    dt, impl = request.param.split("-")
    rcfg, cfg = _configs(dt)
    rmodel = RefGPT(rcfg)
    ropt = RefAdam(lr=LR, weight_decay=0.01, impl="xla")
    rs = ropt.init(ref_init(rcfg, jax.random.PRNGKey(0)))

    @jax.jit
    def ref_step(state, tokens, labels):
        def loss_of(p):
            losses = ref_xent(rmodel.apply(p, tokens), labels.T, SMOOTHING,
                              PAD, impl=impl)
            return jnp.sum(losses) / jnp.sum(labels != PAD)
        loss, grads = jax.value_and_grad(loss_of)(
            state.space.unpack(state.master))
        _, state = ropt.step(state, grads)
        return state, loss

    batches = _batches(4)
    rs, _ = ref_step(rs, *batches[0])
    model = load_jax_params(GPTModel(cfg, device="cpu"),
                            _unpack(rs, rs.master))
    step = PretrainStep(model, FusedAdam(lr=LR, weight_decay=0.01),
                        loss_fn=_port_loss)
    ps = load_jax_opt_state(step.init(), cfg, {
        "master": _unpack(rs, rs.master), "m": _unpack(rs, rs.slots["m"]),
        "v": _unpack(rs, rs.slots["v"]), "count": int(rs.count)})
    losses = []
    for tokens, labels in batches[1:]:
        rs, rl = ref_step(rs, tokens, labels)
        ps, pl = step(ps, tokens, labels)
        losses.append((float(rl), float(pl)))
    return dt, cfg, rs, ps, losses


def test_xentropy_losses_match_each_step(trained):
    dt, _, _, _, losses = trained
    for want, got in losses:
        assert np.isfinite(got)
        assert abs(got - want) <= LOSS_ATOL[dt], losses
    assert losses[-1][1] < losses[0][1]


def test_xentropy_state_matches_after_three_steps(trained):
    dt, cfg, rs, ps, _ = trained
    assert ps.count == int(rs.count) == 4
    key = _key_bias_mask(cfg)
    for name, rbuf, pbuf in (("master", rs.master, ps.master),
                             ("m", rs.slots["m"], ps.slots["m"]),
                             ("v", rs.slots["v"], ps.slots["v"])):
        want = gpt_params_from_jax(_unpack(rs, rbuf), cfg)
        got = ps.space.unpack(pbuf, "buffer")
        assert set(got) == set(want)
        diffs = []
        for leaf, w in want.items():
            diff = (got[leaf] - w).abs()
            diffs.append(diff.reshape(-1))
            if name == "master" and dt == "bf16":
                continue                     # held as a whole below
            if leaf.endswith("qkv.bias"):
                if name == "master":
                    assert float(diff[key].max()) <= 6 * LR, leaf
                diff, w = diff[~key], w[~key]
            rel = MV_REL[dt] if name != "master" else PARAM_REL_FP32
            assert float(diff.max()) <= rel * float(w.abs().max()), (
                name, leaf, float(diff.max()))
        if name == "master" and dt == "bf16":
            d = torch.cat(diffs)
            assert float(d.max()) <= 6 * LR
            assert float(d.mean()) <= LR / 20
            assert float((d > LR / 4).float().mean()) <= 0.01


def test_padded_labels_give_no_gradient_through_their_logits():
    """The pad positions' logits get exactly zero gradient: the loss of
    a padded row is a constant 0."""
    _, cfg = _configs("fp32")
    model = GPTModel(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    tokens, labels = _batches(1, seed=1)[0]
    logits = model(torch.from_numpy(tokens).long()).detach().requires_grad_()
    yt = torch.from_numpy(labels)
    loss = (softmax_cross_entropy(logits, yt.T, SMOOTHING, PAD).sum()
            / (yt != PAD).sum())
    loss.backward()
    pad = (yt.T == PAD)
    assert (logits.grad[pad] == 0).all()
    assert (logits.grad[~pad].abs().sum(-1) > 0).all()
