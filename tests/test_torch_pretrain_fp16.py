"""GPT pretraining in fp16 and fp32 under the dynamic loss scaler:
apex_tpu_torch against apex_tpu.

The example's own dtype is fp32 (``examples/gpt_pretrain/pretrain_gpt.py``
without ``--bf16``), and amp's compute type is fp16; both now reach the
port's flash, LayerNorm and softmax kernels on the card. Here a tiny GPT
(2 layers, hidden 64, 4 heads, vocab 128, seq 32, batch 4) at
``dtype=float16`` (flash and softmax attention backends) and at
``dtype=float32`` (flash) trains on both sides through
``make_train_step(FusedAdam(lr=2e-3, weight_decay=0.01), scaler=
LossScaler(init_scale=2^10))``: the reference's ``jax.grad`` of its GPT
loss times the scale, packed flat, into its train step; the port's
``PretrainStep(..., train_step=...)``. The reference takes one step
first; its weights, Adam state and scaler state are carried into the
port, and both take the same three further steps. The port runs its plain
PyTorch versions on the CPU (the kernel path is held against the plain
path on the card by ``chip_smoke.py``).

Tolerances. fp32, as ``test_torch_pretrain.py``: losses within 2e-6; m,
v and the parameters within 1e-5 of each leaf's largest |value| (the key
bias, whose true gradient is exactly zero, within 6 lr in all). fp16: the
two frameworks round activations and gradients to fp16 at different
points (~0.1% apart, 8x finer than bf16), and Adam normalises a gradient
of any size to a step of about lr: losses within 2e-4 (observed 2.2e-5);
m and v within 1% of each leaf's largest |value| (observed 0.14% and
0.19%); the parameters all within 6 lr (observed 4.2 lr), their mean
difference within lr / 20 (observed lr / 400) and at most 1% of them more
than lr / 4 apart (observed 0.1%). The scale and the skipped steps
exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from apex_tpu.amp.scaler import LossScaler as RefScaler
from apex_tpu.models.gpt import GPTConfig as RefConfig
from apex_tpu.models.gpt import GPTModel as RefGPT
from apex_tpu.models.gpt import gpt_loss_fn as ref_loss
from apex_tpu.models.pretrain import init_gpt_pretrain_params as ref_init
from apex_tpu.optimizers import FusedAdam as RefAdam
from apex_tpu.optimizers import make_train_step as ref_make_train_step

from apex_tpu_torch.amp import LossScaler
from apex_tpu_torch.models import (
    GPTConfig,
    GPTModel,
    PretrainStep,
    gpt_params_from_jax,
    load_jax_opt_state,
    load_jax_params,
)
from apex_tpu_torch.optimizers import FusedAdam, make_train_step

VOCAB, SEQ, HID, LAYERS, HEADS, BATCH = 128, 32, 64, 2, 4, 4
LR = 2e-3
INIT_SCALE = 2.0 ** 10
LOSS_ATOL = {"fp32": 2e-6, "fp16": 2e-4}
SLOT_REL = {"fp32": {"m": 1e-5, "v": 1e-5}, "fp16": {"m": 0.01, "v": 0.01}}
PARAM_REL_FP32 = 1e-5


def _configs(name):
    dt, _, backend = name.partition("-")
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "fp16": (jnp.float16, torch.float16)}[dt]
    shape = dict(vocab_size=VOCAB, max_seq_len=SEQ, hidden_size=HID,
                 num_layers=LAYERS, num_heads=HEADS,
                 attention_backend=backend or "flash")
    return dt, RefConfig(dtype=jdt, **shape), GPTConfig(dtype=tdt, **shape)


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t = rng.randint(0, VOCAB, (BATCH, SEQ + 1)).astype(np.int32)
        out.append((t[:, :-1], t[:, 1:]))
    return out


def _unpack(state, buf):
    return jax.tree_util.tree_map(
        np.asarray, state.space.unpack(buf, dtype="buffer"))


def _key_bias_mask(cfg):
    hd = cfg.hidden_size // cfg.num_heads
    group = cfg.num_heads // cfg.kv_heads
    mask = torch.zeros(cfg.kv_heads, group + 2, hd, dtype=torch.bool)
    mask[:, group] = True
    return mask.reshape(-1)


@pytest.fixture(scope="module", params=["fp32", "fp16", "fp16-softmax"])
def trained(request):
    dt, rcfg, cfg = _configs(request.param)
    model_ref = RefGPT(rcfg)

    def scaled(params, x, y, scale):
        loss = ref_loss(model_ref.apply(params, x), y)
        return loss.astype(jnp.float32) * scale, loss

    grad_of = jax.jit(jax.grad(scaled, has_aux=True))
    ropt = RefAdam(lr=LR, weight_decay=0.01, impl="xla")
    rstep = ref_make_train_step(ropt, scaler=RefScaler(init_scale=INIT_SCALE))
    rs = ropt.init(ref_init(rcfg, jax.random.PRNGKey(0)))
    rss = rstep.scaler.init()

    def ref_step(rs, rss, x, y):
        grads, loss = grad_of(rs.space.unpack(rs.master), x, y,
                              rss.loss_scale)
        rs, rss, aux = rstep(rs, rs.space.pack(grads, dtype=jnp.float32),
                             rss)
        return rs, rss, float(loss), float(aux.found_inf)

    batches = _batches(4)
    rs, rss, _, _ = ref_step(rs, rss, *batches[0])
    model = load_jax_params(GPTModel(cfg, device="cpu"),
                            _unpack(rs, rs.master))
    opt = FusedAdam(lr=LR, weight_decay=0.01)
    tstep = make_train_step(opt, scaler=LossScaler(init_scale=INIT_SCALE))
    step = PretrainStep(model, opt, train_step=tstep)
    ps = load_jax_opt_state(step.init(), cfg, {
        "master": _unpack(rs, rs.master), "m": _unpack(rs, rs.slots["m"]),
        "v": _unpack(rs, rs.slots["v"]), "count": int(rs.count)})
    pss = tstep.scaler.load_state_dict(
        RefScaler(init_scale=INIT_SCALE).state_dict(rss))
    losses, scales = [], []
    for x, y in batches[1:]:
        rs, rss, rl, rfound = ref_step(rs, rss, x, y)
        ps, pss, loss = step(ps, x, y, scaler_state=pss)
        losses.append((rl, float(loss)))
        scales.append((float(rss.loss_scale), float(pss.loss_scale)))
    return dt, cfg, rs, ps, step, losses, scales


def test_losses_and_scales_match_each_step(trained):
    dt, _, _, _, _, losses, scales = trained
    for want, got in losses:
        assert np.isfinite(got)
        assert abs(got - want) <= LOSS_ATOL[dt], losses
    for want, got in scales:
        assert got == want, scales


def test_state_matches_after_three_steps(trained):
    dt, cfg, rs, ps, _, _, _ = trained
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
            if name == "master" and dt == "fp16":
                continue                     # held as a whole below
            if dt == "fp32" and leaf.endswith("qkv.bias"):
                if name == "master":
                    assert float(diff[key].max()) <= 6 * LR, leaf
                diff, w = diff[~key], w[~key]
            rel = (PARAM_REL_FP32 if name == "master"
                   else SLOT_REL[dt][name])
            assert float(diff.max()) <= rel * float(w.abs().max()), (
                name, leaf, float(diff.max()))
        if name == "master" and dt == "fp16":
            d = torch.cat(diffs)
            assert float(d.max()) <= 6 * LR
            assert float(d.mean()) <= LR / 20
            assert float((d > LR / 4).float().mean()) <= 0.01


def test_fp16_gradients_that_overflow_are_skipped_on_both_sides():
    """At a scale of 2^24 the fp16 backward overflows: both sides find
    inf, skip the update (count and master as they were) and halve the
    scale."""
    dt, rcfg, cfg = _configs("fp16")
    model_ref = RefGPT(rcfg)
    big = 2.0 ** 24

    def scaled(params, x, y, scale):
        loss = ref_loss(model_ref.apply(params, x), y)
        return loss.astype(jnp.float32) * scale, loss

    ropt = RefAdam(lr=LR, impl="xla")
    rstep = ref_make_train_step(ropt, scaler=RefScaler(init_scale=big))
    params = ref_init(rcfg, jax.random.PRNGKey(1))
    rs, rss = ropt.init(params), rstep.scaler.init()
    x, y = _batches(1, seed=3)[0]
    grads, _ = jax.grad(scaled, has_aux=True)(rs.space.unpack(rs.master), x,
                                              y, rss.loss_scale)
    rs2, rss2, raux = rstep(rs, rs.space.pack(grads, dtype=jnp.float32), rss)
    model = load_jax_params(GPTModel(cfg, device="cpu"),
                            jax.tree_util.tree_map(np.asarray, params))
    opt = FusedAdam(lr=LR)
    tstep = make_train_step(opt, scaler=LossScaler(init_scale=big))
    step = PretrainStep(model, opt, train_step=tstep)
    ps, pss = step.init(), tstep.scaler.init()
    master = ps.master.clone()
    ps2, pss2, loss = step(ps, x, y, scaler_state=pss)
    assert np.isfinite(float(loss))
    assert float(raux.found_inf) == 1.0
    assert pss2.loss_scale == float(rss2.loss_scale) == big / 2
    assert ps2.count == int(rs2.count) == 0
    assert torch.equal(ps2.master, master)
