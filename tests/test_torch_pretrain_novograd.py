"""GPT pretraining with FusedNovoGrad and the contrib gradient clip, and
with FusedAdagrad under the dynamic loss scaler: apex_tpu_torch against
apex_tpu.

A tiny GPT (2 layers, hidden 64, 4 heads, vocab 128, seq 32, batch 4),
built with ``scan_layers=False`` on the reference side (stacked layers
would share one per-leaf norm: NovoGrad's v is one value a leaf).

- NovoGrad + clip: the reference's user loop, ``jax.grad`` of the loss,
  ``clip_grad_norm_(grads, 1.0)``, ``FusedNovoGrad(lr=1e-2, betas=(0.95,
  0.98), weight_decay=1e-3).step``, against the port's
  ``PretrainStep.backward``, ``clip_grad_norm_(step.grad, 1.0)`` (the
  flat buffer, in place) and ``FusedNovoGrad.step_flat``.
- Adagrad + scaler: ``make_train_step(FusedAdagrad(lr=1e-3,
  weight_decay=0.01), scaler=LossScaler(), max_grad_norm=1.0)`` on both
  sides, the port's through ``PretrainStep(..., train_step=...)``; after
  the three steps, one with an inf injected into the gradient, which
  both skip.

The reference takes one step first; its weights, optimizer state
(master, m and the per-leaf v, or h; count) and scaler state are carried
into the port (``load_jax_params``, ``load_jax_opt_state``), and both
take the same three further steps. The losses are compared at each step,
and every parameter and slot after the third, per parameter name (the
two layouts order their leaves differently; NovoGrad's v by leaf name).

Tolerances, as in ``test_torch_pretrain.py`` and
``test_torch_pretrain_lamb.py``. fp32: losses within 2e-6; slots and
parameters within 1e-5 of each leaf's largest |value| (sums in other
orders; the clip's norm and NovoGrad's per-leaf norms included), v
within 1e-5 relative. Adagrad normalises each element's gradient as
Adam does, so the key bias, whose true gradient is exactly zero
(rounding noise on each side), moves by steps of up to about lr in
either direction: it is held within 6 lr in all. NovoGrad normalises by
the leaf's norm, which the query and value biases dominate, so its key
bias needs no exception. bf16 compute (activations and gradients ~1%
apart): losses within 1e-3; slots within 10% of each leaf's largest
|value|, v within 10% relative; the parameters all within 6 lr, their
mean difference within lr / 20 and at most 1% of them more than lr / 4
apart.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from apex_tpu.amp.scaler import LossScaler as RefScaler
from apex_tpu.contrib.clip_grad import clip_grad_norm_ as ref_clip
from apex_tpu.models.gpt import GPTConfig as RefConfig
from apex_tpu.models.gpt import GPTModel as RefGPT
from apex_tpu.models.gpt import gpt_loss_fn as ref_loss
from apex_tpu.models.pretrain import init_gpt_pretrain_params as ref_init
from apex_tpu.optimizers import FusedAdagrad as RefAdagrad
from apex_tpu.optimizers import FusedNovoGrad as RefNovoGrad
from apex_tpu.optimizers import make_train_step as ref_make_train_step

from apex_tpu_torch.amp import LossScaler
from apex_tpu_torch.contrib.clip_grad import clip_grad_norm_
from apex_tpu_torch.models import (
    GPTConfig,
    GPTModel,
    PretrainStep,
    gpt_params_from_jax,
    load_jax_opt_state,
    load_jax_params,
)
from apex_tpu_torch.optimizers import (
    FusedAdagrad,
    FusedNovoGrad,
    make_train_step,
)

VOCAB, SEQ, HID, LAYERS, HEADS, BATCH = 128, 32, 64, 2, 4, 4
NOVO_KW = dict(lr=1e-2, betas=(0.95, 0.98), weight_decay=1e-3)
ADAGRAD_KW = dict(lr=1e-3, weight_decay=0.01)
LOSS_ATOL = {"fp32": 2e-6, "bf16": 1e-3}
SLOT_REL = {"fp32": 1e-5, "bf16": 0.1}
PARAM_REL_FP32 = 1e-5


def _configs(dt):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    shape = dict(vocab_size=VOCAB, max_seq_len=SEQ, hidden_size=HID,
                 num_layers=LAYERS, num_heads=HEADS)
    return (RefConfig(dtype=jdt, scan_layers=False, **shape),
            GPTConfig(dtype=tdt, **shape))


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


def _ref_grad_fn(rcfg):
    """jit(grad) of the reference's GPT loss times ``scale``: ``(loss,
    grads)``."""
    model = RefGPT(rcfg)

    def scaled(params, x, y, scale):
        loss = ref_loss(model.apply(params, x), y)
        return loss.astype(jnp.float32) * scale, loss

    return jax.jit(jax.grad(scaled, has_aux=True))


def _opt_state_np(rs):
    """The reference's state as ``load_jax_opt_state`` takes it."""
    d = {"master": _unpack(rs, rs.master), "count": int(rs.count)}
    for k, v in rs.slots.items():
        d[k] = (rs.space.treedef.unflatten(list(np.asarray(v)))
                if v.shape == (rs.space.num_leaves,) else _unpack(rs, v))
    return d


def _key_bias_mask(cfg):
    hd = cfg.hidden_size // cfg.num_heads
    group = cfg.num_heads // cfg.kv_heads
    mask = torch.zeros(cfg.kv_heads, group + 2, hd, dtype=torch.bool)
    mask[:, group] = True
    return mask.reshape(-1)


@pytest.fixture(scope="module", params=["fp32", "bf16"])
def novograd_run(request):
    dt = request.param
    rcfg, cfg = _configs(dt)
    grad_of = _ref_grad_fn(rcfg)
    ropt = RefNovoGrad(impl="xla", **NOVO_KW)
    rs = ropt.init(ref_init(rcfg, jax.random.PRNGKey(0)))

    def ref_step(rs, x, y):
        grads, loss = grad_of(rs.space.unpack(rs.master), x, y, 1.0)
        grads, _ = ref_clip(grads, 1.0, impl="xla")
        _, rs = ropt.step(rs, grads)
        return rs, float(loss)

    batches = _batches(4)
    rs, _ = ref_step(rs, *batches[0])
    model = load_jax_params(GPTModel(cfg, device="cpu"),
                            _unpack(rs, rs.master))
    opt = FusedNovoGrad(**NOVO_KW)
    step = PretrainStep(model, opt)
    ps = load_jax_opt_state(step.init(), cfg, _opt_state_np(rs))
    losses, norms = [], []
    for x, y in batches[1:]:
        rs, rl = ref_step(rs, x, y)
        loss = step.backward(ps, x, y)
        grad, norm = clip_grad_norm_(step.grad, 1.0)
        assert grad is step.grad
        _, ps = opt.step_flat(ps, step.grad)
        losses.append((rl, float(loss)))
        norms.append(float(norm))
    return dt, cfg, rs, ps, step, losses, norms


def _compare(dt, cfg, rs, ps, lr, key_bias_exempt):
    """Every parameter and flat slot per name, and per-leaf slots per
    leaf name (module docstring)."""
    key = _key_bias_mask(cfg)
    for name in ("master", *rs.slots):
        rbuf = rs.master if name == "master" else rs.slots[name]
        pbuf = ps.master if name == "master" else ps.slots[name]
        if rbuf.shape == (rs.space.num_leaves,):
            want = gpt_params_from_jax(
                _by_path(rs, np.asarray(rbuf)), cfg)
            got = dict(zip(ps.space.names, pbuf))
            for leaf, w in want.items():
                np.testing.assert_allclose(float(got[leaf]), float(w),
                                           rtol=SLOT_REL[dt], err_msg=leaf)
            continue
        want = gpt_params_from_jax(_unpack(rs, rbuf), cfg)
        got = ps.space.unpack(pbuf, "buffer")
        assert set(got) == set(want)
        diffs = []
        for leaf, w in want.items():
            diff = (got[leaf] - w).abs()
            diffs.append(diff.reshape(-1))
            if name == "master" and dt == "bf16":
                continue
            if key_bias_exempt and leaf.endswith("qkv.bias"):
                if name == "master":
                    assert float(diff[key].max()) <= 6 * lr, leaf
                diff, w = diff[~key], w[~key]
            rel = SLOT_REL[dt] if name != "master" else PARAM_REL_FP32
            assert float(diff.max()) <= rel * float(w.abs().max()), (
                name, leaf, float(diff.max()))
        if name == "master" and dt == "bf16":
            d = torch.cat(diffs)
            assert float(d.max()) <= 6 * lr
            assert float(d.mean()) <= lr / 20
            assert float((d > lr / 4).float().mean()) <= 0.01


def _by_path(rs, per_leaf):
    """``{tree path: value}`` of a per-leaf buffer in the reference's leaf
    order."""
    tree = rs.space.treedef.unflatten(list(per_leaf))
    leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(getattr(k, "key", str(k)) for k in path
                     if getattr(k, "key", None) != "params"): np.float32(v)
            for path, v in leaves}


def test_novograd_losses_match_each_step(novograd_run):
    dt, _, _, _, _, losses, norms = novograd_run
    for want, got in losses:
        assert np.isfinite(got)
        assert abs(got - want) <= LOSS_ATOL[dt], losses
    assert all(np.isfinite(norms))


def test_novograd_state_matches_after_three_steps(novograd_run):
    dt, cfg, rs, ps, _, _, _ = novograd_run
    assert ps.count == int(rs.count) == 4
    assert ps.slots["v"].shape == (ps.space.num_leaves,)
    _compare(dt, cfg, rs, ps, NOVO_KW["lr"], key_bias_exempt=False)


def test_novograd_model_stays_bound_to_the_master(novograd_run):
    _, _, _, ps, step, _, _ = novograd_run
    views = ps.space.unpack(ps.master, "buffer")
    for name, p in step.model.named_parameters():
        assert p.data_ptr() == views[name].data_ptr()


def test_clip_on_the_flat_gradient_matches_reference_norm():
    """The clip on ``PretrainStep.grad`` (the port's flat layout, in place)
    against the reference's on its gradient tree: the same norm, and the
    clipped gradient per parameter name."""
    rcfg, cfg = _configs("fp32")
    params = ref_init(rcfg, jax.random.PRNGKey(1))
    x, y = _batches(1, seed=2)[0]
    grads, _ = _ref_grad_fn(rcfg)(params, x, y, 1.0)
    want, wnorm = ref_clip(grads, 0.5, impl="xla")
    model = load_jax_params(GPTModel(cfg, device="cpu"),
                            jax.tree_util.tree_map(np.asarray, params))
    step = PretrainStep(model, FusedNovoGrad(**NOVO_KW))
    state = step.init()
    step.backward(state, x, y)
    _, norm = clip_grad_norm_(step.grad, 0.5)
    np.testing.assert_allclose(float(norm), float(wnorm), rtol=1e-5)
    assert float(norm) > 0.5
    want = gpt_params_from_jax(jax.tree_util.tree_map(np.asarray, want), cfg)
    got = state.space.unpack(step.grad, "buffer")
    key = _key_bias_mask(cfg)
    for leaf, w in want.items():
        d, w = (got[leaf] - w).abs(), w.abs()
        if leaf.endswith("qkv.bias"):
            d, w = d[~key], w[~key]
        assert float(d.max()) <= 1e-5 * float(w.max()), leaf


@pytest.fixture(scope="module", params=["fp32", "bf16"])
def adagrad_run(request):
    dt = request.param
    rcfg, cfg = _configs(dt)
    grad_of = _ref_grad_fn(rcfg)
    ropt = RefAdagrad(impl="xla", **ADAGRAD_KW)
    rstep = ref_make_train_step(ropt, scaler=RefScaler(), max_grad_norm=1.0)
    rs = ropt.init(ref_init(rcfg, jax.random.PRNGKey(0)))
    rss = rstep.scaler.init()

    def ref_step(rs, rss, x, y, poison=False):
        grads, loss = grad_of(rs.space.unpack(rs.master), x, y,
                              rss.loss_scale)
        g = rs.space.pack(grads, dtype=jnp.float32)
        if poison:
            g = g.at[123].set(jnp.inf)
        rs, rss, aux = rstep(rs, g, rss)
        return rs, rss, float(loss), float(aux.found_inf)

    batches = _batches(5)
    rs, rss, _, _ = ref_step(rs, rss, *batches[0])
    model = load_jax_params(GPTModel(cfg, device="cpu"),
                            _unpack(rs, rs.master))
    opt = FusedAdagrad(**ADAGRAD_KW)
    tstep = make_train_step(opt, scaler=LossScaler(), max_grad_norm=1.0)
    step = PretrainStep(model, opt, train_step=tstep)
    ps = load_jax_opt_state(step.init(), cfg, _opt_state_np(rs))
    pss = tstep.scaler.load_state_dict(RefScaler().state_dict(rss))
    losses = []
    for x, y in batches[1:4]:
        rs, rss, rl, _ = ref_step(rs, rss, x, y)
        ps, pss, loss = step(ps, x, y, scaler_state=pss)
        losses.append((rl, float(loss)))
    return dt, cfg, rs, rss, ps, pss, step, losses, batches[4], ref_step


def test_adagrad_losses_match_each_step(adagrad_run):
    dt, *_, losses, _, _ = adagrad_run
    for want, got in losses:
        assert np.isfinite(got)
        assert abs(got - want) <= LOSS_ATOL[dt], losses


def test_adagrad_state_and_scaler_match_after_three_steps(adagrad_run):
    dt, cfg, rs, rss, ps, pss, *_ = adagrad_run
    assert ps.count == int(rs.count) == 4
    assert (pss.loss_scale, pss.unskipped) == (float(rss.loss_scale),
                                               int(rss.unskipped))
    _compare(dt, cfg, rs, ps, ADAGRAD_KW["lr"], key_bias_exempt=True)


def test_adagrad_overflow_step_is_skipped_on_both_sides(adagrad_run):
    """An inf in the gradient: both sides skip, the port's master and h
    exactly as they were, the scale halved."""
    dt, cfg, rs, rss, ps, pss, step, _, (x, y), ref_step = adagrad_run
    rs2, rss2, _, rfound = ref_step(rs, rss, x, y, poison=True)
    master, h, count = ps.master.clone(), ps.slots["h"].clone(), ps.count
    step.backward(ps, x, y, scaler_state=pss)
    step.grad[123] = float("inf")
    ps2, pss2, aux = step.train_step(ps, step.grad, pss)
    assert float(aux.found_inf) == rfound == 1.0
    assert torch.equal(ps2.master, master) and torch.equal(ps2.slots["h"], h)
    assert ps2.count == count == int(rs2.count)
    assert pss2.loss_scale == float(rss2.loss_scale) == pss.loss_scale / 2
