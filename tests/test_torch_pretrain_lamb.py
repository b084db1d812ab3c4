"""The GPT pretraining step with FusedLAMB, apex_tpu_torch against
apex_tpu.

A tiny GPT (2 layers, hidden 64, 4 heads, vocab 128, seq 32, batch 4)
trains in the reference — ``make_gpt_pretrain_step(cfg, FusedLAMB(lr=2e-3,
weight_decay=0.01, max_grad_norm=1.0, impl="xla"))`` on one device, built
with ``scan_layers=False`` — for one step; its weights and its LAMB
state (master, m, v, count) are converted into the port, and both take
the same three further steps through their default segmented layouts.
The losses are compared at each step, and every parameter, m and v
after the third, per parameter name (the two layouts order and pad
their leaves differently).

Why ``scan_layers=False``: with ``scan_layers=True`` the reference
stacks each kind of layer parameter into one leaf, so its trust ratios
span all layers at once, while the port has one leaf (one ratio) per
layer parameter.

Tolerances, as in ``test_torch_pretrain.py`` for Adam, with the clip
and the trust ratios (fp32 sums in another order, relative ~1e-7) on
top. fp32: losses within 2e-6; m, v and the parameters within 1e-5 of
each leaf's largest |value|, except the key bias, whose true gradient is
exactly zero (its computed gradient is rounding noise, normalised to
steps of up to ~lr): held within 6 lr in all. bf16 compute: losses
within 1e-3; m and v within 10% of each leaf's largest |value|; the
parameters all within 6 lr, their mean difference within lr / 20 and at
most 1% of them more than lr / 4 apart.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from apex_tpu.amp.scaler import LossScaler as RefScaler
from apex_tpu.models.gpt import GPTConfig as RefConfig
from apex_tpu.models.pretrain import init_gpt_pretrain_params as ref_init
from apex_tpu.models.pretrain import make_gpt_pretrain_step as ref_make
from apex_tpu.optimizers import FusedLAMB as RefLAMB
from apex_tpu.optimizers import make_train_step as ref_make_train_step

from apex_tpu_torch.amp import LossScaler
from apex_tpu_torch.models import (
    GPTConfig,
    GPTModel,
    gpt_params_from_jax,
    init_gpt_pretrain_params,
    load_jax_opt_state,
    load_jax_params,
    make_gpt_pretrain_step,
)
from apex_tpu_torch.optimizers import FusedLAMB, make_train_step

VOCAB, SEQ, HID, LAYERS, HEADS, BATCH = 128, 32, 64, 2, 4, 4
LR = 2e-3
LOSS_ATOL = {"fp32": 2e-6, "bf16": 1e-3}
MV_REL = {"fp32": 1e-5, "bf16": 0.1}
PARAM_REL_FP32 = 1e-5
LAMB_KW = dict(lr=LR, weight_decay=0.01, max_grad_norm=1.0)


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


def _key_bias_mask(cfg):
    hd = cfg.hidden_size // cfg.num_heads
    group = cfg.num_heads // cfg.kv_heads
    mask = torch.zeros(cfg.kv_heads, group + 2, hd, dtype=torch.bool)
    mask[:, group] = True
    return mask.reshape(-1)


@pytest.fixture(scope="module", params=["fp32", "bf16"])
def trained(request):
    dt = request.param
    rcfg, cfg = _configs(dt)
    params = ref_init(rcfg, jax.random.PRNGKey(0))
    ref_step, rs = ref_make(rcfg, RefLAMB(impl="xla", **LAMB_KW))(params)
    assert rs.seg_meta is not None
    batches = _batches(4)
    rs, _ = ref_step(rs, *batches[0])
    model = load_jax_params(GPTModel(cfg, device="cpu"),
                            _unpack(rs, rs.master))
    step, ps = make_gpt_pretrain_step(cfg, FusedLAMB(**LAMB_KW))(model)
    assert ps.seg_meta is not None
    ps = load_jax_opt_state(ps, cfg, {
        "master": _unpack(rs, rs.master), "m": _unpack(rs, rs.slots["m"]),
        "v": _unpack(rs, rs.slots["v"]), "count": int(rs.count)})
    losses = []
    for x, y in batches[1:]:
        rs, rl = ref_step(rs, x, y)
        ps, pl = step(ps, x, y)
        losses.append((float(rl), float(pl)))
    return dt, cfg, rs, ps, model, losses


def test_lamb_losses_match_each_step(trained):
    dt, _, _, _, _, losses = trained
    for want, got in losses:
        assert np.isfinite(got)
        assert abs(got - want) <= LOSS_ATOL[dt], losses


def test_lamb_state_matches_after_three_steps(trained):
    dt, cfg, rs, ps, _, _ = trained
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
                continue
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


def test_lamb_model_is_bound_to_the_segmented_master(trained):
    _, _, _, ps, model, _ = trained
    views = ps.space.unpack(ps.master, "buffer")
    off = 0
    for name, p in model.named_parameters():
        assert p.data_ptr() == views[name].data_ptr()
        off += -(-p.numel() // 2048) * 2048
    # the segmented layout pads where the plain one does not
    assert ps.space.total >= off


def test_lamb_scaler_step_with_grad_norm_and_overflow(trained):
    """``make_train_step(opt, scaler=..., with_grad_norm=True)`` on the
    tiny GPT's state: the reported norms match the reference's on the
    same gradient (per parameter name), then an inf in the gradient is
    skipped on both sides with the state unchanged and the scale backed
    off."""
    dt, cfg, rs, ps, _, _ = trained
    rstep = ref_make_train_step(RefLAMB(impl="xla", **LAMB_KW),
                                scaler=RefScaler(), with_grad_norm=True)
    pstep = make_train_step(FusedLAMB(**LAMB_KW), scaler=LossScaler(),
                            with_grad_norm=True)
    rng = np.random.RandomState(5)
    names = {k: v.shape for k, v in gpt_params_from_jax(
        _unpack(rs, rs.master), cfg).items()}
    grads = {k: (2.0 ** 10 * rng.randn(*s)).astype(np.float32)
             for k, s in names.items()}
    # the same gradient in both layouts, by name
    rtree = jax.tree_util.tree_map(np.asarray, _unpack(rs, rs.master))
    rg_tree = _tree_like(rtree, grads, cfg)
    rg = np.asarray(rs.space.pack(rg_tree))
    pg = ps.space.pack({k: torch.from_numpy(v) for k, v in grads.items()})
    rs2, rss, raux = rstep(rs, jnp.asarray(rg), rstep.scaler.init())
    master = ps.master.clone()
    ps2, pss, aux = pstep(ps, pg, pstep.scaler.init())
    assert float(aux.found_inf) == float(raux.found_inf) == 0.0
    np.testing.assert_allclose(float(aux.grad_norm), float(raux.grad_norm),
                               rtol=1e-5)
    want = dict(zip(_leaf_names(rtree, cfg),
                    np.asarray(raux.grad_norm_per_tensor)))
    got = dict(zip(ps.space.names, aux.grad_norm_per_tensor.numpy()))
    for name in names:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5)
    # overflow: skipped, nothing moves, the scale halves
    pg[123] = float("inf")
    before = (ps2.master.clone(), ps2.slots["m"].clone(), ps2.count)
    ps3, pss3, aux3 = pstep(ps2, pg, pss)
    assert float(aux3.found_inf) == 1.0
    assert torch.equal(ps3.master, before[0])
    assert torch.equal(ps3.slots["m"], before[1])
    assert ps3.count == before[2]
    assert pss3.loss_scale == pss.loss_scale / 2
    ps.master.copy_(master)


def _leaf_names(rtree, cfg):
    """The port's parameter name of each leaf of the reference's tree, in
    the reference's flat order."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(rtree)
    return [_name_of([getattr(k, "key", str(k)) for k in path], cfg)
            for path, _ in leaves]


def _name_of(keys, cfg):
    from apex_tpu_torch.models.convert import _LAYER_KEYS, _TOP_KEYS
    path = "/".join(k for k in keys if k != "params")
    for name, p in _TOP_KEYS.items():
        if p == path:
            return name
    for i in range(cfg.num_layers):
        for name, p in _LAYER_KEYS.items():
            if f"layer_{i}/{p}" == path:
                return f"layers.{i}.{name}"
    raise KeyError(path)


def _tree_like(rtree, grads, cfg):
    leaves, treedef = jax.tree_util.tree_flatten_with_path(rtree)
    vals = []
    for path, leaf in leaves:
        keys = [getattr(k, "key", str(k)) for k in path]
        vals.append(jnp.asarray(grads[_name_of(keys, cfg)].reshape(
            leaf.shape)))
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(rtree), vals)


def test_lamb_loss_falls_over_steps_on_one_batch():
    _, cfg = _configs("fp32")
    for segmented in (True, False):
        model = init_gpt_pretrain_params(
            cfg, torch.Generator().manual_seed(0), device="cpu")
        step, state = make_gpt_pretrain_step(
            cfg, FusedLAMB(lr=1e-2, weight_decay=0.01,
                           segmented=segmented))(model)
        assert (state.seg_meta is not None) == segmented
        x, y = _batches(1, seed=3)[0]
        losses = []
        for _ in range(5):
            state, loss = step(state, x, y)
            losses.append(float(loss))
        assert all(np.isfinite(losses)) and losses[-1] < losses[0]
