"""``apex_tpu_torch.fp16_utils`` against ``apex_tpu.fp16_utils`` on the
CPU.

- The casts (``tofp16``, ``network_to_half``, ``bn_convert_float``) and
  the master/model copies give each parameter name the reference's
  dtype, on a name set with BatchNorm, ``bn`` and GroupNorm leaves and
  an integer leaf.
- ``DynamicLossScaler``: 2^32 at the start, window 1000, growth past
  amp's 2^24 cap, as the reference's.
- ``FP16_Optimizer(FusedAdam, dynamic_loss_scale=True)`` over six steps
  with an inf in the gradients of step 3 (index fixed): the skip and
  scale sequences equal the reference's; m and v bitwise; p within the
  Adam bound ``tests/test_torch_adam.py`` states for one step (XLA's CPU
  compiler contracts the update's multiply-adds: two ulps of the step and
  one of p), summed over the steps taken; a skipped step leaves the master
  bitwise as it was. The gradients are fixed sets drawn from the seed,
  one a step, times the loss scale of the step on each side, so both
  optimizers see the same bits.
- ``FP16_Optimizer.train_step`` is ``make_train_step`` over the
  optimizer and the scaler, skipping exactly when the scale is dynamic;
  as a ``PretrainStep``'s ``train_step`` it takes the same steps, skips
  included, as ``FP16_Optimizer.step`` on the same gradients (masters
  and scales bitwise).
- A static scale skips nothing (an inf reaches the parameters on both
  sides), and a ``state_dict`` round trip gives a state that steps as the
  original does.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from apex_tpu import fp16_utils as ref_fp16
from apex_tpu.optimizers import FusedAdam as RefAdam

from apex_tpu_torch import fp16_utils
from apex_tpu_torch.models import PretrainStep
from apex_tpu_torch.optimizers import FusedAdam, TrainStep

SHAPES = {"b": (3,), "bn1.bias": (3,), "bn1.scale": (3,), "w": (5, 3)}
STEPS, INF_STEP = 6, 3


def _tree_names():
    """A nested tree (the reference's) and its '.'-joined names (the
    port's), with norm leaves, a 16-bit leaf and an integer leaf."""
    r = np.random.RandomState(0)
    tree = {
        "conv1": {"kernel": r.randn(3, 3).astype(np.float32)},
        "bn1": {"scale": r.randn(3).astype(np.float32),
                "bias": r.randn(3).astype(np.float16)},
        "layer1": {"BatchNorm_0": {"scale": r.randn(4).astype(np.float32)},
                   "Dense_0": {"kernel": r.randn(4, 2).astype(np.float16)}},
        "GroupNorm_0": {"scale": r.randn(2).astype(np.float16)},
        "decoder": {"group_norm": {"bias": r.randn(2).astype(np.float32)}},
        "steps": np.arange(3, dtype=np.int32),
    }
    flat = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, prefix + k + ".")
            else:
                flat[prefix + k] = v
    walk(tree, "")
    return tree, flat


def _ref_dtypes(tree):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[".".join(str(k.key) for k in path)] = str(leaf.dtype)
    return out


def _port_dtypes(d):
    return {k: str(v.dtype).replace("torch.", "") for k, v in d.items()}


@pytest.mark.parametrize("fn", ["tofp16", "network_to_half",
                                "bn_convert_float",
                                "model_grads_to_master_grads"])
def test_casts_give_the_references_dtypes(fn):
    tree, flat = _tree_names()
    want = _ref_dtypes(getattr(ref_fp16, fn)(
        jax.tree.map(jnp.asarray, tree)))
    got = _port_dtypes(getattr(fp16_utils, fn)(
        {k: torch.from_numpy(v.copy()) for k, v in flat.items()}))
    assert got == want


def test_master_copies():
    tree, flat = _tree_names()
    half = ref_fp16.tofp16(jax.tree.map(jnp.asarray, tree))
    rmodel, rmaster = ref_fp16.prep_param_lists(half)
    pmodel, pmaster = fp16_utils.prep_param_lists(fp16_utils.tofp16(
        {k: torch.from_numpy(v.copy()) for k, v in flat.items()}))
    assert _port_dtypes(pmodel) == _ref_dtypes(rmodel)
    assert _port_dtypes(pmaster) == _ref_dtypes(rmaster)
    back = fp16_utils.master_params_to_model_params(pmaster, pmodel)
    assert _port_dtypes(back) == _ref_dtypes(
        ref_fp16.master_params_to_model_params(rmaster, rmodel))
    for k, v in back.items():
        assert torch.equal(v, pmodel[k])
    assert fp16_utils.to_python_float(torch.tensor(2.5)) == 2.5


def test_dynamic_loss_scaler_grows_without_cap():
    ref, port = ref_fp16.DynamicLossScaler(), fp16_utils.DynamicLossScaler()
    rs, ps = ref.init(), port.init()
    assert float(rs.loss_scale) == ps.loss_scale == 2.0 ** 32
    for _ in range(1000):
        rs, ps = ref.update(rs, 0.0), port.update(ps, 0.0)
    assert float(rs.loss_scale) == ps.loss_scale == 2.0 ** 33
    assert int(rs.unskipped) == ps.unskipped == 0
    rs, ps = ref.update(rs, 1.0), port.update(ps, 1.0)
    assert float(rs.loss_scale) == ps.loss_scale == 2.0 ** 32


def _params0():
    r = np.random.RandomState(1)
    return {k: r.randn(*s).astype(np.float32) for k, s in SHAPES.items()}


def _grad_sets():
    r = np.random.RandomState(2)
    sets = [{k: r.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
            for _ in range(STEPS)]
    sets[INF_STEP]["w"][2, 1] = np.inf
    return sets


def _ref_tree(flat):
    return {"b": flat["b"], "bn1": {"bias": flat["bn1.bias"],
                                    "scale": flat["bn1.scale"]},
            "w": flat["w"]}


def _ref_flat(tree):
    return {"b": tree["b"], "bn1.bias": tree["bn1"]["bias"],
            "bn1.scale": tree["bn1"]["scale"], "w": tree["w"]}


def _opts(**kw):
    ref = ref_fp16.FP16_Optimizer(RefAdam(lr=1e-2, weight_decay=0.01,
                                          impl="xla"), **kw)
    port = fp16_utils.FP16_Optimizer(FusedAdam(lr=1e-2, weight_decay=0.01),
                                     **kw)
    return ref, port


def _scaled(g, scale):
    return {k: (v * np.float32(scale)).astype(np.float32)
            for k, v in g.items()}


def test_fp16_optimizer_skips_and_scales_as_the_reference():
    ref, port = _opts(dynamic_loss_scale=True)
    p0 = _params0()
    rs = ref.init(jax.tree.map(jnp.asarray, _ref_tree(p0)))
    ps = port.init({k: torch.from_numpy(v.copy()) for k, v in p0.items()})
    bound = {k: np.zeros(s, np.float64) for k, s in SHAPES.items()}
    prev = dict(p0)
    r_scales, p_scales, r_skips, p_skips = [], [], [], []
    for g in _grad_sets():
        r_scale, p_scale = float(rs.scaler_state.loss_scale), \
            port.loss_scale(ps)
        assert r_scale == p_scale
        master_before = ps.opt_state.master.clone()
        rparams, rs = ref.step(rs, jax.tree.map(
            jnp.asarray, _ref_tree(_scaled(g, r_scale))))
        pparams, ps = port.step(ps, {k: torch.from_numpy(v) for k, v in
                                     _scaled(g, p_scale).items()})
        r_skips.append(float(rs.opt_state.found_inf))
        p_skips.append(float(ps.opt_state.found_inf))
        r_scales.append(float(rs.scaler_state.loss_scale))
        p_scales.append(port.loss_scale(ps))
        if p_skips[-1]:
            assert torch.equal(ps.opt_state.master, master_before)
        want = {k: np.asarray(v) for k, v in _ref_flat(rparams).items()}
        got = {k: v.detach().numpy() for k, v in pparams.items()}
        for k in SHAPES:
            bound[k] += (2 * np.spacing(np.abs(got[k] - prev[k]))
                         + np.spacing(np.abs(got[k])))
            assert (np.abs(got[k] - want[k]) <= bound[k]).all(), k
            prev[k] = got[k].copy()
    assert p_skips == r_skips == [float(i == INF_STEP)
                                  for i in range(STEPS)]
    assert p_scales == r_scales
    assert p_scales[INF_STEP] == p_scales[0] / 2
    for key in ("m", "v"):
        want = _ref_flat(rs.opt_state.space.unpack(
            rs.opt_state.slots[key], dtype="buffer"))
        got = ps.opt_state.space.unpack(ps.opt_state.slots[key],
                                        dtype="buffer")
        for k in SHAPES:
            np.testing.assert_array_equal(got[k].numpy().view(np.int32),
                                          np.asarray(want[k]).view(np.int32))
    assert ps.opt_state.count == int(rs.opt_state.count) == STEPS - 1


def test_static_scale_skips_nothing():
    ref, port = _opts(static_loss_scale=128.0)
    p0, g = _params0(), _grad_sets()[INF_STEP]
    rs = ref.init(jax.tree.map(jnp.asarray, _ref_tree(p0)))
    ps = port.init({k: torch.from_numpy(v.copy()) for k, v in p0.items()})
    rparams, rs = ref.step(rs, jax.tree.map(jnp.asarray,
                                            _ref_tree(_scaled(g, 128.0))))
    pparams, ps = port.step(ps, {k: torch.from_numpy(v) for k, v in
                                 _scaled(g, 128.0).items()})
    assert not np.isfinite(np.asarray(rparams["w"])).all()
    assert not bool(torch.isfinite(pparams["w"]).all())
    assert port.loss_scale(ps) == float(rs.scaler_state.loss_scale) == 128.0


def test_state_dict_round_trip():
    _, port = _opts(dynamic_loss_scale=True)
    p0, sets = _params0(), _grad_sets()
    ps = port.init({k: torch.from_numpy(v.copy()) for k, v in p0.items()})
    for g in sets[:4]:
        _, ps = port.step(ps, {k: torch.from_numpy(v) for k, v in
                               _scaled(g, port.loss_scale(ps)).items()})
    sd = port.state_dict(ps)
    fresh = port.init({k: torch.from_numpy(v.copy()) for k, v in p0.items()})
    loaded = port.load_state_dict(fresh, sd)
    assert torch.equal(loaded.opt_state.master, ps.opt_state.master)
    for k in ps.opt_state.slots:
        assert torch.equal(loaded.opt_state.slots[k], ps.opt_state.slots[k])
    assert loaded.opt_state.count == ps.opt_state.count
    assert loaded.scaler_state == ps.scaler_state
    g = {k: torch.from_numpy(v) for k, v in
         _scaled(sets[4], port.loss_scale(ps)).items()}
    _, a = port.step(ps, g)
    _, b = port.step(loaded, g)
    assert torch.equal(a.opt_state.master, b.opt_state.master)
    assert a.scaler_state == b.scaler_state


@pytest.mark.parametrize("dynamic", [True, False])
def test_train_step_is_make_train_step(dynamic):
    kw = ({"dynamic_loss_scale": True} if dynamic
          else {"static_loss_scale": 128.0})
    opt = fp16_utils.FP16_Optimizer(FusedAdam(lr=1e-2), **kw)
    ts = opt.train_step
    assert isinstance(ts, TrainStep)
    assert ts.opt is opt.optimizer and ts.scaler is opt.loss_scaler
    assert ts.skip_if_nonfinite is dynamic and ts.max_grad_norm == 0.0


def test_train_step_drives_pretrain_step_as_step_does():
    """A linear model's squared error on inputs of ~3e15, whose scaled
    gradients overflow fp32 from 2^32 down to 2^27: six skips, then two
    taken steps at 2^26. The PretrainStep run and the step() run skip the
    same steps and hold the same master and scale after each."""
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 3)
    x, y = torch.randn(8, 4) * 3e15, torch.randn(8, 3)

    def loss_fn(m, x_, y_):
        return ((m(x_) - y_) ** 2).mean()

    opt = fp16_utils.FP16_Optimizer(FusedAdam(lr=1e-2),
                                    dynamic_loss_scale=True)
    p0 = {n: t.detach().clone() for n, t in model.named_parameters()}
    step = PretrainStep(model, opt.optimizer, loss_fn=loss_fn,
                        train_step=opt.train_step)
    state, ss = step.init(), opt.loss_scaler.init()
    ref = opt.init(p0)
    ref_model = torch.nn.Linear(4, 3)
    skips = []
    for _ in range(8):
        count = state.count
        state, ss, _ = step(state, x, y, scaler_state=ss)
        skips.append(state.count == count)
        with torch.no_grad():
            for n, t in ref_model.named_parameters():
                t.copy_(ref.opt_state.space.unpack(ref.opt_state.master)[n])
        ref_model.zero_grad()
        opt.scale_loss(loss_fn(ref_model, x, y), ref).backward()
        _, ref = opt.step(ref, {n: t.grad for n, t in
                                ref_model.named_parameters()})
        assert ss == ref.scaler_state
        assert torch.equal(state.master.view(torch.int32),
                           ref.opt_state.master.view(torch.int32))
    assert skips == [True] * 6 + [False] * 2
