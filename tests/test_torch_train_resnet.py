"""Tiny-ResNet training steps of apex_tpu_torch against apex_tpu's
``jax.grad`` + ``FusedSGD.step`` / ``FusedLARS.step`` (the reference's
``bench_resnet`` and ImageNet example loop), from the same converted
weights on the same numpy batch, compared per parameter name after
every step: the loss, the fp32 master, the momentum slot and the
BatchNorm running statistics.

Tolerances, stated per dtype. fp32: the convolutions and their
gradients sum in another order than XLA's (gradients ~1e-6 relative
apart), and three steps at lr 0.1 carry that into the weights: loss
within 1e-5, master and momentum within 1e-4 of each parameter's
largest |value| (read: 4.8e-7, 1.4e-5, 2.0e-5), running statistics
within 1e-4 relative. bf16 and fp16: a bf16 (fp16) rounding that falls
the other way moves an activation by 2^-8 (2^-11) of itself, and
BatchNorm's backward, which subtracts means, magnifies such flips in
the gradients of single parameters; each side's gradients lie ~13%
(bf16) from the fp32 ones, the two sides 2.3% from each other (median
per parameter, first step). So the whole model is compared at once:
the relative L2 distance over all parameters of the update (p - p0)
and of the momentum within 1e-2 after the first step (read: 2.7e-3
bf16, 1.5e-3 fp16), within 6e-2 and 1e-1 after the later steps, where
lr 0.1 carries the difference into diverging trajectories (read at
step 3: 2.0e-2 and 3.6e-2 bf16; the reference's own bf16 run lies 2.7e-2
and 4.4e-2 from its fp32 run); loss within 5e-3 (1.2e-3 read), running
statistics within 1e-2 relative per element. The flags (found_inf,
count, the loss scale): exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from apex_tpu import amp as ref_amp
from apex_tpu.models.resnet import ResNet as RefResNet
from apex_tpu.models.resnet import ResNetConfig as RefConfig
from apex_tpu.models.resnet import cross_entropy_logits as ref_ce
from apex_tpu.optimizers import FusedLARS as RefLARS
from apex_tpu.optimizers import FusedSGD as RefSGD

from apex_tpu_torch import amp
from apex_tpu_torch.models import (
    PretrainStep,
    ResNet,
    ResNetConfig,
    cross_entropy_logits,
    load_jax_opt_state,
    load_jax_resnet,
    resnet_params_from_jax,
)
from apex_tpu_torch.optimizers import FusedLARS, FusedSGD, make_train_step

HW, BATCH, STEPS = 32, 4, 3
KW = dict(lr=0.1, momentum=0.9, weight_decay=1e-4)
TOL = {"float32": dict(loss=1e-5, master=1e-4, mom=1e-4, stats=1e-4),
       "bfloat16": dict(loss=5e-3, first=1e-2, step=6e-2, mom=1e-1,
                        stats=1e-2)}
TOL["float16"] = TOL["bfloat16"]


def _batch():
    rng = np.random.RandomState(0)
    return (rng.randn(BATCH, HW, HW, 3).astype(np.float32),
            rng.randint(0, 1000, BATCH).astype(np.int32))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _reference_run(dtype, opt, steps, *, scaler=None, inf_at=None):
    """``steps`` reference steps; returns the initial variables and, per
    step, (loss, master by name, momentum by name, batch stats, found,
    count, loss scale)."""
    x, y = _batch()
    model = RefResNet(RefConfig.resnet18ish(dtype=jnp.dtype(dtype)))
    v = model.init(jax.random.PRNGKey(0), x, train=True)
    state = opt.init(v["params"])
    stats = v["batch_stats"]
    ss = None if scaler is None else scaler.init()

    @jax.jit
    def grads_of(state, stats, scale):
        def loss_fn(p):
            out, mut = model.apply({"params": p, "batch_stats": stats}, x,
                                   train=True, mutable=["batch_stats"])
            return ref_ce(out, y) * scale, (ref_ce(out, y),
                                            mut["batch_stats"])
        (_, (loss, stats)), g = jax.value_and_grad(loss_fn, has_aux=True)(
            state.space.unpack(state.master))
        return loss, stats, g

    out = []
    for i in range(steps):
        scale = 1.0 if ss is None else ss.loss_scale
        loss, stats, g = grads_of(state, stats, scale)
        if i == inf_at:
            g = dict(g, head_bias=g["head_bias"].at[3].set(jnp.inf))
        if ss is None:
            _, state = opt.step(state, g)
        else:
            _, state = opt.step(state, g, grad_scale=ss.loss_scale,
                                skip_if_nonfinite=True)
            ss = scaler.update(ss, state.found_inf)
        unpack = lambda b: _np(state.space.unpack(b, dtype="buffer"))  # noqa
        out.append((float(loss), unpack(state.master),
                    unpack(state.slots["momentum"]), _np(stats),
                    float(state.found_inf), int(state.count),
                    None if ss is None else float(ss.loss_scale)))
    return _np(v["params"]), _np(v["batch_stats"]), out


def _port_step(dtype, opt, params, stats, *, scaler=None):
    cfg = ResNetConfig.resnet18ish(dtype=getattr(torch, dtype))
    model = load_jax_resnet(ResNet(cfg, device="cpu"), params, stats)
    tstep = None if scaler is None else make_train_step(opt, scaler=scaler)
    return PretrainStep(model, opt, train_step=tstep,
                        loss_fn=lambda m, x, y: cross_entropy_logits(m(x), y))


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= tol * scale


def _rel_l2(got, want, base):
    names = list(want)
    flat = lambda d: torch.cat([d[k].reshape(-1).float() for k in names])  # noqa
    return float((flat(got) - flat(want)).norm()
                 / (flat(want) - flat(base)).norm())


def _compare(step, state, ref_step, tol, p0, first):
    loss, master, mom, stats = ref_step[:4]
    want_master = resnet_params_from_jax(master)
    want_mom = resnet_params_from_jax(mom)
    got_master = state.space.unpack(state.master, "buffer")
    got_mom = state.space.unpack(state.slots["momentum"], "buffer")
    if "master" in tol:                 # fp32: each parameter, elementwise
        for name, t in got_master.items():
            _close(t.numpy(), want_master[name].numpy(), tol["master"])
            _close(got_mom[name].numpy(), want_mom[name].numpy(),
                   tol["mom"])
    else:                               # the whole model, relative L2
        zero = {k: torch.zeros_like(t) for k, t in want_mom.items()}
        assert _rel_l2(got_master, want_master, p0) <= (
            tol["first"] if first else tol["step"])
        assert _rel_l2(got_mom, want_mom, zero) <= (
            tol["first"] if first else tol["mom"])
    own = step.model.state_dict()
    for name, t in resnet_params_from_jax({}, stats).items():
        _close(own[name].numpy(), t.numpy(), tol["stats"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_sgd_three_steps_match_reference(dtype):
    params, stats, ref = _reference_run(dtype, RefSGD(**KW, impl="xla"),
                                        STEPS)
    step = _port_step(dtype, FusedSGD(**KW), params, stats)
    state = step.init()
    p0 = resnet_params_from_jax(params)
    x, y = (torch.from_numpy(a) for a in _batch())
    for i in range(STEPS):
        state, loss = step(state, x, y)
        assert abs(float(loss) - ref[i][0]) <= TOL[dtype]["loss"]
        assert state.count == ref[i][5]
        _compare(step, state, ref[i], TOL[dtype], p0, i == 0)
    assert float(state.slots["initialized"]) == 1.0


def test_fused_lars_three_steps_match_reference():
    params, stats, ref = _reference_run(
        "float32", RefLARS(**KW, impl="xla"), STEPS)
    step = _port_step("float32", FusedLARS(**KW), params, stats)
    state = step.init()
    x, y = (torch.from_numpy(a) for a in _batch())
    for i in range(STEPS):
        state, loss = step(state, x, y)
        assert abs(float(loss) - ref[i][0]) <= TOL["float32"]["loss"]
        _compare(step, state, ref[i], TOL["float32"], None, i == 0)


def test_amp_o2_scaler_step_skips_an_overflow_as_the_reference():
    """fp16 compute, fp32 master, the dynamic scaler of O2: a good step,
    then one whose gradient holds an inf (skipped on both sides: state
    exactly as it was, the scale halved), then a good one."""
    params, stats, ref = _reference_run(
        "float16", RefSGD(**KW, impl="xla"), 3,
        scaler=ref_amp.make_scaler(ref_amp.OPT_LEVELS["O2"]), inf_at=1)
    opt = FusedSGD(**KW)
    cfg = ResNetConfig.resnet18ish(dtype=torch.float16)
    model = load_jax_resnet(ResNet(cfg, device="cpu"), params, stats)
    _, state, amp_state = amp.initialize(dict(model.named_parameters()), opt,
                                         opt_level="O2")
    assert amp_state.properties.cast_model_type == cfg.dtype
    scaler = amp.make_scaler(amp_state.properties)
    assert scaler.dynamic
    step = PretrainStep(model, opt, train_step=make_train_step(
        opt, scaler=scaler), loss_fn=lambda m, x, y: cross_entropy_logits(
            m(x), y))
    ss = scaler.init()
    p0 = resnet_params_from_jax(params)
    x, y = (torch.from_numpy(a) for a in _batch())
    for i in range(3):
        if i == 1:
            before = (state.master.clone(), state.slots["momentum"].clone(),
                      state.count)
            loss = step.backward(state, x, y, scaler_state=ss)
            off = state.space.offsets[state.space.names.index("head_bias")]
            step.grad[off + 3] = float("inf")
            state, ss, _ = step.train_step(state, step.grad, ss)
            assert torch.equal(state.master, before[0])
            assert torch.equal(state.slots["momentum"], before[1])
            assert state.count == before[2]
        else:
            state, ss, loss = step(state, x, y, scaler_state=ss)
        assert abs(float(loss) - ref[i][0]) <= TOL["float16"]["loss"]
        assert float(state.found_inf) == ref[i][4] == float(i == 1)
        assert state.count == ref[i][5]
        assert ss.loss_scale == ref[i][6]
        _compare(step, state, ref[i], TOL["float16"], p0, i == 0)
    assert ss.loss_scale == 2.0 ** 15


def test_load_jax_opt_state_takes_the_sgd_momentum_by_name():
    params, stats, ref = _reference_run("float32", RefSGD(**KW, impl="xla"),
                                        1)
    _, master, mom = ref[0][:3]
    step = _port_step("float32", FusedSGD(**KW), params, stats)
    state = load_jax_opt_state(step.init(), step.model.config,
                               {"master": master, "momentum": mom,
                                "initialized": 1.0, "count": 1})
    assert state.count == 1 and float(state.slots["initialized"]) == 1.0
    want = resnet_params_from_jax(mom)
    for name, t in state.space.unpack(state.slots["momentum"],
                                      "buffer").items():
        np.testing.assert_array_equal(t.numpy(), want[name].numpy())
    # the model's parameters are views of the master: loaded too
    np.testing.assert_array_equal(
        step.model.conv_stem.detach().numpy(),
        resnet_params_from_jax(master)["conv_stem"].numpy())
