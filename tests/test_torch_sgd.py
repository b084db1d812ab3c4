"""The fused SGD and LARS updates, FusedSGD, FusedLARS, LARC and the amp
opt levels of apex_tpu_torch against apex_tpu.

The same numpy buffers go through the reference (``impl="xla"`` and,
for the fused updates, its Pallas kernel in interpret mode) and the
port's plain PyTorch path, which is what CPU tensors take (the CUDA
kernels are held bitwise against the same plain path on the card by
``tests/test_torch_kernels_cuda.py``).

Tolerances. SGD against the XLA path: p' and mom' bitwise (both round
every operation on its own here; a test pins it). Against the Pallas
interpreter, which contracts the multiply-adds (``g + wd * p``, ``mu *
mom + g``, ``p - lr * upd``) into fused multiply-adds that skip one
product's rounding each: mom' within 2 ulp of its larger term (|mu *
mom| or |g'|), p' within 4 ulp of max(|p|, lr |upd|) (one skipped
rounding per contracted operation on the way to p'). LARS: the
per-tensor norms are sums of squares in another order (the reference's
subtile partials against the port's), so each ratio may differ by a few
fp32 roundings (relative ~2e-7), and XLA contracts ``mu * mom + g'``:
mom' within 1e-6 of its terms (|mu * mom| + |mom'|), p' within lr times
that plus 2 ulp of the larger of |p|, |p'| and lr times the terms. The
flags (found_inf, count, the first-run flag) and the amp policies:
exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from apex_tpu import amp as ref_amp
from apex_tpu.multi_tensor import FlatSpace as RefSpace
from apex_tpu.multi_tensor.ops import fused_lars_update as ref_lars
from apex_tpu.multi_tensor.ops import fused_sgd_update as ref_sgd
from apex_tpu.optimizers import FusedLARS as RefLARS
from apex_tpu.optimizers import FusedSGD as RefSGD
from apex_tpu.parallel.larc import LARC as RefLARC

from apex_tpu_torch import amp
from apex_tpu_torch.amp import _amp_state
from apex_tpu_torch.multi_tensor import (
    FlatSpace,
    fused_lars_update,
    fused_sgd_update,
)
from apex_tpu_torch.optimizers import FusedLARS, FusedSGD
from apex_tpu_torch.parallel import LARC

N = 3 * 2048 + 517
LR, MU, WD = 0.1, 0.9, 1e-4


def _buffers(seed=0, n=N):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(n).astype(np.float32) for _ in range(3))


def _bits(a):
    return np.asarray(a).view(np.int32)


SGD_CASES = {
    "no_momentum": dict(momentum=0.0),
    "momentum": dict(momentum=MU),
    "nesterov": dict(momentum=MU, nesterov=True),
    "dampening": dict(momentum=MU, dampening=0.1),
    "wd_after_momentum": dict(momentum=MU, wd_after_momentum=True),
    "first_run": dict(momentum=MU, first_run=True),
    "first_run_nesterov": dict(momentum=MU, nesterov=True, first_run=True),
}


@pytest.mark.parametrize("case", sorted(SGD_CASES))
def test_fused_sgd_update_matches_reference(impl, case):
    p, mom, g = _buffers()
    kw = dict(lr=LR, weight_decay=WD, scale=0.25, **SGD_CASES[case])
    want = ref_sgd(*(jnp.asarray(a) for a in (p, mom, g)), impl=impl, **kw)
    ts = [torch.from_numpy(a.copy()) for a in (p, mom, g)]
    got = fused_sgd_update(*ts, **kw)
    assert got[0] is ts[0] and got[1] is ts[1]        # in place
    assert float(got[2]) == float(want[2]) == 0.0
    gp, wp, mp = got[0].numpy(), np.asarray(want[0]), got[1].numpy()
    wm = np.asarray(want[1])
    if impl == "xla":
        np.testing.assert_array_equal(_bits(gp), _bits(wp))
        np.testing.assert_array_equal(_bits(mp), _bits(wm))
        return
    g_eff = np.abs(g * 0.25) + np.abs(WD * p)
    term = np.maximum(np.abs(kw["momentum"] * mom), g_eff)
    assert (np.abs(mp - wm) <= 2 * np.spacing(term)).all()
    upd = np.abs(wm) + g_eff + np.abs(WD * p)
    assert (np.abs(gp - wp)
            <= 4 * np.spacing(np.maximum(np.abs(p), LR * upd))).all()


def test_sgd_out_of_place_and_first_run_on_device_flag():
    p, mom, g = _buffers(seed=1)
    ts = [torch.from_numpy(a.copy()) for a in (p, mom, g)]
    first = torch.ones((), dtype=torch.float32) == 1     # a tensor flag
    p2, m2, _ = fused_sgd_update(*ts, lr=LR, momentum=MU, first_run=first,
                                 in_place=False)
    for t, a in zip(ts, (p, mom, g)):
        np.testing.assert_array_equal(t.numpy(), a)
    want = fused_sgd_update(*(torch.from_numpy(a.copy()) for a in (p, mom, g)),
                            lr=LR, momentum=MU, first_run=True)
    np.testing.assert_array_equal(_bits(p2.numpy()), _bits(want[0].numpy()))
    np.testing.assert_array_equal(_bits(m2.numpy()), _bits(g))


@pytest.mark.parametrize("bad", [(np.inf, np.nan), (-np.inf, -np.inf),
                                 (np.nan, np.nan)])
def test_sgd_and_lars_found_inf(impl, bad):
    p, mom, g = _buffers(seed=2)
    g[5], g[N - 1] = bad
    want = ref_sgd(*(jnp.asarray(a) for a in (p, mom, g)), lr=LR,
                   momentum=MU, impl=impl)
    got = fused_sgd_update(*(torch.from_numpy(a.copy())
                             for a in (p, mom, g)), lr=LR, momentum=MU)
    assert float(got[2]) == float(want[2]) == 1.0
    tree = {"w": p[:N - 517], "b": p[N - 517:]}
    space = FlatSpace.create({k: torch.from_numpy(v) for k, v in tree.items()})
    flat = space.pack({"w": torch.from_numpy(g[:N - 517]),
                       "b": torch.from_numpy(g[N - 517:])})
    pf = space.pack({k: torch.from_numpy(v) for k, v in tree.items()})
    found = fused_lars_update(pf, torch.zeros_like(pf), flat, space, lr=LR)[2]
    assert float(found) == 1.0


def _tree(seed=3):
    """Sorted names: the reference's flat layout (sorted keys) and the
    port's (the order given) coincide."""
    rng = np.random.RandomState(seed)
    return {"a": rng.randn(37, 5).astype(np.float32),
            "b": rng.randn(2100).astype(np.float32),
            "c": rng.randn(3).astype(np.float32),
            "d": np.zeros(9, np.float32)}          # a zero norm: ratio 1


def _states(ref_opt, opt, params):
    rs = ref_opt.init({k: jnp.asarray(a) for k, a in params.items()})
    ps = opt.init({k: torch.from_numpy(a.copy()) for k, a in params.items()})
    assert ps.master.shape[0] == rs.master.shape[0]
    return rs, ps


def test_fused_sgd_step_flat_with_skip_matches_reference():
    ref_opt = RefSGD(lr=LR, momentum=MU, weight_decay=WD, nesterov=True,
                     impl="xla")
    opt = FusedSGD(lr=LR, momentum=MU, weight_decay=WD, nesterov=True)
    rs, ps = _states(ref_opt, opt, _tree())
    rng = np.random.RandomState(4)
    for i in range(5):
        g = rng.randn(ps.master.shape[0]).astype(np.float32)
        if i in (0, 3):
            g[7 * i + 1] = np.inf if i == 0 else np.nan
        before = [ps.master.clone(), ps.slots["momentum"].clone(),
                  float(ps.slots["initialized"])]
        _, rs = ref_opt.step_flat(rs, jnp.asarray(g), grad_scale=8.0,
                                  skip_if_nonfinite=True)
        _, ps = opt.step_flat(ps, torch.from_numpy(g), grad_scale=8.0,
                              skip_if_nonfinite=True)
        assert float(ps.found_inf) == float(rs.found_inf)
        assert ps.count == int(rs.count)
        assert float(ps.slots["initialized"]) == float(
            rs.slots["initialized"])
        if i in (0, 3):     # skipped: everything exactly as it was
            assert torch.equal(ps.master, before[0])
            assert torch.equal(ps.slots["momentum"], before[1])
            assert float(ps.slots["initialized"]) == before[2]
        np.testing.assert_array_equal(_bits(ps.master.numpy()),
                                      _bits(rs.master))
        np.testing.assert_array_equal(_bits(ps.slots["momentum"].numpy()),
                                      _bits(rs.slots["momentum"]))
    assert ps.count == 3


def _assert_lars_close(got_p, got_m, want_p, want_m, p_in, mom_in, first):
    """The bound of the module docstring; ``tm`` bounds the terms of
    mom' (|mu * mom| + |mom'| >= |g'|)."""
    tm = np.abs(want_m) + (0.0 if first else np.abs(MU * mom_in))
    assert (np.abs(got_m - want_m) <= 1e-6 * tm).all()
    tp = np.maximum(np.maximum(np.abs(p_in), np.abs(want_p)), LR * tm)
    assert (np.abs(got_p - want_p)
            <= LR * 1e-6 * tm + 2 * np.spacing(tp)).all()


@pytest.mark.parametrize("first_run", [True, False])
@pytest.mark.parametrize("clip", [True, False])
def test_fused_lars_update_matches_reference(impl, first_run, clip):
    params = _tree()
    rng = np.random.RandomState(5)
    rspace = RefSpace.create({k: jnp.asarray(v) for k, v in params.items()})
    space = FlatSpace.create({k: torch.from_numpy(v)
                              for k, v in params.items()})
    p = np.asarray(rspace.pack({k: jnp.asarray(v) for k, v in params.items()}))
    g = (0.01 * rng.randn(p.shape[0])).astype(np.float32)
    mom = rng.randn(p.shape[0]).astype(np.float32)
    kw = dict(lr=LR, momentum=MU, weight_decay=WD, trust_coefficient=0.02,
              clip=clip, first_run=first_run)
    want = ref_lars(*(jnp.asarray(a) for a in (p, mom, g)), rspace,
                    impl=impl, **kw)
    got = fused_lars_update(*(torch.from_numpy(a.copy())
                              for a in (p, mom, g)), space, **kw)
    assert float(got[2]) == float(want[2]) == 0.0
    _assert_lars_close(got[0].numpy(), got[1].numpy(), np.asarray(want[0]),
                       np.asarray(want[1]), p, mom, first_run)


def test_fused_lars_three_steps_match_reference_per_name():
    params = _tree(6)
    ref_opt = RefLARS(lr=LR, momentum=MU, weight_decay=WD, impl="xla")
    opt = FusedLARS(lr=LR, momentum=MU, weight_decay=WD)
    rs, ps = _states(ref_opt, opt, params)
    rng = np.random.RandomState(7)
    for _ in range(3):
        grads = {k: (0.01 * rng.randn(*v.shape)).astype(np.float32)
                 for k, v in params.items()}
        first = float(ps.slots["initialized"]) == 0.0
        p_in = {k: t.clone() for k, t in ps.space.unpack(ps.master).items()}
        m_in = {k: t.clone() for k, t in
                ps.space.unpack(ps.slots["momentum"]).items()}
        _, rs = ref_opt.step(rs, {k: jnp.asarray(v) for k, v in grads.items()},
                             grad_scale=2.0)
        _, ps = opt.step(ps, {k: torch.from_numpy(v) for k, v in
                              grads.items()}, grad_scale=2.0)
        want_p = rs.space.unpack(rs.master, dtype="buffer")
        want_m = rs.space.unpack(rs.slots["momentum"], dtype="buffer")
        got_m = ps.space.unpack(ps.slots["momentum"], "buffer")
        for name, t in ps.space.unpack(ps.master, "buffer").items():
            _assert_lars_close(t.numpy(), got_m[name].numpy(),
                               np.asarray(want_p[name]),
                               np.asarray(want_m[name]),
                               p_in[name].numpy(), m_in[name].numpy(), first)
        # the next step starts from the same state on both sides
        ps.master.copy_(torch.from_numpy(np.array(rs.master)))
        ps.slots["momentum"].copy_(torch.from_numpy(
            np.array(rs.slots["momentum"])))
    assert ps.count == int(rs.count) == 3


@pytest.mark.parametrize("clip", [True, False])
def test_larc_fused_sgd_matches_reference(clip):
    params = _tree(8)
    ref_opt = RefLARC(RefSGD(lr=LR, momentum=MU, weight_decay=WD,
                             impl="xla"), clip=clip)
    opt = LARC(FusedSGD(lr=LR, momentum=MU, weight_decay=WD), clip=clip)
    rs, ps = _states(ref_opt, opt, params)
    rng = np.random.RandomState(9)
    for _ in range(3):
        grads = {k: (0.01 * rng.randn(*v.shape)).astype(np.float32)
                 for k, v in params.items()}
        first = float(ps.slots["initialized"]) == 0.0
        p_in = {k: t.clone() for k, t in ps.space.unpack(ps.master).items()}
        m_in = {k: t.clone() for k, t in
                ps.space.unpack(ps.slots["momentum"]).items()}
        _, rs = ref_opt.step(rs, {k: jnp.asarray(v) for k, v in grads.items()})
        _, ps = opt.step(ps, {k: torch.from_numpy(v) for k, v in
                              grads.items()})
        want_p = rs.space.unpack(rs.master, dtype="buffer")
        want_m = rs.space.unpack(rs.slots["momentum"], dtype="buffer")
        got_m = ps.space.unpack(ps.slots["momentum"], "buffer")
        for name, t in ps.space.unpack(ps.master, "buffer").items():
            _assert_lars_close(t.numpy(), got_m[name].numpy(),
                               np.asarray(want_p[name]),
                               np.asarray(want_m[name]),
                               p_in[name].numpy(), m_in[name].numpy(), first)
        ps.master.copy_(torch.from_numpy(np.array(rs.master)))
        ps.slots["momentum"].copy_(torch.from_numpy(
            np.array(rs.slots["momentum"])))


def _named_params():
    """Names as the port's ResNet has them and as the reference's tree
    paths have them ('/'-joined)."""
    rng = np.random.RandomState(10)
    shapes = {"conv_stem": (4, 3, 3, 3), "bn_stem.bn.weight": (4,),
              "stage0_block0.bn1.bn.bias": (4,), "head": (4, 5),
              "norm.batchnorm_0.scale": (4,), "gn.group_norm.bias": (4,)}
    return {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}


def _ref_tree(named):
    tree = {}
    for k, v in named.items():
        node = tree
        *mods, leaf = k.split(".")
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = jnp.asarray(v)
    return tree


@pytest.mark.parametrize("level", ["O0", "O1", "O2", "O3", "O4", "O5"])
def test_amp_initialize_and_scaler_match_reference(level):
    named = _named_params()
    rc, rstate = ref_amp.initialize(_ref_tree(named), opt_level=level)
    pc, pstate = amp.initialize({k: torch.from_numpy(v)
                                 for k, v in named.items()}, opt_level=level)
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + ".")
            else:
                flat[prefix + k] = v

    walk(rc, "")
    assert set(flat) == set(pc)
    for name, t in pc.items():
        assert str(t.dtype).replace("torch.", "") == str(flat[name].dtype), \
            name
    rp, pp = rstate.properties, pstate.properties
    for field in ("opt_level", "keep_batchnorm_fp32", "master_weights",
                  "loss_scale"):
        assert getattr(pp, field) == getattr(rp, field)
    for field in ("cast_model_type", "compute_dtype"):
        r, p = getattr(rp, field), getattr(pp, field)
        assert (r is None and p is None) or \
            str(p).replace("torch.", "") == np.dtype(r).name
    assert _amp_state.get_active() == pp       # the active policy
    rsc, psc = ref_amp.make_scaler(rp), amp.make_scaler(pp)
    assert psc.dynamic == rsc.dynamic
    assert psc.init_scale == rsc.init_scale
    assert pstate.scalers[0].loss_scale == float(rstate.scalers[0].loss_scale)


def test_amp_initialize_builds_master_from_fp32_params_and_round_trips():
    named = {k: torch.from_numpy(v) for k, v in _named_params().items()}
    opt = FusedSGD(lr=LR, momentum=MU)
    cast, state, amp_state = amp.initialize(named, opt, opt_level="O2",
                                            num_losses=2)
    assert cast["conv_stem"].dtype == torch.float16
    assert cast["bn_stem.bn.weight"].dtype == torch.float32
    masters = dict(zip(state.space.names, amp.master_params(opt, state)))
    for k, t in named.items():
        assert masters[k].dtype == torch.float32
        assert torch.equal(masters[k], t)
    d = amp.state_dict(amp_state._replace(scalers=(
        amp_state.scalers[0]._replace(loss_scale=1024.0, unskipped=7),
        amp_state.scalers[1])))
    back = amp.load_state_dict(amp_state, d)
    assert back.scalers[0].loss_scale == 1024.0
    assert back.scalers[0].unskipped == 7
    assert back.scalers[1] == amp_state.scalers[1]
