"""The Adagrad and NovoGrad updates, FusedAdagrad, FusedNovoGrad,
larc_transform, as_optax and the loading of their optimizer state, of
apex_tpu_torch against apex_tpu.

The same numpy buffers go through the reference (``impl="xla"`` and,
for the fused updates, its Pallas kernel in interpret mode) and the
port's plain PyTorch path, which is what CPU tensors take (the CUDA
kernels are held bitwise against the same plain path on the card by
``tests/test_torch_kernels_cuda.py``).

Tolerances. NovoGrad: the per-leaf v' is a sum of squares, taken in
another order on each side: bitwise where every sum is exact (gradients
that are small multiples of a power of two), else within 1e-6 relative.
XLA's CPU compiler (under both reference paths: the Pallas interpreter
runs on it too) may contract ``b1 * m + beta3 * g'`` and ``p - (lr /
bc1) * m'`` into fused multiply-adds, and the denominators carry v's
difference: m' within that share (at least 2^-23) of its terms (|b1 m|
+ |m'| + |wd p|) plus one rounding of m', p' within lr / bc1 times that
plus one rounding of the larger of |p| and |p'|.
Adagrad: h' bitwise; p' mostly bitwise, but XLA's CPU compiler rewrites
``p - lr * g' / (sqrt(h') + eps)`` so that the step may round once more
or once less: p' within 2 ulp of the step |p - p'| plus one rounding of
p' (1 ulp of |p'|). The
optimizers over several steps: the same bounds per step (each step
starts from the reference's state). larc_transform: the per-leaf norms
are fp32 sums in another order, so each ratio, and with it the scaled
gradient, within 1e-6 relative. as_optax: the applied update equal to
the optimizer's own step but for the roundings of ``new - old`` and of
``old + update`` (1 ulp of the step and 1 of the result), and the
reference's within those and the update's own bounds (Adam's as in
``tests/test_torch_adam.py``): 4 ulp of the step and 2 of the result.
The loaded state: bitwise per parameter name.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax
from apex_tpu.models.gpt import GPTConfig as RefConfig
from apex_tpu.models.pretrain import init_gpt_pretrain_params as ref_init
from apex_tpu.multi_tensor import FlatSpace as RefSpace
from apex_tpu.multi_tensor.ops import fused_adagrad_update as ref_adagrad
from apex_tpu.multi_tensor.ops import fused_novograd_update as ref_novograd
from apex_tpu.optimizers import FusedAdagrad as RefAdagrad
from apex_tpu.optimizers import FusedAdam as RefAdam
from apex_tpu.optimizers import FusedNovoGrad as RefNovoGrad
from apex_tpu.optimizers import as_optax as ref_as_optax
from apex_tpu.parallel import larc_transform as ref_larc_transform

import apex_tpu_torch
from apex_tpu_torch.models import GPTConfig, GPTModel, load_jax_opt_state
from apex_tpu_torch.multi_tensor import (
    FlatSpace,
    engine,
    fused_adagrad_update,
    fused_novograd_update,
    ops,
)
from apex_tpu_torch.optimizers import (
    FusedAdagrad,
    FusedAdam,
    FusedNovoGrad,
    as_optax,
)
from apex_tpu_torch.parallel import larc_transform

N = 3 * 2048 + 517


def _bits(a):
    return np.asarray(a).view(np.int32)


def _assert_p_close(got, want, p_in, step_ulps=2, p_ulps=1):
    """One rounding of the step more or less, and one of p' (see module
    docstring)."""
    got, want = np.asarray(got), np.asarray(want)
    bound = (step_ulps * np.spacing(np.abs(p_in - got))
             + p_ulps * np.spacing(np.abs(got)))
    assert (np.abs(got - want) <= bound).all()


# -- the Adagrad functor (the reference's tests/test_multi_tensor.py:318) ----


@pytest.mark.parametrize("weight_decay", [0.0, 1e-4])
@pytest.mark.parametrize("grad_scale", [1.0, 4.0])
def test_fused_adagrad_update_matches_reference(impl, grad_scale,
                                                weight_decay):
    rng = np.random.RandomState(0)
    p, g = (rng.randn(N).astype(np.float32) for _ in range(2))
    h = np.abs(rng.randn(N)).astype(np.float32)
    kw = dict(lr=0.01, eps=1e-10, weight_decay=weight_decay,
              grad_scale=grad_scale)
    want = ref_adagrad(*(jnp.asarray(a) for a in (p, h, g)), impl=impl, **kw)
    ts = [torch.from_numpy(a.copy()) for a in (p, h, g)]
    got = fused_adagrad_update(*ts, **kw)
    assert got[0] is ts[0] and got[1] is ts[1]           # in place
    np.testing.assert_array_equal(_bits(got[1].numpy()), _bits(want[1]))
    _assert_p_close(got[0].numpy(), want[0], p)
    assert float(got[2]) == float(want[2]) == 0.0


@pytest.mark.parametrize("bad", [np.inf, np.nan])
def test_fused_adagrad_found_inf_and_out_of_place(impl, bad):
    rng = np.random.RandomState(1)
    p, h, g = (np.abs(rng.randn(N)).astype(np.float32) for _ in range(3))
    g[N - 1] = bad
    want = ref_adagrad(*(jnp.asarray(a) for a in (p, h, g)), lr=0.1,
                       impl=impl)
    ts = [torch.from_numpy(a.copy()) for a in (p, h, g)]
    got = fused_adagrad_update(*ts, lr=0.1, in_place=False)
    assert float(got[2]) == float(want[2]) == 1.0
    for t, a in zip(ts, (p, h, g)):
        np.testing.assert_array_equal(t.numpy(), a)
    assert got[0] is not ts[0] and got[1] is not ts[1]


def test_fused_adagrad_device_style_scale():
    """A 0-d tensor ``grad_scale`` (the fused train step's) gives the
    host number's result."""
    rng = np.random.RandomState(2)
    p, h, g = (np.abs(rng.randn(N)).astype(np.float32) for _ in range(3))
    a = fused_adagrad_update(*(torch.from_numpy(x.copy()) for x in (p, h, g)),
                             lr=0.1, grad_scale=3.0)
    b = fused_adagrad_update(*(torch.from_numpy(x.copy()) for x in (p, h, g)),
                             lr=0.1, grad_scale=torch.tensor(3.0))
    for x, y in zip(a[:2], b[:2]):
        assert torch.equal(x, y)


# -- the NovoGrad functor (the reference's tests/test_multi_tensor.py:381) ---


def _tree(rng):
    """Three leaves, sorted names (both flat layouts order them alike)."""
    return {"a": rng.randn(37, 5).astype(np.float32),
            "b": rng.randn(2100).astype(np.float32),
            "c": rng.randn(3).astype(np.float32)}


def _spaces(tree):
    rs = RefSpace.create({k: jnp.asarray(v) for k, v in tree.items()})
    ps = FlatSpace.create({k: torch.from_numpy(v) for k, v in tree.items()})
    assert rs.offsets == ps.offsets and rs.total == ps.total
    return rs, ps


def _novograd_inputs(seed, rs, exact_sums):
    """p, m, v, g for the three-leaf space. With ``exact_sums`` every g
    is a multiple of 2^-10 of magnitude at most 2^-5, so each leaf's sum
    of squares is exact in fp32 in any order."""
    rng = np.random.RandomState(seed)
    n = rs.total
    p = rng.randn(n).astype(np.float32)
    if exact_sums:
        g = rng.randint(-32, 33, n).astype(np.float32) * np.float32(2 ** -10)
    else:
        g = (0.1 * rng.randn(n)).astype(np.float32)
    m = (0.01 * rng.randn(n)).astype(np.float32)
    v = np.abs(rng.randn(3)).astype(np.float32)
    for off, size, psize in zip(rs.offsets, rs.sizes, rs.padded_sizes):
        p[off + size:off + psize] = g[off + size:off + psize] = 0.0
        m[off + size:off + psize] = 0.0
    return p, m, v, g


def _assert_novograd_close(got, want, p, m, *, lr_bc1, b1, wd, v_rtol):
    """NovoGrad's tolerances (see module docstring): v' within ``v_rtol``
    relative (0: bitwise); m' within that share (at least 2^-23) of its
    terms (|b1 m| + |m'| + |wd p|) plus one rounding; p' within lr / bc1
    times that plus one rounding of the larger of |p| and |p'|."""
    gp, gm, gv = (np.asarray(t) for t in got)
    wp, wm, wv = (np.asarray(t) for t in want)
    if v_rtol:
        np.testing.assert_allclose(gv, wv, rtol=v_rtol, atol=0)
    else:
        np.testing.assert_array_equal(_bits(gv), _bits(wv))
    bm = max(v_rtol, 2.0 ** -23) * (np.abs(b1 * m) + np.abs(gm)
                                     + np.abs(wd * p)) \
        + np.spacing(np.abs(gm))
    assert (np.abs(gm - wm) <= bm).all()
    bp = lr_bc1 * bm + np.spacing(np.maximum(np.abs(p), np.abs(gp)))
    assert (np.abs(gp - wp) <= bp).all()


@pytest.mark.parametrize("exact_sums", [True, False])
@pytest.mark.parametrize("grad_averaging", [True, False])
@pytest.mark.parametrize("bias_correction", [False, True])
@pytest.mark.parametrize("step", [1, 2])
def test_fused_novograd_update_matches_reference(impl, step, bias_correction,
                                                 grad_averaging, exact_sums):
    rs, ps = _spaces(_tree(np.random.RandomState(3)))
    p, m, v, g = _novograd_inputs(4, rs, exact_sums)
    kw = dict(lr=0.01, beta1=0.95, beta2=0.98, step=step,
              weight_decay=0.001, bias_correction=bias_correction,
              grad_averaging=grad_averaging)
    want = ref_novograd(*(jnp.asarray(a) for a in (p, m, v, g)), rs,
                        impl=impl, **kw)
    ts = [torch.from_numpy(a.copy()) for a in (p, m, v, g)]
    got = fused_novograd_update(*ts, ps, **kw)
    assert all(o is t for o, t in zip(got[:3], ts[:3]))      # in place
    assert float(got[3]) == float(want[3]) == 0.0
    bc1 = 1.0 - 0.95 ** step if bias_correction else 1.0
    _assert_novograd_close([t.numpy() for t in got[:3]], want[:3], p, m,
                           lr_bc1=0.01 / bc1, b1=0.95, wd=1e-3,
                           v_rtol=0.0 if exact_sums else 1e-6)


def test_fused_novograd_found_inf_and_out_of_place():
    rng = np.random.RandomState(4)
    tree = _tree(rng)
    rs, ps = _spaces(tree)
    p = np.asarray(rs.pack({k: jnp.asarray(v) for k, v in tree.items()}))
    m, g = (rng.randn(p.shape[0]).astype(np.float32) for _ in range(2))
    v = np.ones(3, np.float32)
    g[40] = np.nan
    want = ref_novograd(*(jnp.asarray(a) for a in (p, m, v, g)), rs,
                        lr=0.01, step=2, impl="xla")
    ts = [torch.from_numpy(a.copy()) for a in (p, m, v, g)]
    got = fused_novograd_update(*ts, ps, lr=0.01, step=2, in_place=False)
    assert float(got[3]) == float(want[3]) == 1.0
    for t, a in zip(ts, (p, m, v, g)):
        np.testing.assert_array_equal(t.numpy(), a)


def test_every_functor_has_a_kernel_but_sr():
    """On CUDA tensors ``fused_elementwise`` finds a kernel for every
    functor of the reference's ops.py; stochastic rounding of a non-bf16
    output raises the reference's error."""
    functors = (ops._scale_fn, ops._axpby_fn, ops._adam_fn, ops._adagrad_fn,
                ops._novograd_fn, ops._lamb_stage1_fn, ops._lamb_stage2_fn,
                ops._sgd_fn, ops._lars_fn)
    assert all(fn in engine._KERNELS for fn in functors)
    with pytest.raises(ValueError, match="stochastic rounding targets"):
        engine.fused_elementwise(ops._scale_fn, [torch.zeros(8)],
                                 scalars=[1.0], sr_outputs=(0,), sr_seed=0)


# -- the optimizers -----------------------------------------------------------


def _params(seed=5):
    rng = np.random.RandomState(seed)
    return {"a": rng.randn(37, 5).astype(np.float32),
            "b": rng.randn(2100).astype(np.float32),
            "c": rng.randn(3).astype(np.float32)}


def _optimizers(kind):
    if kind == "novograd":
        kw = dict(lr=1e-2, betas=(0.9, 0.98), weight_decay=1e-3)
        return RefNovoGrad(impl="xla", **kw), FusedNovoGrad(**kw)
    kw = dict(lr=1e-2, weight_decay=0.01)
    return RefAdagrad(impl="xla", **kw), FusedAdagrad(**kw)


@pytest.mark.parametrize("kind", ["novograd", "adagrad"])
def test_optimizer_step_by_step_with_scale_and_skip(kind):
    """Four steps on the same gradients: a plain one, one with
    ``grad_scale`` 4, one with an inf (skipped on both sides, state and
    count unchanged), one more; each step starts from the reference's
    state."""
    params = _params()
    ref_opt, opt = _optimizers(kind)
    rs = ref_opt.init({k: jnp.asarray(a) for k, a in params.items()})
    ps = opt.init({k: torch.from_numpy(a.copy()) for k, a in params.items()})
    assert ps.master.shape == rs.master.shape
    assert set(ps.slots) == set(rs.slots)
    for k in rs.slots:
        assert tuple(ps.slots[k].shape) == rs.slots[k].shape
    rng = np.random.RandomState(6)
    for i, (scale, skip) in enumerate(((1.0, False), (4.0, False),
                                       (1.0, True), (1.0, True))):
        g = rng.randn(ps.master.shape[0]).astype(np.float32)
        if i == 2:
            g[17] = np.inf
        before = ps.master.numpy().copy()
        m_before = ps.slots["m"].numpy().copy() if "m" in ps.slots else None
        _, rs = ref_opt.step_flat(rs, jnp.asarray(g), grad_scale=scale,
                                  skip_if_nonfinite=skip)
        _, ps = opt.step_flat(ps, torch.from_numpy(g), grad_scale=scale,
                              skip_if_nonfinite=skip)
        assert ps.count == int(rs.count) == (2 if i == 2 else i + 1 - (i > 2))
        assert float(ps.found_inf) == float(rs.found_inf) == float(i == 2)
        if kind == "novograd":
            _assert_novograd_close(
                [ps.master, ps.slots["m"], ps.slots["v"]],
                [rs.master, rs.slots["m"], rs.slots["v"]], before,
                m_before, lr_bc1=1e-2, b1=0.9, wd=1e-3, v_rtol=1e-6)
        else:
            np.testing.assert_array_equal(_bits(ps.slots["h"].numpy()),
                                          _bits(rs.slots["h"]))
            _assert_p_close(ps.master.numpy(), rs.master, before)
        ps.master.copy_(torch.from_numpy(np.array(rs.master)))
        for k, buf in ps.slots.items():
            buf.copy_(torch.from_numpy(np.array(rs.slots[k])))


def test_novograd_device_grad_scale_takes_the_where_pass():
    params = _params(7)
    opt = FusedNovoGrad(lr=1e-2)
    g = torch.from_numpy(np.random.RandomState(8).randn(
        FlatSpace.create({k: torch.from_numpy(v) for k, v in
                          params.items()}).total).astype(np.float32))
    states = []
    for scale in (2.0, torch.tensor(2.0), torch.tensor(1.0), 1.0):
        st = opt.init({k: torch.from_numpy(a.copy()) for k, a in
                       params.items()})
        _, st = opt.step_flat(st, g, grad_scale=scale)
        states.append(st)
    for a, b in ((0, 1), (2, 3)):
        assert torch.equal(states[a].master, states[b].master)
        assert torch.equal(states[a].slots["v"], states[b].slots["v"])


@pytest.mark.parametrize("cls", [FusedNovoGrad, FusedAdagrad])
def test_stochastic_rounding_raises(cls):
    """The reference's master-dtype policy: SR needs a bf16 master, a bf16
    master needs SR; the two together construct."""
    with pytest.raises(ValueError, match="requires master_dtype=bfloat16"):
        cls(stochastic_rounding=True)
    with pytest.raises(ValueError, match="without stochastic rounding"):
        cls(master_dtype=torch.bfloat16)
    assert cls(stochastic_rounding=True,
               master_dtype=torch.bfloat16).master_dtype == torch.bfloat16


# -- larc_transform and as_optax ----------------------------------------------


@pytest.mark.parametrize("clip", [True, False])
def test_larc_transform_matches_reference(clip):
    rng = np.random.RandomState(9)
    params = {"w": (100 * rng.randn(64)).astype(np.float32),
              "b": rng.randn(7).astype(np.float32),
              "z": np.zeros(5, np.float32)}
    grads = {k: (0.01 * rng.randn(*v.shape)).astype(np.float32)
             for k, v in params.items()}
    kw = dict(trust_coefficient=0.02, clip=clip, eps=1e-8, weight_decay=1e-4)
    rtx = ref_larc_transform(0.1, **kw)
    want, _ = rtx.update({k: jnp.asarray(v) for k, v in grads.items()},
                         rtx.init(params),
                         {k: jnp.asarray(v) for k, v in params.items()})
    tx = larc_transform(0.1, **kw)
    tg = {k: torch.from_numpy(v) for k, v in grads.items()}
    got, state = tx.update(tg, tx.init(params),
                           {k: torch.from_numpy(v) for k, v in params.items()})
    assert state == ()
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=0)
        np.testing.assert_array_equal(tg[k].numpy(), grads[k])   # a copy
    with pytest.raises(ValueError, match="requires params"):
        tx.update(tg, ())


@pytest.mark.parametrize("kind", ["adam", "novograd", "adagrad"])
def test_as_optax_matches_reference(kind):
    """``update`` returns new - old in fp32; applied, it gives the
    optimizer's own step."""
    params = _params(10)
    rng = np.random.RandomState(11)
    grads = {k: rng.randn(*v.shape).astype(np.float32)
             for k, v in params.items()}
    if kind == "adam":
        ref_opt, opt, direct = (RefAdam(lr=1e-3, impl="xla"),
                                FusedAdam(lr=1e-3), FusedAdam(lr=1e-3))
    else:
        ref_opt, opt = _optimizers(kind)
        direct = _optimizers(kind)[1]
    rtx, tx = ref_as_optax(ref_opt), as_optax(opt)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    rstate = rtx.init(jp)
    rupd, rstate = rtx.update({k: jnp.asarray(v) for k, v in grads.items()},
                              rstate, params=jp)
    want = optax.apply_updates(jp, rupd)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    state = tx.init(tp)
    upd, state = tx.update({k: torch.from_numpy(v) for k, v in
                            grads.items()}, state, params=tp)
    got = {k: p + upd[k] for k, p in tp.items()}    # optax.apply_updates
    dstate = direct.init({k: torch.from_numpy(v.copy()) for k, v in
                          params.items()})
    expected, _ = direct.step(dstate, {k: torch.from_numpy(v) for k, v in
                                       grads.items()})
    for k in params:
        # p + (new - p) is new but for the rounding of the difference and
        # of the sum, the same on both sides
        _assert_p_close(got[k].numpy(), expected[k].numpy(), params[k],
                        step_ulps=1, p_ulps=1)
        _assert_p_close(got[k].numpy(), want[k], params[k], step_ulps=4,
                        p_ulps=2)
    assert state.inner.count == int(rstate.inner.count) == 1
    with pytest.raises(ValueError, match="params"):
        tx.update(grads, state)


# -- load_jax_opt_state: h, m and the per-leaf v ------------------------------


def _tiny(scan_layers=False):
    shape = dict(vocab_size=64, max_seq_len=16, hidden_size=32,
                 num_layers=2, num_heads=2)
    return (RefConfig(dtype=jnp.float32, scan_layers=scan_layers, **shape),
            GPTConfig(dtype=torch.float32, **shape))


@pytest.mark.parametrize("kind", ["novograd", "adagrad"])
def test_load_jax_opt_state_by_name(kind):
    """Random slots in the reference's layout (sorted keys) land in the
    port's (module order) by parameter name; NovoGrad's v per leaf."""
    from apex_tpu_torch.models.convert import gpt_params_from_jax
    rcfg, cfg = _tiny()
    params = ref_init(rcfg, jax.random.PRNGKey(0))
    ref_opt, opt = _optimizers(kind)
    rs = ref_opt.init(params)
    rng = np.random.RandomState(12)
    slots = {k: jnp.asarray(rng.randn(*v.shape).astype(np.float32))
             for k, v in rs.slots.items()}
    rs = rs._replace(slots=slots, count=jnp.int32(3))
    unpack = lambda b: jax.tree_util.tree_map(           # noqa: E731
        np.asarray, rs.space.unpack(b, dtype="buffer"))
    d = {"master": unpack(rs.master), "count": int(rs.count)}
    for k, v in rs.slots.items():
        d[k] = (rs.space.treedef.unflatten(list(np.asarray(v)))
                if v.shape == (rs.space.num_leaves,) else unpack(v))
    ps = opt.init(dict(GPTModel(cfg, device="cpu").named_parameters()))
    ps = load_jax_opt_state(ps, cfg, d)
    assert ps.count == 3
    for k in rs.slots:
        if k == "v" and kind == "novograd":
            leaves, _ = jax.tree_util.tree_flatten_with_path(params)
            by_path = {"/".join(getattr(x, "key", str(x)) for x in path
                                if getattr(x, "key", None) != "params"): i
                       for i, (path, _) in enumerate(leaves)}
            want = gpt_params_from_jax(
                {p: np.float32(np.asarray(slots["v"])[i])
                 for p, i in by_path.items()}, cfg)
            got = dict(zip(ps.space.names, ps.slots["v"].numpy()))
            assert set(got) == set(want)
            for name in want:
                assert got[name] == float(want[name]), name
        else:
            want = gpt_params_from_jax(unpack(slots[k]), cfg)
            got = ps.space.unpack(ps.slots[k], "buffer")
            for name in want:
                assert torch.equal(got[name], want[name]), name


def test_load_per_leaf_slot_from_scanned_reference_raises():
    rcfg, cfg = _tiny(scan_layers=True)
    params = ref_init(rcfg, jax.random.PRNGKey(0))
    rs = RefNovoGrad(impl="xla").init(params)
    unpack = lambda b: jax.tree_util.tree_map(           # noqa: E731
        np.asarray, rs.space.unpack(b, dtype="buffer"))
    d = {"master": unpack(rs.master), "m": unpack(rs.slots["m"]),
         "v": rs.space.treedef.unflatten(list(np.asarray(rs.slots["v"]))),
         "count": 0}
    ps = FusedNovoGrad().init(dict(GPTModel(cfg,
                                            device="cpu").named_parameters()))
    with pytest.raises(ValueError, match="scan_layers=True"):
        load_jax_opt_state(ps, cfg, d)


def test_new_modules_import_no_jax_or_optax():
    code = ("import sys, apex_tpu_torch.optimizers, apex_tpu_torch.parallel, "
            "apex_tpu_torch.contrib.clip_grad, apex_tpu_torch.multi_tensor, "
            "apex_tpu_torch.multi_tensor.engine, "
            "apex_tpu_torch.multi_tensor.segmented, "
            "apex_tpu_torch.optimizers.fused, apex_tpu_torch.random; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'apex_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    root = Path(apex_tpu_torch.__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
