"""The fused Adam update, FusedAdam, the loss scaler and the elementwise
engine of apex_tpu_torch against apex_tpu.

The same numpy buffers go through the reference (``impl="xla"`` and, for
the fused update, its Pallas kernel in interpret mode) and the port's
plain PyTorch path, which is what CPU tensors take (the CUDA kernel is
held bitwise against the same plain path on the card by
``tests/test_torch_kernels_cuda.py``).

Tolerances. m and v: bitwise. p: bitwise except where XLA's CPU
compiler fuses ``upd + wd * p`` and ``p - lr * upd`` into fused
multiply-adds, which skip the rounding of the products: there the two
differ by at most one rounding of ``upd`` (scaled by lr, within one ulp
of the product), one of the product ``lr * upd`` and one of the result,
|dp| <= 2 ulp(|p - p'|) + ulp(|p'|). The reference's jitted train step
fuses the whole update into one loop, where ``upd`` may take one more
contracted rounding on each side of its division: there the bound is
4 ulp(|p - p'|) + ulp(|p'|). The scaler's state: exact.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from apex_tpu.amp.scaler import LossScaler as RefScaler
from apex_tpu.multi_tensor.engine import fused_elementwise as ref_fe
from apex_tpu.multi_tensor.ops import fused_adam_update as ref_adam
from apex_tpu.optimizers import FusedAdam as RefAdam
from apex_tpu.optimizers import make_train_step as ref_make_train_step

from apex_tpu_torch.amp import LossScaler
from apex_tpu_torch.multi_tensor import (
    FlatSpace,
    fused_adam_update,
    fused_elementwise,
)
from apex_tpu_torch.optimizers import FusedAdam, make_train_step

N = 3 * 2048 + 517


def _buffers(seed=0, n=N):
    rng = np.random.RandomState(seed)
    p, m, g = (rng.randn(n).astype(np.float32) for _ in range(3))
    v = np.abs(rng.randn(n)).astype(np.float32)
    return p, m, v, g


def _bits(a):
    return np.asarray(a).view(np.int32)


def _assert_p_close(got, want, p_in, product_ulps=2):
    """Roundings of upd and lr * upd, and one of the result (see module
    docstring)."""
    bound = (product_ulps * np.spacing(np.abs(p_in - got))
             + np.spacing(np.abs(got)))
    assert (np.abs(got - want) <= bound).all()


@pytest.mark.parametrize("step", [1, 7])
@pytest.mark.parametrize("bias_correction", [True, False])
@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_fused_adam_update_matches_reference(impl, adam_w_mode,
                                             bias_correction, step):
    p, m, v, g = _buffers()
    kw = dict(lr=2e-3, weight_decay=0.01, step=step, adam_w_mode=adam_w_mode,
              bias_correction=bias_correction, grad_scale=4.0)
    want = ref_adam(*(jnp.asarray(a) for a in (p, m, v, g)), impl=impl, **kw)
    ts = [torch.from_numpy(a.copy()) for a in (p, m, v, g)]
    got = fused_adam_update(*ts, **kw)
    # in place: the returned buffers are the inputs
    assert all(o is t for o, t in zip(got[:3], ts[:3]))
    np.testing.assert_array_equal(_bits(got[1].numpy()), _bits(want[1]))
    np.testing.assert_array_equal(_bits(got[2].numpy()), _bits(want[2]))
    _assert_p_close(got[0].numpy(), np.asarray(want[0]), p)
    assert float(got[3]) == float(want[3]) == 0.0


def test_out_of_place_leaves_inputs():
    p, m, v, g = _buffers(seed=1)
    ts = [torch.from_numpy(a.copy()) for a in (p, m, v, g)]
    p2, m2, v2, _ = fused_adam_update(*ts, lr=1e-3, in_place=False)
    for t, a in zip(ts, (p, m, v, g)):
        np.testing.assert_array_equal(t.numpy(), a)
    ts2 = [torch.from_numpy(a.copy()) for a in (p, m, v, g)]
    fused_adam_update(*ts2, lr=1e-3)
    for a, b in zip((p2, m2, v2), ts2):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("bad", [(np.inf, np.nan), (-np.inf, -np.inf),
                                 (np.nan, np.nan)])
def test_found_inf(impl, bad):
    p, m, v, g = _buffers(seed=2)
    g[5], g[N - 1] = bad
    want = ref_adam(*(jnp.asarray(a) for a in (p, m, v, g)), lr=1e-3,
                    impl=impl)
    got = fused_adam_update(*(torch.from_numpy(a.copy())
                              for a in (p, m, v, g)), lr=1e-3)
    assert float(got[3]) == float(want[3]) == 1.0


def _params(seed=3):
    rng = np.random.RandomState(seed)
    return {"a": rng.randn(37, 5).astype(np.float32),
            "b": rng.randn(2100).astype(np.float32),
            "c": rng.randn(3).astype(np.float32)}


def test_step_flat_with_skip_matches_reference_step_by_step():
    """Sorted names give both sides the same flat layout."""
    params = _params()
    ref_opt = RefAdam(lr=1e-2, weight_decay=0.01, impl="xla")
    opt = FusedAdam(lr=1e-2, weight_decay=0.01)
    rs = ref_opt.init({k: jnp.asarray(a) for k, a in params.items()})
    ps = opt.init({k: torch.from_numpy(a.copy()) for k, a in params.items()})
    assert ps.master.shape[0] == rs.master.shape[0]
    rng = np.random.RandomState(4)
    for i in range(5):
        g = rng.randn(ps.master.shape[0]).astype(np.float32)
        if i in (1, 3):
            g[7 * i] = np.inf if i == 1 else np.nan
        before = [ps.master.clone(), ps.slots["m"].clone()]
        _, rs = ref_opt.step_flat(rs, jnp.asarray(g), skip_if_nonfinite=True)
        _, ps = opt.step_flat(ps, torch.from_numpy(g),
                              skip_if_nonfinite=True)
        assert float(ps.found_inf) == float(rs.found_inf)
        assert ps.count == int(rs.count)
        if i in (1, 3):     # skipped: everything exactly as it was
            assert torch.equal(ps.master, before[0])
            assert torch.equal(ps.slots["m"], before[1])
        np.testing.assert_array_equal(_bits(ps.slots["m"].numpy()),
                                      _bits(rs.slots["m"]))
        np.testing.assert_array_equal(_bits(ps.slots["v"].numpy()),
                                      _bits(rs.slots["v"]))
        _assert_p_close(ps.master.numpy(), np.asarray(rs.master),
                        before[0].numpy())
        # the next step starts from the same master on both sides
        ps.master.copy_(torch.from_numpy(np.array(rs.master)))
    assert ps.count == 3


def test_loss_scaler_growth_and_backoff_match_reference():
    kw = dict(init_scale=2.0 ** 10, scale_window=3, min_loss_scale=2.0 ** 8,
              max_loss_scale=2.0 ** 12)
    ref, sc = RefScaler(**kw), LossScaler(**kw)
    rs, ss = ref.init(), sc.init()
    found = [0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 0, 0, 0]
    for f in found:
        rs, ss = ref.update(rs, jnp.float32(f)), sc.update(ss, float(f))
        assert ss.loss_scale == float(rs.loss_scale)
        assert ss.unskipped == int(rs.unskipped)
        assert ss.found_inf == float(rs.found_inf)
    assert sc.load_state_dict(sc.state_dict(ss)) == ss
    loss = torch.tensor(1.5, dtype=torch.bfloat16)
    assert float(sc.scale_loss(loss, ss)) == float(
        ref.scale_loss(jnp.asarray(1.5, jnp.bfloat16), rs))


def test_static_scaler_matches_reference():
    ref, sc = RefScaler(loss_scale=128.0), LossScaler(loss_scale=128.0)
    rs, ss = ref.init(), sc.init()
    for f in (0, 1, 0):
        rs, ss = ref.update(rs, jnp.float32(f)), sc.update(ss, float(f))
        assert (ss.loss_scale, ss.unskipped) == (float(rs.loss_scale),
                                                 int(rs.unskipped))


def test_train_step_with_scaler_matches_reference():
    """The scaler path: the unscale folded into the update (the
    reference's kernel impls do the same; its XLA impl multiplies by
    1/scale first, which rounds alike for a power-of-two scale)."""
    params = _params(seed=5)
    ref_opt = RefAdam(lr=1e-2, impl="xla")
    opt = FusedAdam(lr=1e-2)
    rstep = ref_make_train_step(ref_opt, scaler=RefScaler(init_scale=2.0 ** 4))
    step = make_train_step(opt, scaler=LossScaler(init_scale=2.0 ** 4))
    rs = ref_opt.init({k: jnp.asarray(a) for k, a in params.items()})
    ps = opt.init({k: torch.from_numpy(a.copy()) for k, a in params.items()})
    rss, pss = rstep.scaler.init(), step.scaler.init()
    rng = np.random.RandomState(6)
    for i in range(3):
        g = (16 * rng.randn(ps.master.shape[0])).astype(np.float32)
        if i == 1:
            g[11] = np.inf
        before = ps.master.clone()
        rs, rss, raux = rstep(rs, jnp.asarray(g), rss)
        ps, pss, aux = step(ps, torch.from_numpy(g), pss)
        assert float(aux.found_inf) == float(raux.found_inf)
        assert pss.loss_scale == float(rss.loss_scale)
        assert ps.count == int(rs.count)
        np.testing.assert_array_equal(_bits(ps.slots["v"].numpy()),
                                      _bits(rs.slots["v"]))
        _assert_p_close(ps.master.numpy(), np.asarray(rs.master),
                        before.numpy(), product_ulps=4)
        ps.master.copy_(torch.from_numpy(np.array(rs.master)))
    assert pss.loss_scale == 8.0     # backed off once


def _space_and_ids():
    space = FlatSpace.create({"a": torch.zeros(3000), "b": torch.zeros(10),
                              "c": torch.zeros(4097)})
    return space, space.tile_leaf_ids(2048)


def test_elementwise_per_tensor_and_sumsq_match_reference():
    space, ids = _space_and_ids()
    rng = np.random.RandomState(7)
    x = rng.randn(space.total).astype(np.float32)
    per = np.asarray([2.0, -1.0, 0.5], np.float32)

    def ref_fn(ins, s, t):
        return [ins[0] * t[0] + s[0]]

    def port_fn(ins, s, t):
        return [ins[0] * t[0] + s[0]]

    kw = dict(scalars=[0.25], tile_ids=ids, tile_rows=16,
              sumsq_subtiles=[("in", 0), ("out", 0)], check_finite=(0,))
    (wy, wsq_in, wsq_out), wf = ref_fe(ref_fn, [jnp.asarray(x)],
                                       per_tensor=[jnp.asarray(per)],
                                       impl="xla", **kw)
    (gy, gsq_in, gsq_out), gf = fused_elementwise(
        port_fn, [torch.from_numpy(x)], per_tensor=[torch.from_numpy(per)],
        **kw)
    np.testing.assert_array_equal(gy.numpy(), np.asarray(wy))
    for got, want in ((gsq_in, wsq_in), (gsq_out, wsq_out)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert float(gf) == float(wf) == 0.0


def test_flat_space_layout_and_views():
    params = {"w": torch.randn(5, 7), "b": torch.randn(3)}
    space = FlatSpace.create(params)
    assert space.offsets == (0, 2048) and space.total == 4096
    buf = space.pack(params)
    assert (buf[35:2048] == 0).all() and (buf[2051:] == 0).all()
    views = space.unpack(buf)
    assert all(torch.equal(views[k], params[k]) for k in params)
    views["w"].add_(1.0)            # a view: the buffer sees it
    assert buf[0] == params["w"][0, 0] + 1.0

    grad_of = space.grad_fn(lambda p, x: (p["w"].sum(0) * x[:7]).sum()
                            + (p["b"] ** 2).sum(), with_value=True)
    loss, g = grad_of(buf, torch.arange(7.0))
    assert g.shape == buf.shape and (g[35:2048] == 0).all()
    torch.testing.assert_close(g[:35].view(5, 7),
                               torch.arange(7.0).expand(5, 7))
    torch.testing.assert_close(g[2048:2051], 2 * views["b"])


def test_engine_rejects_what_it_does_not_take():
    """The reference's stochastic-rounding checks (engine.py sr_outputs):
    a seed is required and the output must be bf16."""
    x = torch.zeros(8)
    with pytest.raises(ValueError, match="requires sr_seed"):
        fused_elementwise(lambda i, s, t: [i[0]], [x], sr_outputs=(0,),
                          out_dtypes=[torch.bfloat16])
    with pytest.raises(ValueError, match="targets bfloat16"):
        fused_elementwise(lambda i, s, t: [i[0]], [x], sr_outputs=(0,),
                          sr_seed=1)
    with pytest.raises(TypeError, match="in place"):
        fused_elementwise(lambda i, s, t: [i[0]], [x],
                          out_dtypes=[torch.bfloat16], aliases={0: 0})
