"""``apex_tpu_torch.amp.scale_loss`` and ``LossScaler.unscale`` against
the reference's on the CPU.

``unscale`` is held bitwise (one fp32 multiply by the fp32 reciprocal and
a cast back, on both sides) over fp32, fp16 and bf16 leaves, with
``found_inf`` 0, then 1 for an inf placed at a fixed index. The handle:
the scaled loss, the unscaled gradients of a small least-squares model
(the port's by ``backward``, the reference's by ``jax.grad`` of the
scaled loss; equal within 1e-6 relative, fp32 sums in other orders),
the advanced scaler state, ``delay_unscale`` and two loss ids whose
scalers move apart (one overflows), each scaler state equal to the
reference's, and the out-of-range error word for word.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from apex_tpu import amp as ref_amp

from apex_tpu_torch import amp

GRAD_RTOL = 1e-6


def _grads():
    r = np.random.RandomState(0)
    return {"w": (1e4 * r.randn(5, 7)).astype(np.float32),
            "h": (1e3 * r.randn(33)).astype(np.float16),
            "b": (1e2 * r.randn(9)).astype(np.float32)}


def _states(scale):
    ref = ref_amp.LossScaler(init_scale=scale)
    port = amp.LossScaler(init_scale=scale)
    return ref, ref.init(), port, port.init()


def _bits(a):
    a = np.asarray(a)
    return a.view({2: np.uint16, 4: np.uint32}[a.dtype.itemsize])


@pytest.mark.parametrize("scale", [2.0 ** 16, 3.0, 1000.0])
def test_unscale_is_bitwise(scale):
    ref, rs, port, ps = _states(scale)
    g = _grads()
    rg = {k: jnp.asarray(v) for k, v in g.items()}
    rg["bf"] = jnp.asarray(g["b"]).astype(jnp.bfloat16)
    pg = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
    pg["bf"] = torch.from_numpy(g["b"].copy()).bfloat16()
    want, wf = ref.unscale(rg, rs)
    got, gf = port.unscale(pg, ps)
    for k in want:
        w = np.asarray(want[k].astype(jnp.float32)) if k == "bf" else \
            np.asarray(want[k])
        p = got[k].float().numpy() if k == "bf" else got[k].numpy()
        assert got[k].dtype == pg[k].dtype
        np.testing.assert_array_equal(_bits(p), _bits(w))
    assert float(gf) == float(wf) == 0.0
    assert gf.dtype == torch.float32 and gf.ndim == 0


def test_unscale_finds_an_inf():
    ref, rs, port, ps = _states(2.0 ** 16)
    g = _grads()
    g["h"][17] = np.inf
    want, wf = ref.unscale({k: jnp.asarray(v) for k, v in g.items()}, rs)
    got, gf = port.unscale({k: torch.from_numpy(v.copy())
                            for k, v in g.items()}, ps)
    assert float(gf) == float(wf) == 1.0
    assert np.isinf(got["h"][17].item())


class _Lsq:
    """loss = mean((x @ w - y)^2) for the reference and the port."""

    def __init__(self, seed=0):
        r = np.random.RandomState(seed)
        self.x = r.randn(8, 5).astype(np.float32)
        self.y = r.randn(8, 3).astype(np.float32)
        self.w = r.randn(5, 3).astype(np.float32)

    def ref_loss(self, w):
        return jnp.mean(jnp.square(jnp.asarray(self.x) @ w
                                   - jnp.asarray(self.y)))

    def port(self):
        w = torch.nn.Parameter(torch.from_numpy(self.w.copy()))
        loss = (torch.from_numpy(self.x) @ w
                - torch.from_numpy(self.y)).square().mean()
        return w, loss


def _amp_states(n, scale=2.0 ** 16):
    ref_s = ref_amp.make_scaler(ref_amp.OPT_LEVELS["O1"])
    port_s = amp.make_scaler(amp.OPT_LEVELS["O1"])
    ref_state = ref_amp.AmpState(ref_amp.OPT_LEVELS["O1"],
                                 tuple(ref_s.init() for _ in range(n)))
    port_state = amp.AmpState(amp.OPT_LEVELS["O1"],
                              tuple(port_s.init() for _ in range(n)))
    return ref_state, port_state


def _ref_block(model, state, loss_id=0, delay=False, poison=False):
    w = jnp.asarray(model.w)
    with ref_amp.scale_loss(model.ref_loss(w), state, loss_id=loss_id,
                            delay_unscale=delay) as s:
        scale = state.scalers[loss_id].loss_scale
        g = jax.grad(lambda p: model.ref_loss(p) * scale)(w)
        if poison:
            g = g.at[1, 2].set(jnp.inf)
        s.grads = {"w": g}
    return s


def _port_block(model, state, loss_id=0, delay=False, poison=False):
    w, loss = model.port()
    with amp.scale_loss(loss, state, loss_id=loss_id,
                        delay_unscale=delay) as s:
        s.loss.backward()
        g = w.grad
        if poison:
            g[1, 2] = float("inf")
        s.grads = {"w": g}
    return s


def _same_scalers(ref_state, port_state):
    for r, p in zip(ref_state.scalers, port_state.scalers):
        assert float(r.loss_scale) == p.loss_scale
        assert int(r.unskipped) == p.unskipped
        assert float(r.found_inf) == p.found_inf


def _close(want, got):
    w = np.asarray(want)
    err = np.abs(got.detach().numpy() - w).max()
    assert err <= GRAD_RTOL * np.abs(w).max(), err


def test_scale_loss_unscales_and_advances():
    model = _Lsq()
    rs, ps = _amp_states(1)
    want = _ref_block(model, rs)
    got = _port_block(model, ps)
    assert abs(float(got.loss) - float(want.loss)) <= \
        GRAD_RTOL * abs(float(want.loss))
    _close(want.grads["w"], got.grads["w"])
    _same_scalers(want.amp_state, got.amp_state)
    assert float(got.skip) == float(want.skip) == 0.0
    assert got.amp_state.scalers[0].unskipped == 1


def test_delay_unscale_leaves_grads_scaled():
    model = _Lsq(1)
    rs, ps = _amp_states(1)
    want = _ref_block(model, rs, delay=True)
    got = _port_block(model, ps, delay=True)
    _close(want.grads["w"], got.grads["w"])
    assert got.amp_state is ps and float(got.skip) == 0.0
    assert float(got.grads["w"].abs().max()) > 1000.0     # still scaled


def test_two_loss_ids_move_apart():
    model = _Lsq(2)
    rs, ps = _amp_states(2)
    for step in range(3):
        # loss 0 overflows at step 1; loss 1 never does
        for loss_id in (0, 1):
            poison = loss_id == 0 and step == 1
            want = _ref_block(model, rs, loss_id, poison=poison)
            got = _port_block(model, ps, loss_id, poison=poison)
            assert float(got.skip) == float(want.skip) == float(poison)
            rs, ps = want.amp_state, got.amp_state
            _same_scalers(rs, ps)
    assert ps.scalers[0].loss_scale == 2.0 ** 15
    assert ps.scalers[1].loss_scale == 2.0 ** 16
    assert (ps.scalers[0].unskipped, ps.scalers[1].unskipped) == (1, 3)


def test_loss_id_out_of_range():
    model = _Lsq()
    rs, ps = _amp_states(2)
    with pytest.raises(ValueError) as ref_err:
        with ref_amp.scale_loss(model.ref_loss(jnp.asarray(model.w)), rs,
                                loss_id=2):
            pass
    with pytest.raises(ValueError) as port_err:
        with amp.scale_loss(model.port()[1], ps, loss_id=2):
            pass
    assert str(port_err.value) == str(ref_err.value)


def test_no_grads_given_counts_a_clean_step():
    model = _Lsq()
    rs, ps = _amp_states(1)
    with ref_amp.scale_loss(model.ref_loss(jnp.asarray(model.w)), rs) as w_:
        pass
    with amp.scale_loss(model.port()[1], ps) as g_:
        pass
    _same_scalers(w_.amp_state, g_.amp_state)
    assert float(g_.skip) == 0.0 and g_.grads is None
