"""The four RoPE variants of apex_tpu_torch against apex_tpu.

``fused_apply_rotary_pos_emb`` (sbhd), ``_cached``, ``_thd`` (packed
varlen, uneven ``cu_seqlens``) and ``_2d`` (``img_h != img_w``), forward
and gradient (``jax.vjp`` of the reference against the port's autograd
on the same numpy inputs and cotangent), in fp32 and bf16, with the
rotated width equal to the head width and smaller than it. The
reference runs its XLA path and its Pallas kernel in interpret mode (the
``impl`` fixture; 2d is XLA in every impl); the port runs its plain
version on CPU tensors (the CUDA kernel is held against it on the card,
``tests/test_torch_kernels_cuda.py``). bf16 inputs cross as uint16 bit
patterns.

Tolerances. sbhd and thd take cos and sin of the angles on each side,
and ``torch.cos`` and ``jnp.cos`` on the CPU may be an fp32 ulp apart:
fp32 outputs and gradients within 4e-7 of the larger |value| plus 4e-7
(an ulp of cos or sin moves a product by 2^-24 of |t|, and t is of
order 1); bf16 within one bf16 ulp of the larger value (2^-7: fp32
results a few ulps apart may round to neighbouring bf16 values). The
cached and 2d variants take the same cos and sin on both sides: fp32
within 2.4e-7 of the larger |value| plus 1e-7 (XLA's CPU compiler may
contract x * cos + r * sin into one multiply-add, which the port's
separately rounded product and sum differ from by an ulp of the
result), bf16 within one bf16 ulp.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from apex_tpu.ops import rope as ref

from apex_tpu_torch.ops import rope as port
from apex_tpu_torch.transformer.functional import (
    fused_apply_rotary_pos_emb,
    fused_apply_rotary_pos_emb_2d,
    fused_apply_rotary_pos_emb_cached,
    fused_apply_rotary_pos_emb_thd,
)

ANGLE_TOL = {"fp32": (4e-7, 4e-7), "bf16": (2.0 ** -7, 0.0)}
SAME_TABLE_TOL = {"fp32": (2.4e-7, 1e-7), "bf16": (2.0 ** -7, 0.0)}
S, B, H, D = 12, 2, 3, 32
ROTS = [32, 24]              # rot == d and rot < d


def _pair(x, dt):
    """The same values for both sides, bf16 crossing as uint16 bits."""
    if dt == "fp32":
        return jnp.asarray(x), torch.from_numpy(x.copy())
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    bits = np.asarray(xj).view(np.uint16).view(np.int16).copy()
    return xj, torch.from_numpy(bits).view(torch.bfloat16)


def _ref_vjp(fn, tj, g):
    out, vjp = jax.vjp(fn, tj)
    (dt,) = vjp(jnp.asarray(g).astype(out.dtype))
    return (np.asarray(out.astype(jnp.float32)),
            np.asarray(dt.astype(jnp.float32)))


def _port_vjp(fn, tt, g):
    tt = tt.clone().requires_grad_()
    out = fn(tt)
    assert out.dtype == tt.dtype and out.shape == tt.shape
    out.backward(torch.from_numpy(g).to(out.dtype))
    return out.detach().float().numpy(), tt.grad.float().numpy()


def _close(got, want, tol):
    rel, atol = tol
    bound = rel * np.maximum(np.abs(got), np.abs(want)) + atol
    excess = np.abs(got - want) - bound
    assert (excess <= 0).all(), float(np.abs(got - want).max())


def _data(shape, rot, seed, s=None):
    rng = np.random.RandomState(seed)
    t = rng.randn(*shape).astype(np.float32)
    freqs = (3 * rng.randn(s or shape[0], 1, 1, rot)).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    return t, freqs, g


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("rot", ROTS)
def test_sbhd_matches_reference(impl, dt, rot):
    t, freqs, g = _data((S, B, H, D), rot, seed=1)
    tj, tt = _pair(t, dt)
    want, want_dt = _ref_vjp(
        lambda x: ref.fused_apply_rotary_pos_emb(x, jnp.asarray(freqs),
                                                 impl=impl), tj, g)
    got, got_dt = _port_vjp(
        lambda x: fused_apply_rotary_pos_emb(x, torch.from_numpy(freqs)),
        tt, g)
    _close(got, want, ANGLE_TOL[dt])
    _close(got_dt, want_dt, ANGLE_TOL[dt])


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("rot", ROTS)
def test_cached_matches_reference(impl, dt, rot):
    t, freqs, g = _data((S, B, H, D), rot, seed=2)
    cos, sin = np.cos(freqs), np.sin(freqs)
    tj, tt = _pair(t, dt)
    want, want_dt = _ref_vjp(
        lambda x: ref.fused_apply_rotary_pos_emb_cached(
            x, jnp.asarray(cos), jnp.asarray(sin), impl=impl), tj, g)
    got, got_dt = _port_vjp(
        lambda x: fused_apply_rotary_pos_emb_cached(
            x, torch.from_numpy(cos), torch.from_numpy(sin)), tt, g)
    _close(got, want, SAME_TABLE_TOL[dt])
    _close(got_dt, want_dt, SAME_TABLE_TOL[dt])


def test_cached_broadcast_cos_takes_the_plain_version():
    """cos and sin that also vary along the batch axis: the reference
    broadcasts them through XLA in every impl, the port's plain version
    does the same (its kernel refuses them)."""
    t, _, _ = _data((4, 2, 3, 8), 8, seed=3)
    f = np.random.RandomState(4).randn(4, 2, 1, 8).astype(np.float32)
    cos, sin = np.cos(f), np.sin(f)
    want = ref.fused_apply_rotary_pos_emb_cached(
        jnp.asarray(t), jnp.asarray(cos), jnp.asarray(sin), impl="interpret")
    got = fused_apply_rotary_pos_emb_cached(
        torch.from_numpy(t), torch.from_numpy(cos), torch.from_numpy(sin))
    _close(got.numpy(), np.asarray(want), SAME_TABLE_TOL["fp32"])


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("rot", ROTS)
def test_thd_matches_reference_with_uneven_sequences(impl, dt, rot):
    cu = np.asarray([0, 5, 6, 17, 24], np.int32)    # lengths 5, 1, 11, 7
    t, freqs, g = _data((24, H, D), rot, seed=5, s=16)
    tj, tt = _pair(t, dt)
    want, want_dt = _ref_vjp(
        lambda x: ref.fused_apply_rotary_pos_emb_thd(
            x, jnp.asarray(cu), jnp.asarray(freqs), impl=impl), tj, g)
    got, got_dt = _port_vjp(
        lambda x: fused_apply_rotary_pos_emb_thd(
            x, torch.from_numpy(cu), torch.from_numpy(freqs)), tt, g)
    _close(got, want, ANGLE_TOL[dt])
    _close(got_dt, want_dt, ANGLE_TOL[dt])


def test_thd_positions_restart_at_each_boundary():
    cu = torch.tensor([0, 5, 6, 17, 24], dtype=torch.int32)
    pos = port._thd_positions(cu, 24, 16)
    want = np.concatenate([np.arange(5), np.arange(1), np.arange(11),
                           np.arange(7)])
    np.testing.assert_array_equal(pos.numpy(), want)
    # the thd result is the sbhd rotation of each sequence on its own
    t, freqs, _ = _data((24, H, D), 24, seed=6, s=16)
    got = fused_apply_rotary_pos_emb_thd(torch.from_numpy(t), cu,
                                         torch.from_numpy(freqs))
    for a, b in ((0, 5), (5, 6), (6, 17), (17, 24)):
        one = fused_apply_rotary_pos_emb(
            torch.from_numpy(t[a:b, None]), torch.from_numpy(freqs[:b - a]))
        assert torch.equal(got[a:b], one[:, 0])


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_2d_matches_reference(dt):
    b, img_h, img_w, heads, d = 2, 3, 5, 2, 16
    rng = np.random.RandomState(7)
    t = rng.randn(b, img_h * img_w, heads, d).astype(np.float32)
    g = rng.randn(*t.shape).astype(np.float32)
    fh = rng.randn(img_h, d // 2).astype(np.float32)
    fw = rng.randn(img_w, d // 2).astype(np.float32)
    tabs = [np.cos(fh), np.sin(fh), np.cos(fw), np.sin(fw)]
    tj, tt = _pair(t, dt)
    want, want_dt = _ref_vjp(
        lambda x: ref.fused_apply_rotary_pos_emb_2d(
            x, img_h, img_w, *map(jnp.asarray, tabs)), tj, g)
    got, got_dt = _port_vjp(
        lambda x: fused_apply_rotary_pos_emb_2d(
            x, img_h, img_w, *map(torch.from_numpy, tabs)), tt, g)
    _close(got, want, SAME_TABLE_TOL[dt])
    _close(got_dt, want_dt, SAME_TABLE_TOL[dt])


def test_backward_is_the_rotation_by_minus_sin():
    """With independent angles in the two halves the -sin rotation is
    not the exact transpose of the forward; the reference takes it all
    the same, and so does the port (on every variant)."""
    t, freqs, g = _data((S, B, H, D), D, seed=8)
    tt = torch.from_numpy(t).requires_grad_()
    fused_apply_rotary_pos_emb(tt, torch.from_numpy(freqs)).backward(
        torch.from_numpy(g))
    cos = torch.cos(torch.from_numpy(freqs))
    sin = torch.sin(torch.from_numpy(freqs))
    assert torch.equal(tt.grad, port._apply_torch(torch.from_numpy(g), cos,
                                                  -sin))
    exact = torch.func.vjp(lambda x: port._apply_torch(x, cos, sin),
                           torch.from_numpy(t))[1](torch.from_numpy(g))[0]
    assert not torch.allclose(tt.grad, exact, atol=1e-3)


def test_freqs_and_tables_get_no_gradient():
    t, freqs, _ = _data((S, B, H, D), 24, seed=9)
    tt = torch.from_numpy(t).requires_grad_()
    ft = torch.from_numpy(freqs).requires_grad_()
    cos = torch.cos(ft.detach()).requires_grad_()
    cu = torch.tensor([0, 7, 12], dtype=torch.int32)
    outs = [fused_apply_rotary_pos_emb(tt, ft),
            fused_apply_rotary_pos_emb_cached(tt, cos, torch.sin(ft)),
            fused_apply_rotary_pos_emb_thd(tt.reshape(S, B * H, D), cu, ft)]
    sum(o.float().sum() for o in outs).backward()
    assert tt.grad is not None
    assert ft.grad is None and cos.grad is None


def test_the_kernel_takes_no_plain_path_arguments():
    """What the kernel's wrapper refuses before it would build or launch:
    an odd rotated width or one wider than the head, and tables that vary
    along more than the position axis (this runs the checks on the CPU,
    where the launch itself is not reached)."""
    t = torch.zeros(4, 2, 8)
    for cos in (torch.zeros(4, 1, 7), torch.zeros(4, 1, 10),
                torch.zeros(4, 2, 8), torch.zeros(3, 1, 8)):
        with pytest.raises(ValueError):
            port._rope_cuda(t, cos, cos.clone())
    with pytest.raises(TypeError):
        port._rope_cuda(t.double(), torch.zeros(4, 1, 8),
                        torch.zeros(4, 1, 8))
    with pytest.raises(ValueError):
        port._rope_cuda(t.transpose(0, 1), torch.zeros(2, 1, 8),
                        torch.zeros(2, 1, 8))
