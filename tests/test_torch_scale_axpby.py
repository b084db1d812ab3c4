"""multi_tensor_scale, multi_tensor_axpby and the contrib gradient clip
of apex_tpu_torch against apex_tpu.

The same numpy buffers go through the reference (``impl="xla"`` and its
Pallas kernel in interpret mode) and the port's plain PyTorch path, which
is what CPU tensors take (the CUDA kernels are held bitwise against the
same plain path on the card by ``tests/test_torch_kernels_cuda.py``).
bf16 and fp16 buffers cross as the same fp32 values cast on each side
(both casts round to nearest even).

Tolerances. scale and axpby: bitwise in every dtype pair (both round the
fp32 product, the sum and the cast each on its own), and the found flag
exact. The clip: the global norm within 1e-6 relative (fp32 sums of
squares in another order: the reference's tile partials against the
port's), the clipped gradients within 2e-6 relative (the factor follows
the norm), and bitwise where no clip applies (a factor of 1).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from apex_tpu.contrib.clip_grad import clip_grad_norm_ as ref_clip
from apex_tpu.multi_tensor.ops import multi_tensor_axpby as ref_axpby
from apex_tpu.multi_tensor.ops import multi_tensor_scale as ref_scale

from apex_tpu_torch.contrib.clip_grad import clip_grad_norm_
from apex_tpu_torch.multi_tensor import (
    FlatSpace,
    multi_tensor_axpby,
    multi_tensor_scale,
)

N = 3 * 2048 + 517
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "fp16": (jnp.float16, torch.float16)}


def _pair(a: np.ndarray, dt: str):
    """The same values as a jax array and a torch tensor of dtype ``dt``."""
    jdt, tdt = DTYPES[dt]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a.copy()).to(tdt)


def _bits32(x) -> np.ndarray:
    """fp32 bits of a jax array or torch tensor of any float dtype (the
    widening to fp32 is exact)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy().view(np.int32)
    return np.asarray(x.astype(jnp.float32)).view(np.int32)


@pytest.mark.parametrize("out_dt", sorted(DTYPES))
@pytest.mark.parametrize("in_dt", sorted(DTYPES))
def test_scale_matches_reference_bitwise(impl, in_dt, out_dt):
    rng = np.random.RandomState(0)
    x = (rng.randn(N) * 3).astype(np.float32)
    jx, tx = _pair(x, in_dt)
    want, wf = ref_scale(jx, 0.37, out_dtype=DTYPES[out_dt][0], impl=impl)
    got, gf = multi_tensor_scale(tx, 0.37, out_dtype=DTYPES[out_dt][1])
    assert got.dtype == DTYPES[out_dt][1]
    np.testing.assert_array_equal(_bits32(got), _bits32(want))
    assert float(gf) == float(wf) == 0.0


@pytest.mark.parametrize("bad", [np.inf, -np.inf, np.nan])
def test_scale_found_inf(impl, bad):
    x = np.random.RandomState(1).randn(4096).astype(np.float32)
    x[17] = bad
    _, wf = ref_scale(jnp.asarray(x), 0.5, impl=impl)
    _, gf = multi_tensor_scale(torch.from_numpy(x), 0.5)
    assert float(gf) == float(wf) == 1.0


@pytest.mark.parametrize("case", ["fp32", "fp16_out"])
def test_scale_overflow_detected_post_scale(impl, case):
    """Finite inputs whose scaled values overflow the output dtype: the
    flag covers the outputs after the cast, as the reference's."""
    if case == "fp32":
        x, s, out = np.full(2048, 3e38, np.float32), 10.0, None
    else:
        x, s, out = np.full(2048, 3e4, np.float32), 4.0, "fp16"
    _, wf = ref_scale(jnp.asarray(x), s, impl=impl,
                      out_dtype=out and DTYPES[out][0])
    _, gf = multi_tensor_scale(torch.from_numpy(x), s,
                               out_dtype=out and DTYPES[out][1])
    assert float(gf) == float(wf) == 1.0


def test_scale_in_place_and_tensor_scale():
    x = np.random.RandomState(2).randn(N).astype(np.float32)
    want, _ = ref_scale(jnp.asarray(x), 0.125, impl="xla")
    t = torch.from_numpy(x.copy())
    got, found = multi_tensor_scale(t, torch.tensor(0.125), in_place=True)
    assert got is t and float(found) == 0.0
    np.testing.assert_array_equal(_bits32(t), _bits32(want))
    t2 = torch.from_numpy(x.copy())
    out, _ = multi_tensor_scale(t2, 0.125, plain=True)
    np.testing.assert_array_equal(t2.numpy(), x)       # out of place
    np.testing.assert_array_equal(_bits32(out), _bits32(want))
    with pytest.raises(TypeError, match="in place"):
        multi_tensor_scale(t2, 2.0, out_dtype=torch.bfloat16, in_place=True)


@pytest.mark.parametrize("out_dt", sorted(DTYPES))
@pytest.mark.parametrize("in_dt", ["fp32", "bf16"])
def test_axpby_matches_reference_bitwise(impl, in_dt, out_dt):
    rng = np.random.RandomState(3)
    x, y = (rng.randn(5000).astype(np.float32) for _ in range(2))
    (jx, tx), (jy, ty) = _pair(x, in_dt), _pair(y, "fp32")
    want, wf = ref_axpby(jx, jy, 2.0, -3.0, out_dtype=DTYPES[out_dt][0],
                         impl=impl)
    got, gf = multi_tensor_axpby(tx, ty, 2.0, -3.0,
                                 out_dtype=DTYPES[out_dt][1])
    assert got.dtype == DTYPES[out_dt][1]
    np.testing.assert_array_equal(_bits32(got), _bits32(want))
    assert float(gf) == float(wf) == 0.0


@pytest.mark.parametrize("bad", [np.nan, np.inf])
@pytest.mark.parametrize("arg_to_check,bad_x,expect", [
    (-1, True, 1.0), (-1, False, 1.0), (0, True, 1.0),
    (0, False, 0.0), (1, False, 1.0), (1, True, 0.0),
])
def test_axpby_arg_to_check(impl, arg_to_check, bad_x, expect, bad):
    rng = np.random.RandomState(4)
    x, y = (rng.randn(3000).astype(np.float32) for _ in range(2))
    (x if bad_x else y)[5] = bad
    _, wf = ref_axpby(jnp.asarray(x), jnp.asarray(y), 1.0, 1.0,
                      arg_to_check=arg_to_check, impl=impl)
    _, gf = multi_tensor_axpby(torch.from_numpy(x), torch.from_numpy(y),
                               1.0, 1.0, arg_to_check=arg_to_check)
    assert float(gf) == float(wf) == expect


def test_axpby_in_place_and_tensor_scalars():
    rng = np.random.RandomState(5)
    x, y = (rng.randn(N).astype(np.float32) for _ in range(2))
    want, _ = ref_axpby(jnp.asarray(x), jnp.asarray(y), 0.5, 1.5, impl="xla")
    tx = torch.from_numpy(x.copy())
    got, _ = multi_tensor_axpby(tx, torch.from_numpy(y), torch.tensor(0.5),
                                torch.tensor(1.5), in_place=True)
    assert got is tx
    np.testing.assert_array_equal(_bits32(tx), _bits32(want))
    with pytest.raises(ValueError, match="arg_to_check"):
        multi_tensor_axpby(tx, tx, 1.0, 1.0, arg_to_check=2)


# -- clip_grad_norm_ (the reference's tests/test_contrib_ops.py:21-60) --------


def _tree(rng, scale=1.0):
    """Sorted names, so that both flat layouts order the leaves alike."""
    return {"a": (scale * rng.randn(17, 5)).astype(np.float32),
            "b": (scale * rng.randn(3)).astype(np.float32),
            "c": (scale * rng.randn(2, 2, 2)).astype(np.float32),
            "d": (scale * rng.randn(3000)).astype(np.float32)}


def _torch_tree(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _close(got: torch.Tensor, want, rtol: float) -> None:
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=0)


def test_clip_norm_and_clipped_grads_match_reference(impl):
    g = _tree(np.random.RandomState(6))
    want, wnorm = ref_clip({k: jnp.asarray(v) for k, v in g.items()}, 1.0,
                           impl=impl)
    tg = _torch_tree(g)
    got, norm = clip_grad_norm_(tg, 1.0)
    assert got is tg                                   # in place
    np.testing.assert_allclose(float(norm), float(wnorm), rtol=1e-6)
    for k in g:
        _close(tg[k], want[k], 2e-6)
    total = np.sqrt(sum(float((t.double() ** 2).sum()) for t in tg.values()))
    np.testing.assert_allclose(total, 1.0, rtol=1e-5)


def test_clip_below_max_leaves_grads_bitwise():
    g = _tree(np.random.RandomState(7), scale=1e-3)
    tg = _torch_tree(g)
    _, norm = clip_grad_norm_(tg, 10.0)
    assert float(norm) < 10.0
    for k in g:
        np.testing.assert_array_equal(tg[k].numpy(), g[k])


def test_clip_flat_buffer_in_place_matches_mapping():
    """A flat fp32 buffer (``PretrainStep.grad``) is scaled where it
    lies; the result is the mapping path's, leaf for leaf."""
    g = _tree(np.random.RandomState(8))
    space = FlatSpace.create(_torch_tree(g))
    buf = space.pack(_torch_tree(g))
    ptr = buf.data_ptr()
    out, norm = clip_grad_norm_(buf, 0.5)
    assert out is buf and buf.data_ptr() == ptr
    tg = _torch_tree(g)
    _, norm2 = clip_grad_norm_(tg, 0.5)
    assert float(norm) == float(norm2)
    views = space.unpack(buf, "buffer")
    for k in g:
        np.testing.assert_array_equal(views[k].numpy(), tg[k].numpy())


def test_clip_sequence_with_bf16_leaves_matches_reference():
    rng = np.random.RandomState(9)
    leaves = [rng.randn(300).astype(np.float32),
              rng.randn(7, 9).astype(np.float32)]
    want, wnorm = ref_clip([jnp.asarray(leaves[0]).astype(jnp.bfloat16),
                            jnp.asarray(leaves[1])], 0.25, impl="xla")
    got = [torch.from_numpy(leaves[0]).to(torch.bfloat16),
           torch.from_numpy(leaves[1].copy())]
    out, norm = clip_grad_norm_(got, 0.25)
    assert out is got and got[0].dtype == torch.bfloat16
    np.testing.assert_allclose(float(norm), float(wnorm), rtol=1e-6)
    # bf16: the factor within 2e-6 may round to the neighbouring bf16
    np.testing.assert_allclose(got[0].float().numpy(),
                               np.asarray(want[0].astype(jnp.float32)),
                               rtol=2.0 ** -8, atol=0)
    _close(got[1], want[1], 2e-6)


@pytest.mark.parametrize("norm_type", [float("inf"), 1.0, 3.0])
def test_clip_other_norms_match_reference(norm_type):
    g = _tree(np.random.RandomState(10))
    want, wnorm = ref_clip({k: jnp.asarray(v) for k, v in g.items()}, 0.5,
                           norm_type=norm_type)
    tg = _torch_tree(g)
    _, norm = clip_grad_norm_(tg, 0.5, norm_type=norm_type)
    np.testing.assert_allclose(float(norm), float(wnorm), rtol=1e-6)
    for k in g:
        _close(tg[k], want[k], 2e-6)


def test_clip_error_if_nonfinite_and_empty():
    g = _torch_tree(_tree(np.random.RandomState(11)))
    g["b"][1] = float("nan")
    for norm_type in (2.0, float("inf")):
        with pytest.raises(RuntimeError, match="non-finite"):
            clip_grad_norm_(dict(g), 1.0, norm_type=norm_type,
                            error_if_nonfinite=True)
    _, norm = clip_grad_norm_(g, 1.0)          # no check: the norm is nan
    assert not np.isfinite(float(norm))
    empty, norm = clip_grad_norm_({}, 1.0)
    _, wnorm = ref_clip({}, 1.0)
    assert empty == {} and float(norm) == float(wnorm) == 0.0


def test_clip_under_jit_has_no_counterpart_but_runs_eagerly():
    """The reference's jit case (test_contrib_ops.py:57): the port runs
    eagerly, with nothing read on the host."""
    g = _tree(np.random.RandomState(12))
    _, wnorm = jax.jit(lambda t: ref_clip(t, 0.5))(
        {k: jnp.asarray(v) for k, v in g.items()})
    _, norm = clip_grad_norm_(_torch_tree(g), 0.5)
    assert np.isfinite(float(norm))
    np.testing.assert_allclose(float(norm), float(wnorm), rtol=1e-6)
