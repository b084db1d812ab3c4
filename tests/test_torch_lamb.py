"""The sum-of-squares partials, the L2 norms, the two LAMB stages, the
segmented layout, the one-pass segment pass, FusedLAMB and the train
step's clip of apex_tpu_torch against apex_tpu.

The same numpy buffers go through the reference (``impl="xla"`` and,
where it has a Pallas kernel, the kernel in interpret mode) and the
port's plain PyTorch path, which is what CPU tensors take (the CUDA
kernels are held against the same plain path on the card by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``).

Tolerances.
- Sums of squares, norms and ratios: relative 1e-5 (fp32 sums of up to
  ~10^5 terms taken in another order; observed ~1e-7).
- m' and v': bitwise, wherever both sides divide g by the same divisor
  (the clip factor handed in, or no clip). Where each side computes its
  own global norm, the clip factor may differ in its last bit, and m'
  and v' are held to relative 1e-6 of each buffer's largest |value|.
- u: XLA's CPU compiler contracts ``u + wd * p`` into a fused
  multiply-add (skipping one rounding of the product) and rewrites
  ``(m' / bc1) / (sqrt(v' / bc2) + eps)`` as one division by a product
  (two roundings in another place): |du| <= 2 ulp(wd * p) + 6 ulp(u)
  (observed 4 ulp(u)).
- p': p - lr * ratio * u, with the ratio 1e-5 apart at most and the
  reference contracting ``p - (lr * r) * u``: |dp'| <= 1e-5 |p - p'| +
  2 ulp(|p - p'|) + ulp(|p'|). Where each side computes its own clip,
  u moves with m' and v', and p' gets 1e-6 of the largest step on top.
- The reference's segment kernel path computes beta3 = 1 - beta1 in
  double and rounds it (``segmented.py:416``); its two-stage path in
  fp32 (``ops.py:358``): 0.1 against 0.100000024 at beta1 = 0.9. The
  port follows the two-stage path everywhere, so the comparison with
  the reference's segment kernel runs at beta1 = 0.875, where the two
  agree.
- The per-slot grad sums of the reference's segment kernel go through a
  one-hot matmul, where 0 * inf spreads a NaN over every slot of the
  segment; the port keeps the slots apart (its CUDA kernel too): with
  an injected inf, only the reference's finite slots are compared.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from apex_tpu.amp.scaler import LossScaler as RefScaler
from apex_tpu.multi_tensor import ops as rops
from apex_tpu.multi_tensor.engine import fused_sumsq_partials as ref_sumsq
from apex_tpu.multi_tensor.flat_buffer import FlatSpace as RefSpace
from apex_tpu.multi_tensor.flat_buffer import segmented_space as ref_segspace
from apex_tpu.multi_tensor.segmented import _small_segment_pass as ref_pass
from apex_tpu.multi_tensor.segmented import (
    fused_lamb_segmented_update as ref_seg_update,
)
from apex_tpu.optimizers import FusedAdam as RefAdam
from apex_tpu.optimizers import FusedLAMB as RefLAMB
from apex_tpu.optimizers import make_train_step as ref_make_train_step

from apex_tpu_torch.amp import LossScaler
from apex_tpu_torch.multi_tensor import (
    FlatSpace,
    fused_lamb_compute_update_term,
    fused_lamb_segmented_update,
    fused_lamb_update,
    fused_sumsq_partials,
    fused_unscale_l2norm,
    multi_tensor_l2norm,
    per_tensor_l2norm,
    segmented_space,
)
from apex_tpu_torch.multi_tensor.segmented import _small_segment_pass
from apex_tpu_torch.optimizers import (
    FusedAdam,
    FusedLAMB,
    FusedMixedPrecisionLamb,
    make_train_step,
)

NORM_RTOL = 1e-5
SEG = 65536


def _bits(a):
    return np.asarray(a).view(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _assert_u_close(got, want, p, wd):
    bound = 2 * np.spacing(np.abs(wd * p)) + 6 * np.spacing(np.abs(want))
    assert (np.abs(got - want) <= bound).all(), float(
        np.max(np.abs(got - want) - bound))


def _assert_p_close(got, want, p_in, floor=0.0):
    step = np.abs(p_in - want)
    bound = (1e-5 * step + 2 * np.spacing(step)
             + np.spacing(np.abs(want)).astype(np.float32)
             + floor * step.max())
    assert (np.abs(got - want) <= bound).all(), float(
        np.max(np.abs(got - want) - bound))


def _shapes():
    """Leaf shapes under sorted names, so the reference's tree order and
    the port's given order agree: small leaves, leaves that straddle a
    65,536-element segment, and large leaves of one and several
    segments."""
    sizes = [(3000,), (10,), (70000,), (40, 700), (5,), (130000,), (2048,),
             (61000,), (7,), (9000,)]
    return {f"l{i:02d}": s for i, s in enumerate(sizes)}


def _tree(seed=0, scale=1.0):
    rng = np.random.RandomState(seed)
    return {k: (scale * rng.randn(*s)).astype(np.float32)
            for k, s in _shapes().items()}


# -- sums of squares and norms ----------------------------------------------


@pytest.mark.parametrize("n", [1, 517, 2 * 65536 + 517])
@pytest.mark.parametrize("tile_rows", [None, 16])
@pytest.mark.parametrize("scale", [None, 0.375])
def test_sumsq_partials_match_reference(impl, n, tile_rows, scale):
    x = np.random.RandomState(n).randn(n).astype(np.float32)
    want = np.asarray(ref_sumsq(jnp.asarray(x), impl=impl,
                                tile_rows=tile_rows, scale=scale))
    got = fused_sumsq_partials(_t(x), tile_rows, scale=scale)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=NORM_RTOL)


def test_norm_helpers_match_reference(impl):
    tree = _tree(1)
    rspace = RefSpace.create({k: jnp.asarray(v) for k, v in tree.items()})
    space = FlatSpace.create({k: _t(v) for k, v in tree.items()})
    assert space.offsets == rspace.offsets and space.total == rspace.total
    buf = np.asarray(rspace.pack({k: jnp.asarray(v) for k, v in tree.items()}))
    rbuf, pbuf = jnp.asarray(buf), _t(buf)
    np.testing.assert_allclose(
        per_tensor_l2norm(pbuf, space).numpy(),
        np.asarray(rops.per_tensor_l2norm(rbuf, rspace, impl=impl)),
        rtol=NORM_RTOL)
    for per in (False, True):
        gn, pt = multi_tensor_l2norm(pbuf, space, per_tensor=per)
        rgn, rpt = rops.multi_tensor_l2norm(rbuf, rspace, per_tensor=per,
                                            impl=impl)
        np.testing.assert_allclose(float(gn), float(rgn), rtol=NORM_RTOL)
        assert (pt is None) == (rpt is None)
    norm, found = fused_unscale_l2norm(pbuf, inv_scale=0.25)
    rnorm, rfound = rops.fused_unscale_l2norm(rbuf, inv_scale=0.25,
                                              impl=impl)
    np.testing.assert_allclose(float(norm), float(rnorm), rtol=NORM_RTOL)
    assert float(found) == float(rfound) == 0.0
    for bad in (np.inf, np.nan):
        b = buf.copy()
        b[77] = bad
        assert float(fused_unscale_l2norm(_t(b))[1]) == float(
            rops.fused_unscale_l2norm(jnp.asarray(b), impl=impl)[1]) == 1.0


# -- the two LAMB stages ----------------------------------------------------


def _lamb_buffers(seed, n=3 * 2048 + 517):
    rng = np.random.RandomState(seed)
    p, m, g = (rng.randn(n).astype(np.float32) for _ in range(3))
    v = np.abs(rng.randn(n)).astype(np.float32)
    return p, m, v, g


@pytest.mark.parametrize("adam_w_mode", [True, False])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("with_grad", [False, True])
def test_stage1_matches_reference(impl, adam_w_mode, weight_decay,
                                  with_grad):
    p, m, v, g = _lamb_buffers(2)
    scal = dict(beta1=0.9, beta2=0.999, beta3=0.1, eps=1e-6,
                weight_decay=weight_decay, bias_correction1=0.19,
                bias_correction2=0.002997, adam_w_mode=adam_w_mode,
                inv_scale=3.0)
    (*wouts,), wfound = rops.fused_lamb_compute_update_term(
        *(jnp.asarray(a) for a in (p, m, v, g)), impl=impl,
        with_norm_partials=True, with_grad_partials=with_grad,
        **{k: (jnp.float32(x) if isinstance(x, float) else x)
           for k, x in scal.items()})
    ts = [_t(a) for a in (p, m, v, g)]
    outs, found = fused_lamb_compute_update_term(
        *ts, with_norm_partials=True, with_grad_partials=with_grad, **scal)
    assert outs[1] is ts[1] and outs[2] is ts[2]          # m, v in place
    assert torch.equal(ts[3], _t(g))                     # g left as it was
    np.testing.assert_array_equal(_bits(outs[1].numpy()), _bits(wouts[1]))
    np.testing.assert_array_equal(_bits(outs[2].numpy()), _bits(wouts[2]))
    _assert_u_close(outs[0].numpy(), np.asarray(wouts[0]), p, weight_decay)
    assert len(outs) == len(wouts) == (6 if with_grad else 5)
    for got, want in zip(outs[3:], wouts[3:]):
        np.testing.assert_allclose(got.sum(-1).numpy(),
                                   np.asarray(want).sum(-1), rtol=NORM_RTOL)
    assert float(found) == float(wfound) == 0.0


def _ref_space_and_buffers(tree, seed, segmented=False):
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    if segmented:
        rspace, rmeta = ref_segspace(jtree, seg_elems=SEG)
        space, meta = segmented_space({k: _t(v) for k, v in tree.items()},
                                      seg_elems=SEG)
    else:
        rspace, rmeta = RefSpace.create(jtree), None
        space, meta = FlatSpace.create({k: _t(v) for k, v in tree.items()}), \
            None
    p = np.array(rspace.pack(jtree))
    rng = np.random.RandomState(seed)
    m = np.array(rspace.pack({k: jnp.asarray(rng.randn(*v.shape) * 0.01)
                                for k, v in tree.items()}))
    v = np.array(rspace.pack({k: jnp.asarray(
        np.abs(rng.randn(*v_.shape)) * 1e-4) for k, v_ in tree.items()}))
    g = np.array(rspace.pack({k: jnp.asarray(rng.randn(*v_.shape) * 0.5)
                                for k, v_ in tree.items()}))
    return rspace, rmeta, space, meta, p, m, v, g


LAMB_FLAGS = [
    dict(),
    dict(adam_w_mode=False),
    dict(grad_averaging=False),
    dict(bias_correction=False),
    dict(use_nvlamb=True, weight_decay=0.0),
    dict(weight_decay=0.0),
    dict(max_grad_norm=1.0, global_grad_norm=3.5),
    dict(max_grad_norm=1.0, global_grad_norm=300.0, grad_scale=64.0),
    dict(grad_scale=8.0, with_grad_norm=True),
]


def _lamb_kw(flags):
    kw = dict(lr=2e-3, weight_decay=0.01, step=3)
    kw.update(flags)
    return kw


@pytest.mark.parametrize("flags", LAMB_FLAGS, ids=lambda f: "-".join(
    f"{k}={v}" for k, v in f.items()) or "default")
def test_fused_lamb_update_matches_reference(impl, flags):
    tree = _tree(3)
    rspace, _, space, _, p, m, v, g = _ref_space_and_buffers(tree, 4)
    kw = _lamb_kw(flags)
    want = rops.fused_lamb_update(*(jnp.asarray(a) for a in (p, m, v, g)),
                                  rspace, impl=impl, **kw)
    ts = [_t(a) for a in (p, m, v, g)]
    got = fused_lamb_update(*ts, space, **kw)
    assert got[0] is ts[0] and got[1] is ts[1] and got[2] is ts[2]
    np.testing.assert_array_equal(_bits(got[1].numpy()), _bits(want[1]))
    np.testing.assert_array_equal(_bits(got[2].numpy()), _bits(want[2]))
    _assert_p_close(got[0].numpy(), np.asarray(want[0]), p)
    assert float(got[3]) == float(want[3]) == 0.0
    assert len(got) == len(want)
    if kw.get("with_grad_norm"):
        np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                                   rtol=NORM_RTOL)


@pytest.mark.parametrize("grad_scale", [1.0, 16.0])
def test_fused_lamb_update_own_norm_matches_reference(grad_scale):
    """The clip from each side's own global norm (sums in other orders):
    m' and v' within relative 1e-6."""
    tree = _tree(5)
    rspace, _, space, _, p, m, v, g = _ref_space_and_buffers(tree, 6)
    kw = _lamb_kw(dict(max_grad_norm=1.0, grad_scale=grad_scale))
    want = rops.fused_lamb_update(*(jnp.asarray(a) for a in (p, m, v, g)),
                                  rspace, impl="xla", **kw)
    got = fused_lamb_update(*(_t(a) for a in (p, m, v, g)), space,
                            in_place=False, **kw)
    for a, b in zip(got[1:3], want[1:3]):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-6 * np.abs(b).max()
    _assert_p_close(got[0].numpy(), np.asarray(want[0]), p, floor=1e-6)


def test_out_of_place_lamb_leaves_inputs():
    tree = _tree(7)
    _, _, space, _, p, m, v, g = _ref_space_and_buffers(tree, 8)
    ts = [_t(a) for a in (p, m, v, g)]
    got = fused_lamb_update(*ts, space, lr=1e-3, in_place=False)
    for t, a in zip(ts, (p, m, v, g)):
        np.testing.assert_array_equal(t.numpy(), a)
    ts2 = [_t(a) for a in (p, m, v, g)]
    fused_lamb_update(*ts2, space, lr=1e-3)
    for a, b in zip(got[:3], ts2[:3]):
        assert torch.equal(a, b)


def test_lamb_found_inf_matches_reference(impl):
    tree = _tree(9)
    rspace, _, space, _, p, m, v, g = _ref_space_and_buffers(tree, 10)
    g[100] = np.nan
    want = rops.fused_lamb_update(*(jnp.asarray(a) for a in (p, m, v, g)),
                                  rspace, lr=1e-3, impl=impl)
    got = fused_lamb_update(*(_t(a) for a in (p, m, v, g)), space, lr=1e-3)
    assert float(got[3]) == float(want[3]) == 1.0


# -- the segmented layout and the segment pass -----------------------------


@pytest.mark.parametrize("seg_elems", [SEG, 2 * SEG])
@pytest.mark.parametrize("max_slots", [512, 3])
def test_segmented_space_matches_reference(seg_elems, max_slots):
    tree = _tree(11)
    rspace, rmeta = ref_segspace({k: jnp.asarray(v) for k, v in tree.items()},
                                 seg_elems=seg_elems, max_slots=max_slots)
    space, meta = segmented_space({k: _t(v) for k, v in tree.items()},
                                  seg_elems=seg_elems, max_slots=max_slots)
    assert space.offsets == rspace.offsets
    assert space.padded_sizes == rspace.padded_sizes
    assert space.sizes == rspace.sizes and space.total == rspace.total
    for f in ("seg_elems", "n_segments", "small_segments", "max_slots",
              "large"):
        assert getattr(meta, f) == getattr(rmeta, f), f
    np.testing.assert_array_equal(meta.slot_ids, rmeta.slot_ids)
    np.testing.assert_array_equal(meta.slot_leaf, rmeta.slot_leaf)
    assert meta.small_segments and (meta.large or seg_elems > SEG)


def test_segmented_space_default_size_is_chunk_multiple():
    space, meta = segmented_space({"a": torch.zeros(10), "b": torch.zeros(7)})
    assert meta.seg_elems == SEG and space.total == SEG


def _segment_case(seed, inject=False):
    tree = _tree(seed)
    rspace, rmeta, space, meta, p, m, v, g = _ref_space_and_buffers(
        tree, seed + 1, segmented=True)
    if inject:                     # a non-finite gradient in a small leaf
        seg = meta.small_segments[0]
        g[seg * SEG + 5] = np.inf
    return rspace, rmeta, space, meta, p, m, v, g


SEG_SCALARS = dict(b1=0.9, b2=0.999, beta3=0.1, eps=1e-6, wd=0.01, bc1=0.19,
                   bc2=0.002997, mode=1.0, inv_scale=2.0, lr=2e-3)


@pytest.mark.parametrize("stash_p", [True, False])
@pytest.mark.parametrize("with_grad_norm", [False, True])
@pytest.mark.parametrize("inject", [False, True])
def test_segment_pass_matches_reference_kernel(stash_p, with_grad_norm,
                                               inject):
    """The plain segment pass against the reference's Pallas kernel run
    in interpret mode."""
    _, rmeta, _, meta, p, m, v, g = _segment_case(12, inject)
    s = SEG_SCALARS
    scal = jnp.asarray([s[k] for k in ("b1", "b2", "beta3", "eps", "wd",
                                       "bc1", "bc2", "mode", "inv_scale",
                                       "lr")], jnp.float32)
    want = ref_pass(*(jnp.asarray(a) for a in (p, m, v, g)), meta=rmeta,
                    scalars=scal, use_nvlamb=False, wd_is_zero=False,
                    out_dtype=jnp.float32, sr_seed=None, interpret=True,
                    stash_p=stash_p, with_grad_norm=with_grad_norm)
    ts = [_t(a) for a in (p, m, v, g)]
    found, gg = _small_segment_pass(
        *ts, ts[:3], meta=meta,
        scalars=[s[k] for k in ("b1", "b2", "beta3", "eps", "wd", "bc1",
                                "bc2", "mode")],
        inv_scale=s["inv_scale"], lr=s["lr"], use_nvlamb=False,
        wd_is_zero=False, stash_p=stash_p, with_grad_norm=with_grad_norm)
    assert float(found) == float(want[3]) == float(inject)
    small = np.zeros(p.shape[0], bool)
    for seg in meta.small_segments:
        small[seg * SEG:(seg + 1) * SEG] = True
    for i in (1, 2):                  # m', v' (the rest flows through)
        np.testing.assert_array_equal(_bits(ts[i].numpy()),
                                      _bits(want[i]))
    if not inject:
        _assert_p_close(ts[0].numpy()[small], np.asarray(want[0])[small],
                        p[small])
    np.testing.assert_array_equal(ts[0].numpy()[~small], p[~small])
    if with_grad_norm:
        wgg = np.asarray(want[4])
        ok = np.isfinite(wgg)
        np.testing.assert_allclose(gg.numpy()[ok], wgg[ok], rtol=NORM_RTOL)
        assert np.isfinite(gg.numpy()).sum() == gg.numel() - int(inject)
    else:
        assert gg is None


@pytest.mark.parametrize("ref_impl", ["xla", "interpret"])
@pytest.mark.parametrize("flags", [dict(), dict(with_grad_norm=True),
                                   dict(max_grad_norm=1.0,
                                        global_grad_norm=2.5),
                                   dict(weight_decay=0.0),
                                   dict(stash_p=False, grad_scale=4.0)],
                         ids=["default", "grad_norm", "clip", "wd0",
                              "no_stash"])
def test_segmented_update_matches_reference(ref_impl, flags):
    """The port's one-pass schedule against the reference's two-stage
    path on the same segmented layout (``xla``) and against its one-pass
    kernel (``interpret``)."""
    rspace, rmeta, space, meta, p, m, v, g = _segment_case(13)
    kw = _lamb_kw(dict(beta1=0.875, **flags))
    want = ref_seg_update(*(jnp.asarray(a) for a in (p, m, v, g)), rspace,
                          rmeta, impl=ref_impl, **kw)
    ts = [_t(a) for a in (p, m, v, g)]
    got = fused_lamb_segmented_update(*ts, space, meta, **kw)
    assert got[0] is ts[0]
    np.testing.assert_array_equal(_bits(got[1].numpy()), _bits(want[1]))
    np.testing.assert_array_equal(_bits(got[2].numpy()), _bits(want[2]))
    _assert_p_close(got[0].numpy(), np.asarray(want[0]), p)
    assert float(got[3]) == float(want[3]) == 0.0
    if kw.get("with_grad_norm"):
        np.testing.assert_allclose(got[4].numpy(), np.asarray(want[4]),
                                   rtol=NORM_RTOL)


def test_segmented_out_of_place_writes_every_element():
    """Out of place, the new buffers are written everywhere (small
    segments, large leaves and their padding) and equal the in-place
    result; the inputs are left as they were."""
    _, _, space, meta, p, m, v, g = _segment_case(14)
    ts = [_t(a) for a in (p, m, v, g)]
    got = fused_lamb_segmented_update(*ts, space, meta, lr=1e-3,
                                      in_place=False)
    for t, a in zip(ts, (p, m, v, g)):
        np.testing.assert_array_equal(t.numpy(), a)
    fused_lamb_segmented_update(*ts, space, meta, lr=1e-3)
    for a, b in zip(got[:3], ts[:3]):
        assert torch.equal(a, b)


# -- FusedLAMB and the train step ------------------------------------------


def _small_last(tree, seg=SEG):
    """``tree`` re-keyed so that its sorted keys list the leaves larger
    than a ``seg``-element segment first, then the others, each group in
    name order: the order FusedLAMB lays its segmented master out in.
    The reference (sorted keys) then builds the same layout."""
    big = [k for k in tree if -(-tree[k].size // 2048) * 2048 > seg]
    order = big + [k for k in tree if k not in big]
    return {f"k{i:02d}_{k}": tree[k] for i, k in enumerate(order)}


@pytest.mark.parametrize("segmented", [True, False])
def test_fused_lamb_step_flat_with_skip_matches_reference(segmented):
    """Several ``step_flat`` calls with skips; the internal clip from
    each side's own norm, so m and v within relative 1e-6."""
    tree = _small_last(_tree(15))
    kw = dict(lr=1e-2, weight_decay=0.01, segmented=segmented,
              seg_elems=SEG)
    ref_opt, opt = RefLAMB(impl="xla", **kw), FusedLAMB(**kw)
    rs = ref_opt.init({k: jnp.asarray(a) for k, a in tree.items()})
    ps = opt.init({k: _t(a) for k, a in tree.items()})
    assert ps.space.offsets == rs.space.offsets
    assert (ps.seg_meta is None) == (rs.seg_meta is None) == (not segmented)
    for i in range(5):
        # gradients packed from the leaves: zero in the padding, as a
        # backward pass into the bound views leaves it
        g = np.array(rs.space.pack({k: jnp.asarray(v) for k, v in
                                    _small_last(_tree(16 + i)).items()}))
        if i in (1, 3):
            g[11 * i] = np.inf if i == 1 else np.nan
        before = [ps.master.clone(), ps.slots["m"].clone()]
        _, rs = ref_opt.step_flat(rs, jnp.asarray(g), skip_if_nonfinite=True)
        _, ps = opt.step_flat(ps, _t(g), skip_if_nonfinite=True)
        assert float(ps.found_inf) == float(rs.found_inf) == float(i in (1, 3))
        assert ps.count == int(rs.count)
        if i in (1, 3):
            assert torch.equal(ps.master, before[0])
            assert torch.equal(ps.slots["m"], before[1])
        for name in ("m", "v"):
            want = np.asarray(rs.slots[name])
            assert np.abs(ps.slots[name].numpy() - want).max() <= \
                1e-6 * np.abs(want).max()
        _assert_p_close(ps.master.numpy(), np.asarray(rs.master),
                        before[0].numpy(), floor=1e-6)
        for name in ("master", "m", "v"):       # the same start next step
            buf = ps.master if name == "master" else ps.slots[name]
            src = rs.master if name == "master" else rs.slots[name]
            buf.copy_(_t(np.asarray(src)))
    assert ps.count == 3


def _train_case(seed):
    tree = _tree(seed)
    rng = np.random.RandomState(seed + 1)
    return tree, [(4 * rng.randn(sum(
        -(-int(np.prod(s)) // 2048) * 2048 for s in _shapes().values()))
        ).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("case", ["adam_clip", "lamb_clip", "lamb_scaler",
                                  "adam_scaler_clip"])
def test_train_step_clip_and_grad_norm_match_reference(case):
    """``make_train_step`` with the generic clip (FusedAdam), the
    internal clip (FusedLAMB), a scaler and ``with_grad_norm``:
    ``aux.grad_norm`` and ``grad_norm_per_tensor`` within 1e-5, the
    found flag and the scale exact, the state within the stated bounds."""
    tree, grads = _train_case(17)
    lamb = case.startswith("lamb")
    scaler = case.endswith("scaler") or case == "adam_scaler_clip"
    if lamb:
        kw = dict(lr=1e-2, weight_decay=0.01, segmented=False)
        ref_opt, opt = RefLAMB(impl="xla", **kw), FusedLAMB(**kw)
        mkw = dict(with_grad_norm=True)
    else:
        ref_opt, opt = RefAdam(lr=1e-2, impl="xla"), FusedAdam(lr=1e-2)
        mkw = dict(max_grad_norm=1.0, with_grad_norm=True)
    if scaler:
        rstep = ref_make_train_step(ref_opt, scaler=RefScaler(
            init_scale=2.0 ** 4), **mkw)
        step = make_train_step(opt, scaler=LossScaler(init_scale=2.0 ** 4),
                               **mkw)
    else:
        rstep, step = ref_make_train_step(ref_opt, **mkw), \
            make_train_step(opt, **mkw)
    rs = ref_opt.init({k: jnp.asarray(a) for k, a in tree.items()})
    ps = opt.init({k: _t(a) for k, a in tree.items()})
    rss = rstep.scaler.init() if scaler else None
    pss = step.scaler.init() if scaler else None
    for i, g in enumerate(grads):
        if scaler and i == 1:
            g = g.copy()
            g[13] = np.inf
        before = ps.master.numpy().copy()
        if scaler:
            rs, rss, raux = rstep(rs, jnp.asarray(g), rss)
            ps, pss, aux = step(ps, _t(g), pss)
            assert pss.loss_scale == float(rss.loss_scale)
        else:
            rs, raux = rstep(rs, jnp.asarray(g))
            ps, aux = step(ps, _t(g))
        assert float(aux.found_inf) == float(raux.found_inf)
        assert ps.count == int(rs.count)
        if float(aux.found_inf) == 0.0:
            np.testing.assert_allclose(float(aux.grad_norm),
                                       float(raux.grad_norm), rtol=NORM_RTOL)
        assert (aux.grad_norm_per_tensor is None) == \
            (raux.grad_norm_per_tensor is None) == (not lamb)
        if lamb and float(aux.found_inf) == 0.0:
            np.testing.assert_allclose(aux.grad_norm_per_tensor.numpy(),
                                       np.asarray(raux.grad_norm_per_tensor),
                                       rtol=NORM_RTOL)
        _assert_p_close(ps.master.numpy(), np.asarray(rs.master), before,
                        floor=1e-6)
        ps.master.copy_(_t(np.asarray(rs.master)))
        for name in ("m", "v"):
            ps.slots[name].copy_(_t(np.asarray(rs.slots[name])))


def test_train_step_clip_conflict_and_unported_options_raise():
    opt = FusedLAMB(lr=1e-3, max_grad_norm=1.0)
    with pytest.raises(ValueError, match="conflicts"):
        make_train_step(opt, max_grad_norm=2.0)
    make_train_step(opt, max_grad_norm=1.0)           # the same clip: fine
    with pytest.raises(NotImplementedError, match="fingerprint"):
        make_train_step(opt, fingerprint_every=2)
    with pytest.raises(NotImplementedError, match="chained"):
        make_train_step(opt).chained(2)
    with pytest.raises(ValueError, match="requires master_dtype=bfloat16"):
        FusedLAMB(lr=1e-3, stochastic_rounding=True)
    with pytest.raises(ValueError, match="seg_u_dtype"):
        FusedLAMB(lr=1e-3, seg_u_dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        FusedMixedPrecisionLamb(
            lr=1e-3, reduced_precision_dtype=torch.bfloat16).init(
            {"a": torch.zeros(8, dtype=torch.float16)})
    with pytest.raises(ValueError, match="multiple of the kernel chunk"):
        FusedLAMB(seg_elems=1000).init({"a": torch.zeros(8)})


def test_segment_config_matches_reference():
    """The reference's segment size and stash choice for the same leaves
    and budget (the budget counts bytes of stash), wherever the
    reference's choice sweeps no more than the port's: the port counts
    the elements each candidate's layout sweeps, padding included. At
    1.5 MB the reference's two 196,608-element segments with the stash
    (7 x 393,216 accesses) lose to one 327,680-element segment without
    it (8 x 327,680)."""
    tree = _tree(18)
    port_only = {3 << 19: (327680, False)}
    for budget in (1 << 20, 8 << 20, 3 << 19):
        ref = RefLAMB(impl="xla", seg_vmem_budget=budget)
        port = FusedLAMB(seg_vmem_budget=budget)
        rseg, rstash, _ = ref._segment_config(
            {k: jnp.asarray(v) for k, v in tree.items()})
        assert port._segment_config({k: _t(v) for k, v in tree.items()}) \
            == (*port_only.get(budget, (rseg, rstash)), torch.float32)


def _swept_accesses(params, seg, stash):
    """Memory accesses of one LAMB step over FusedLAMB's layout at
    ``seg``: 7 (8 without the stash) an element of the small segments,
    10 of the large leaves' segments, and the layout's total."""
    space, meta = FusedLAMB(seg_elems=seg).layout(params)
    small = len(meta.small_segments) * seg
    return (7 if stash else 8) * small + 10 * (space.total - small), \
        space.total


def test_segment_config_counts_padding():
    """On GPT-like leaves (hidden 256, two layers; a 1 MB budget) the
    reference's rule covers every leaf with 262,144-element segments
    without the stash, where the embedding and the attention matrices
    round up to whole segments (3.1 M elements swept for 1.9 M); the
    port's choice, 65,536 with the stash, sweeps fewer elements and
    makes fewer accesses."""
    h = 256
    layer = [(h,), (h,), (3 * h, h), (3 * h,), (h, h), (h,), (h,), (h,),
             (4 * h, h), (4 * h,), (h, 4 * h), (h,)]
    shapes = [(1000, h), (128, h)] + layer * 2 + [(h,), (h,)]
    tree = {f"{i:03d}": np.zeros(s, np.float32) for i, s in enumerate(shapes)}
    budget = 1 << 20
    rseg, rstash, _ = RefLAMB(impl="xla", seg_vmem_budget=budget) \
        ._segment_config({k: jnp.asarray(v) for k, v in tree.items()})
    params = {k: torch.empty(v.shape, device="meta") for k, v in tree.items()}
    seg, stash, u_dt = FusedLAMB(seg_vmem_budget=budget)._segment_config(
        params)
    assert (rseg, rstash) == (262144, False) and (seg, stash) == (65536, True)
    assert u_dt == torch.float32
    got, got_total = _swept_accesses(params, seg, stash)
    want, want_total = _swept_accesses(params, rseg, rstash)
    assert got < want and got_total < want_total


def test_fused_lamb_layout_puts_small_leaves_together():
    """FusedLAMB lays the leaves that fit a segment out after the larger
    ones. In module order (a bias after each matrix) ``segmented_space``
    gives every run of small leaves a segment of its own; grouped, they
    share one. The layout is ``segmented_space``'s (the reference's) for
    the grouped order, and the master holds every parameter by name."""
    rng = np.random.RandomState(19)
    shapes = [(300, 300), (300,), (300,), (250, 400), (400,), (70000,),
              (12,)]
    params = {f"m{i}": _t(rng.randn(*s)) for i, s in enumerate(shapes)}
    state = FusedLAMB(seg_elems=SEG).init(params)
    meta = state.seg_meta
    given_space, given = segmented_space(params, seg_elems=SEG)
    assert len(meta.small_segments) == 1 < len(given.small_segments) == 3
    assert state.space.total < given_space.total
    big = ["m0", "m3", "m5"]
    space, want = segmented_space(
        {k: params[k] for k in big + [k for k in params if k not in big]},
        seg_elems=SEG)
    assert state.space.names == space.names
    assert state.space.offsets == space.offsets
    assert meta.large == want.large
    np.testing.assert_array_equal(meta.slot_ids, want.slot_ids)
    for name, leaf in state.space.unpack(state.master).items():
        assert torch.equal(leaf, params[name])


@pytest.mark.parametrize("stash", [True, False])
def test_fused_lamb_segmented_matches_two_stage_by_name(stash):
    """Three steps of FusedLAMB over its segmented master and over the
    plain one, no clip: per parameter name m' and v' bitwise (the same
    element-wise math), p' within the ratio bound (norms summed in
    another order); each step starts both from the plain side's p."""
    rng = np.random.RandomState(20)
    shapes = [(300, 300), (300,), (250, 400), (400,), (70000,), (12,)]
    params = {f"m{i}": _t(rng.randn(*s)) for i, s in enumerate(shapes)}
    kw = dict(lr=1e-2, weight_decay=0.01, max_grad_norm=0.0)
    seg_opt = FusedLAMB(seg_elems=SEG, seg_stash_p=stash, **kw)
    plain_opt = FusedLAMB(segmented=False, **kw)
    ss, ps = seg_opt.init(params), plain_opt.init(params)
    for i in range(3):
        grads = {k: _t(rng.randn(*t.shape)) for k, t in params.items()}
        before = ps.space.unpack(ps.master.clone())
        _, ss = seg_opt.step(ss, grads)
        _, ps = plain_opt.step(ps, grads)
        for name in ("m", "v"):
            a = ss.space.unpack(ss.slots[name])
            b = ps.space.unpack(ps.slots[name])
            for k in params:
                np.testing.assert_array_equal(_bits(a[k].numpy()),
                                              _bits(b[k].numpy()))
        a, b = ss.space.unpack(ss.master), ps.space.unpack(ps.master)
        for k in params:
            _assert_p_close(a[k].numpy(), b[k].numpy(), before[k].numpy())
        ss.space.pack_into(ss.master, b)


def test_default_segment_fits_one_cluster():
    from apex_tpu_torch.multi_tensor.flat_buffer import (
        BLOCK_SMEM_BYTES, segment_smem_bytes)
    big = {"w": torch.empty(8_000_000, device="meta"),
           "b": torch.empty(1024, device="meta")}
    seg, stash, u_dt = FusedLAMB()._segment_config(big)
    assert seg % SEG == 0 and stash and u_dt == torch.float32
    assert segment_smem_bytes(seg, 512, stash) <= BLOCK_SMEM_BYTES
