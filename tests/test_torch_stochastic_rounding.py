"""Stochastic rounding (SR) and the master-free bf16 optimizers of
apex_tpu_torch against apex_tpu.

The same numpy inputs (bf16 crossing as uint16 bits) go through the
reference (``impl="xla"``, ``"interpret"`` where it has a kernel) and the
port's plain path, which CPU tensors take (the CUDA kernels are held
against the same plain path on the card by
``tests/test_torch_kernels_cuda.py``).

Tolerances. ``stochastic_round_cast`` and the key words: bitwise. An SR
output is bitwise wherever the two implementations' fp32 values before
rounding are bitwise; where they are not (XLA's CPU compiler contracting
a multiply-add of the reference's Adagrad, NovoGrad or Adam; LAMB's and
LARS's ratios from sums in another order), the two fp32 values are a
few fp32 ulps apart and the bf16 results may differ by exactly one bf16
ulp, when the carry into bit 16 changes. The tests allow a difference
only at elements whose fp32 values differ (each side's functor run
without SR on the same inputs), and there one bf16 ulp. m', v', h'
and momentum: bitwise where the reference's are (as the fp32 tests).
"""

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from apex_tpu.multi_tensor import FlatSpace as RefSpace
from apex_tpu.multi_tensor import ops as rops
from apex_tpu.multi_tensor.engine import stochastic_round_cast as ref_src
from apex_tpu.multi_tensor.flat_buffer import segmented_space as ref_segspace
from apex_tpu.multi_tensor.segmented import _small_segment_pass as ref_pass
from apex_tpu.multi_tensor.segmented import (
    fused_lamb_segmented_update as ref_seg_update,
)
from apex_tpu.optimizers import FusedMixedPrecisionLamb as RefMPLamb
from apex_tpu.optimizers import FusedSGD as RefSGD

from apex_tpu_torch import random as jr
from apex_tpu_torch.multi_tensor import (
    FlatSpace,
    fused_adagrad_update,
    fused_adam_update,
    fused_lamb_segmented_update,
    fused_lamb_update,
    fused_lars_update,
    fused_novograd_update,
    fused_sgd_update,
    segmented_space,
)
from apex_tpu_torch.multi_tensor.engine import (
    sr_key_words,
    stochastic_round_cast,
)
from apex_tpu_torch.multi_tensor.segmented import _small_segment_pass
from apex_tpu_torch.optimizers import (
    FusedAdagrad,
    FusedAdam,
    FusedLAMB,
    FusedLARS,
    FusedMixedPrecisionLamb,
    FusedNovoGrad,
    FusedSGD,
)

N = 3 * 2048 + 517
SEG = 65536
OPTIMIZERS = [FusedAdam, FusedLAMB, FusedSGD, FusedNovoGrad, FusedAdagrad,
              FusedLARS]


def _bf16_bits(x32: np.ndarray) -> np.ndarray:
    """fp32 values rounded to bf16 (nearest), as uint16 bits."""
    return torch.from_numpy(np.ascontiguousarray(x32, np.float32)) \
        .bfloat16().view(torch.int16).numpy().view(np.uint16)


def _jbf(bits: np.ndarray) -> jax.Array:
    return jnp.asarray(bits.view(ml_dtypes.bfloat16))


def _tbf(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)


def _u16(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32, copy=True))


def _assert_sr_close(got, want, got32, want32, what="p'"):
    """``got``/``want`` bf16 results (uint16 bits) of SR over values whose
    fp32 versions before rounding are ``got32``/``want32``: bitwise where
    those agree; elsewhere at most one bf16 ulp."""
    diff = got != want
    pre = got32 != want32
    assert not (diff & ~pre).any(), (what, int((diff & ~pre).sum()))
    step = np.abs(got[diff].astype(np.int32) - want[diff].astype(np.int32))
    assert (step == 1).all(), (what, step.max())


def _buffers(seed=0, n=N):
    rng = np.random.RandomState(seed)
    p, m, g = (rng.randn(n).astype(np.float32) for _ in range(3))
    v = np.abs(rng.randn(n)).astype(np.float32)
    return _bf16_bits(p), m, v, g


# -- the generator and the cast ---------------------------------------------


@pytest.mark.parametrize("seed", [0, 5, -3, 2 ** 31 - 1])
def test_prng_keys_match_reference(seed):
    """``PRNGKey(seed)`` and ``fold_in(key, j)`` on the host give the
    reference's words for an int32 seed read as uint32 (engine.py:62-63)."""
    k = jax.random.PRNGKey(jnp.asarray(seed, jnp.int32).astype(jnp.uint32))
    for salt in (0, 1, 7):
        want = np.asarray(jax.random.key_data(jax.random.fold_in(k, salt)))
        assert sr_key_words(seed, salt) == tuple(int(w) for w in want)
        assert jr.fold_in(jr.PRNGKey(seed & 0xFFFFFFFF), salt).tolist() \
            == [int(w) for w in want]


@pytest.mark.parametrize("seed", [0, 3, 2 ** 31 - 1])
@pytest.mark.parametrize("salt", [0, 2])
def test_stochastic_round_cast_matches_reference(seed, salt):
    rng = np.random.RandomState(seed % 1000)
    x = (rng.randn(5000) * np.exp(rng.randn(5000) * 4)).astype(np.float32)
    x[:8] = [np.inf, -np.inf, np.nan, 0.0, -0.0, 3.4e38, -1.17e-38, 1e-45]
    want = _u16(ref_src(jnp.asarray(x), jnp.int32(seed), salt))
    got = _u16(stochastic_round_cast(torch.from_numpy(x), seed, salt))
    nan = np.isnan(x)
    np.testing.assert_array_equal(got[~nan], want[~nan])
    assert np.isnan(_f32(stochastic_round_cast(torch.from_numpy(x), seed,
                                               salt))[nan]).all()


def test_plain_sqrt_is_correctly_rounded():
    """The plain paths' square root (``engine.sqrt_rn``) is IEEE's, as
    numpy's, XLA's and the kernels' ``__fsqrt_rn`` are, on a tensor large
    enough to be split across threads, zeros, subnormals and inf
    included."""
    from apex_tpu_torch.multi_tensor.engine import sqrt_rn
    rng = np.random.RandomState(3)
    x = np.abs(rng.randn(1 << 20) * np.exp(rng.randn(1 << 20) * 8))
    x = x.astype(np.float32)
    x[:5] = [0.0, 1e-45, 1.17e-38, 3.4e38, np.inf]
    want = np.sqrt(x).view(np.uint32)
    for _ in range(2):           # the first call in a process and a later
        got = sqrt_rn(torch.from_numpy(x)).numpy().view(np.uint32)
        np.testing.assert_array_equal(got, want)


def test_stochastic_rounding_is_unbiased_and_replays():
    """1 + 2^-10 is 1/8 of a bf16 ulp above 1: an eighth of the copies
    round up; the same seed gives the same bits."""
    x = torch.full((1 << 16,), 1.0 + 2.0 ** -10)
    y = stochastic_round_cast(x, 11)
    up = float((y.float() > 1.0).float().mean())
    assert abs(up - 0.125) < 0.01, up
    assert set(y.float().unique().tolist()) == {1.0, 1.0078125}
    assert torch.equal(y.view(torch.int16),
                       stochastic_round_cast(x, 11).view(torch.int16))
    assert not torch.equal(y.view(torch.int16),
                           stochastic_round_cast(x, 12).view(torch.int16))


# -- each functor's SR output ----------------------------------------------


def _functor_case(ref_fn, port_fn, bufs, kw, impl, rargs=(), pargs=()):
    """Run a flat update with a bf16 p and SR (seed 9), and without SR on
    the fp32 upcast of p, on both sides; return ``(got, want)`` of the SR
    runs and the two fp32 p' of the others."""
    pb, *rest = bufs
    want = ref_fn(_jbf(pb), *(jnp.asarray(a) for a in rest), *rargs,
                  impl=impl, sr_seed=jnp.int32(9), **kw)
    got = port_fn(_tbf(pb), *(_t(a) for a in rest), *pargs, sr_seed=9,
                  in_place=False, **kw)
    p32 = pb.astype(np.uint32) << 16
    p32 = p32.view(np.float32)
    want32 = ref_fn(jnp.asarray(p32), *(jnp.asarray(a) for a in rest),
                    *rargs, impl=impl, **kw)
    got32 = port_fn(_t(p32), *(_t(a) for a in rest), *pargs,
                    in_place=False, **kw)
    assert got[0].dtype == torch.bfloat16
    _assert_sr_close(_u16(got[0]), _u16(want[0]), _f32(got32[0]),
                     _f32(want32[0]))
    return got, want


@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_adam_sr_matches_reference(impl, adam_w_mode):
    pb, m, v, g = _buffers(1)
    kw = dict(lr=2e-3, weight_decay=0.01, step=3, adam_w_mode=adam_w_mode,
              grad_scale=4.0)
    got, want = _functor_case(rops.fused_adam_update, fused_adam_update,
                              (pb, m, v, g), kw, impl)
    for i in (1, 2):
        np.testing.assert_array_equal(_f32(got[i]), _f32(want[i]))
    assert float(got[3]) == float(want[3]) == 0.0


def test_adagrad_sr_matches_reference(impl):
    pb, h, _, g = _buffers(2)
    h = np.abs(h)
    kw = dict(lr=1e-2, weight_decay=0.01, grad_scale=2.0)
    got, want = _functor_case(rops.fused_adagrad_update,
                              fused_adagrad_update, (pb, h, g), kw, impl)
    np.testing.assert_array_equal(_f32(got[1]), _f32(want[1]))


@pytest.mark.parametrize("case", [dict(momentum=0.9),
                                  dict(momentum=0.9, nesterov=True),
                                  dict(momentum=0.9, dampening=0.1,
                                       wd_after_momentum=True),
                                  dict()],
                         ids=["momentum", "nesterov", "wd_after", "plain"])
def test_sgd_sr_matches_reference(impl, case):
    pb, mom, _, g = _buffers(3)
    kw = dict(lr=0.05, weight_decay=1e-4, scale=0.5, **case)
    got, want = _functor_case(rops.fused_sgd_update, fused_sgd_update,
                              (pb, mom, g), kw, impl)
    np.testing.assert_array_equal(_f32(got[1]), _f32(want[1]))


def _tree(seed=0, scale=1.0):
    rng = np.random.RandomState(seed)
    sizes = [(3000,), (10,), (70000,), (40, 700), (5,), (130000,), (2048,),
             (61000,), (7,), (9000,)]
    return {f"l{i:02d}": (scale * rng.randn(*s)).astype(np.float32)
            for i, s in enumerate(sizes)}


def _spaces(tree, segmented=False):
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    if segmented:
        rspace, rmeta = ref_segspace(jtree, seg_elems=SEG)
        space, meta = segmented_space({k: _t(v) for k, v in tree.items()},
                                      seg_elems=SEG)
    else:
        rspace, rmeta = RefSpace.create(jtree), None
        space, meta = FlatSpace.create({k: _t(v) for k, v in tree.items()}), \
            None
    assert space.offsets == rspace.offsets
    return rspace, rmeta, space, meta


def _flat(rspace, tree, seed, scale, positive=False):
    rng = np.random.RandomState(seed)
    leaves = {k: rng.randn(*v.shape) * scale for k, v in tree.items()}
    if positive:
        leaves = {k: np.abs(v) for k, v in leaves.items()}
    return np.array(rspace.pack({k: jnp.asarray(v, jnp.float32)
                                 for k, v in leaves.items()}))


def _space_buffers(seed, segmented=False):
    tree = _tree(seed)
    rspace, rmeta, space, meta = _spaces(tree, segmented)
    pb = _bf16_bits(np.array(rspace.pack({k: jnp.asarray(v)
                                          for k, v in tree.items()})))
    m = _flat(rspace, tree, seed + 1, 0.01)
    v = _flat(rspace, tree, seed + 2, 1e-4, positive=True)
    g = _flat(rspace, tree, seed + 3, 0.5)
    return rspace, rmeta, space, meta, pb, m, v, g


def test_novograd_sr_matches_reference(impl):
    rspace, _, space, _, pb, m, _, g = _space_buffers(4)
    v = np.abs(np.random.RandomState(5).randn(space.num_leaves)) \
        .astype(np.float32)
    kw = dict(lr=0.01, step=2, weight_decay=1e-3)
    got, want = _functor_case(rops.fused_novograd_update,
                              fused_novograd_update, (pb, m, v, g), kw, impl,
                              rargs=(rspace,), pargs=(space,))
    # v' a sum of squares in another order; m' within that share of its
    # terms plus one rounding (tests/test_torch_novograd_adagrad.py)
    np.testing.assert_allclose(_f32(got[2]), _f32(want[2]), rtol=1e-6)
    gm, wm = _f32(got[1]), _f32(want[1])
    p32 = (pb.astype(np.uint32) << 16).view(np.float32)
    bound = 1e-6 * (np.abs(0.95 * m) + np.abs(gm) + np.abs(1e-3 * p32)) \
        + np.spacing(np.abs(gm))
    assert (np.abs(gm - wm) <= bound).all()


@pytest.mark.parametrize("first_run", [True, False])
def test_lars_sr_matches_reference(impl, first_run):
    rspace, _, space, _, pb, mom, _, g = _space_buffers(6)
    kw = dict(lr=0.1, momentum=0.9, weight_decay=1e-4, first_run=first_run)
    got, want = _functor_case(rops.fused_lars_update, fused_lars_update,
                              (pb, mom, g), kw, impl, rargs=(rspace,),
                              pargs=(space,))
    np.testing.assert_allclose(_f32(got[1]), _f32(want[1]), rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("flags", [dict(), dict(use_nvlamb=True,
                                                weight_decay=0.0),
                                   dict(max_grad_norm=1.0,
                                        global_grad_norm=3.5)],
                         ids=["default", "nvlamb", "clip"])
def test_lamb_sr_matches_reference(impl, flags):
    """Both stages over the plain layout: stage 1 reads the bf16 p, stage
    2 writes p' with SR over the whole buffer."""
    rspace, _, space, _, pb, m, v, g = _space_buffers(7)
    kw = dict(lr=2e-3, weight_decay=0.01, step=3)
    kw.update(flags)
    got, want = _functor_case(rops.fused_lamb_update, fused_lamb_update,
                              (pb, m, v, g), kw, impl, rargs=(rspace,),
                              pargs=(space,))
    for i in (1, 2):
        np.testing.assert_array_equal(_f32(got[i]), _f32(want[i]))


# -- the segment pass and the segmented update ------------------------------


SEG_SCALARS = dict(b1=0.9, b2=0.999, beta3=0.1, eps=1e-6, wd=0.01, bc1=0.19,
                   bc2=0.002997, mode=1.0, inv_scale=2.0, lr=2e-3)
_SEG_NAMES = ("b1", "b2", "beta3", "eps", "wd", "bc1", "bc2", "mode")


def _port_pass(p, m, v, g, meta, **kw):
    ts = [p, *(_t(a) for a in (m, v, g))]
    s = SEG_SCALARS
    found, _ = _small_segment_pass(
        *ts, ts[:3], meta=meta, scalars=[s[k] for k in _SEG_NAMES],
        inv_scale=s["inv_scale"], lr=s["lr"], use_nvlamb=False,
        wd_is_zero=False, **kw)
    return ts, found


def _ref_pass(p, m, v, g, meta, out_dtype, **kw):
    s = SEG_SCALARS
    scal = jnp.asarray([s[k] for k in (*_SEG_NAMES, "inv_scale", "lr")],
                       jnp.float32)
    return ref_pass(p, *(jnp.asarray(a) for a in (m, v, g)), meta=meta,
                    scalars=scal, use_nvlamb=False, wd_is_zero=False,
                    out_dtype=out_dtype, interpret=True, **kw)


@pytest.mark.parametrize("stash_p", [True, False])
@pytest.mark.parametrize("u_dtype", ["float32", "bfloat16"])
def test_segment_pass_sr_matches_reference_kernel(stash_p, u_dtype):
    """The plain segment pass with SR (murmur3 over the global index) and
    the u stash against the reference's kernel in interpret mode: m', v'
    bitwise, p' bitwise or one bf16 ulp where the trust ratio's sums
    (in another order) move the fp32 value."""
    _, rmeta, _, meta, pb, m, v, g = _space_buffers(8, segmented=True)
    tu, ju = getattr(torch, u_dtype), getattr(jnp, u_dtype)
    want = _ref_pass(_jbf(pb), m, v, g, rmeta, jnp.bfloat16,
                     sr_seed=jnp.int32(21), stash_p=stash_p, u_dtype=ju)
    ts, found = _port_pass(_tbf(pb), m, v, g, meta, sr_seed=21,
                           stash_p=stash_p, u_dtype=tu)
    p32 = (pb.astype(np.uint32) << 16).view(np.float32)
    want32 = _ref_pass(jnp.asarray(p32), m, v, g, rmeta, jnp.float32,
                       sr_seed=None, stash_p=stash_p, u_dtype=ju)
    ts32, _ = _port_pass(_t(p32), m, v, g, meta, stash_p=stash_p,
                         u_dtype=tu)
    assert float(found) == float(want[3]) == 0.0
    for i in (1, 2):
        np.testing.assert_array_equal(ts[i].numpy(), np.asarray(want[i]))
    _assert_sr_close(_u16(ts[0]), _u16(want[0]), ts32[0].numpy(),
                     np.asarray(want32[0]))
    small = np.zeros(pb.shape[0], bool)
    for seg in meta.small_segments:
        small[seg * SEG:(seg + 1) * SEG] = True
    np.testing.assert_array_equal(_u16(ts[0])[~small], pb[~small])


def test_segmented_update_sr_with_large_leaves_matches_reference():
    """The whole segmented update with SR on a layout both sides share:
    the segment pass's murmur3 stream, and each large leaf's threefry
    stream keyed by its leaf index and indexed within its slice."""
    rspace, rmeta, space, meta, pb, m, v, g = _space_buffers(9,
                                                             segmented=True)
    assert meta.large and meta.small_segments
    kw = dict(lr=2e-3, weight_decay=0.01, step=4, beta1=0.875)
    want = ref_seg_update(_jbf(pb), *(jnp.asarray(a) for a in (m, v, g)),
                          rspace, rmeta, impl="interpret",
                          sr_seed=jnp.int32(33), **kw)
    got = fused_lamb_segmented_update(_tbf(pb), *(_t(a) for a in (m, v, g)),
                                      space, meta, sr_seed=33, **kw)
    p32 = (pb.astype(np.uint32) << 16).view(np.float32)
    want32 = ref_seg_update(*(jnp.asarray(a) for a in (p32, m, v, g)),
                            rspace, rmeta, impl="interpret", **kw)
    got32 = fused_lamb_segmented_update(*(_t(a) for a in (p32, m, v, g)),
                                        space, meta, **kw)
    for i in (1, 2):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
    _assert_sr_close(_u16(got[0]), _u16(want[0]), got32[0].numpy(),
                     np.asarray(want32[0]))
    # the large leaves alone: their own streams, bitwise
    large = np.zeros(pb.shape[0], bool)
    for _, start, plen in meta.large:
        large[start:start + plen] = True
    np.testing.assert_array_equal(_u16(got[0])[large], _u16(want[0])[large])


def test_sr_needs_bf16_params():
    rspace, rmeta, space, meta, pb, m, v, g = _space_buffers(10,
                                                             segmented=True)
    p32 = (pb.astype(np.uint32) << 16).view(np.float32)
    with pytest.raises(ValueError, match="targets bfloat16"):
        fused_lamb_segmented_update(*(_t(a) for a in (p32, m, v, g)), space,
                                    meta, lr=1e-3, sr_seed=1)
    with pytest.raises(ValueError, match="targets bfloat16"):
        fused_adam_update(*(_t(a) for a in (p32, m, v, g)), lr=1e-3,
                          sr_seed=1)


def test_stage2_segment_streams_come_from_the_layout():
    """The large leaves' stream tables are fixed by the layout (one row a
    segment: its leaf's ordinal and first element); stage 2 over the
    segment list takes them with a seed, and only over a bf16 p."""
    from apex_tpu_torch.multi_tensor.ops import lamb_stage2_segments
    _, _, space, meta, pb, *_ = _space_buffers(9, segmented=True)
    segs, leaves, _ = meta.device_large("cpu")
    rows, sleaves = meta.device_large_streams("cpu")
    assert torch.equal(sleaves, leaves)
    want = [(k, start) for k, (_, start, plen) in enumerate(meta.large)
            for _ in range(plen // meta.seg_elems)]
    assert rows.tolist() == [list(r) for r in want]
    assert rows.shape[0] == segs.numel()
    assert meta.device_large_streams("cpu")[0] is rows     # made once
    p, u = _tbf(pb), torch.zeros(pb.shape[0])
    args = (torch.ones(space.num_leaves),
            space.device_subtile_leaf_ids("cpu"), segs, meta.seg_elems)
    for bad in (dict(p=p.float(), seg_streams=(rows, leaves), sr_seed=3),
                dict(p=p, seg_streams=(rows, leaves)),
                dict(p=p, sr_seed=3)):
        q = bad.pop("p")
        with pytest.raises(ValueError, match="stochastic rounding"):
            lamb_stage2_segments(q, u, q.clone(), *args, lr=1e-3, **bad)
    out = lamb_stage2_segments(p, u, p.clone(), *args, lr=1e-3,
                               seg_streams=(rows, leaves), sr_seed=3)
    # u = 0: p' is p, whatever bits the streams add below the mantissa
    assert torch.equal(out.view(torch.int16), p.view(torch.int16))


# -- the optimizers --------------------------------------------------------


@pytest.mark.parametrize("cls", OPTIMIZERS)
def test_master_dtype_policy_matches_reference(cls):
    """The reference's errors (optimizers/fused.py:64-96): SR needs a
    bf16 master, a bf16 master needs SR, and a bf16 master takes no
    wider leaf."""
    lr = dict(lr=0.1)
    with pytest.raises(ValueError, match="requires master_dtype=bfloat16"):
        cls(**lr, stochastic_rounding=True)
    with pytest.raises(ValueError, match="without stochastic rounding"):
        cls(**lr, master_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="requires master_dtype=bfloat16"):
        cls(**lr, master_dtype=torch.float16, stochastic_rounding=True)
    opt = cls(**lr, master_dtype=torch.bfloat16, stochastic_rounding=True)
    with pytest.raises(ValueError, match="float32"):
        opt.init({"w": torch.zeros(64, dtype=torch.bfloat16),
                  "ln": torch.zeros(8)})
    st = opt.init({"w": torch.ones(64, dtype=torch.bfloat16)})
    assert st.master.dtype == torch.bfloat16
    assert all(s.dtype == torch.float32 for s in st.slots.values())


def test_sr_seed_advances_with_count_and_resumes():
    """The reference's ``test_sr_seed_advances_with_count``: two steps use
    two streams, a skipped step advances nothing (the next step draws the
    stream the skipped one would have), and a state restored from
    ``state_dict`` replays a step bitwise. Step 1 against the
    reference's, bitwise."""
    opt = FusedSGD(lr=1.0, master_dtype=torch.bfloat16,
                   stochastic_rounding=True)
    params = {"w": torch.full((4096,), 1.0, dtype=torch.bfloat16)}
    g = {"w": torch.full((4096,), 2.0 ** -9)}
    s0 = opt.init(params)
    p1, s1 = opt.step(s0, g)
    ref = RefSGD(lr=1.0, master_dtype=jnp.bfloat16, stochastic_rounding=True,
                 impl="xla")
    rp1, _ = ref.step(ref.init({"w": jnp.full((4096,), 1.0, jnp.bfloat16)}),
                      {"w": jnp.full((4096,), 2.0 ** -9, jnp.float32)})
    np.testing.assert_array_equal(_u16(p1["w"]), _u16(rp1["w"]))
    a1 = p1["w"].float().clone()
    ckpt = {k: (v.clone() if isinstance(v, torch.Tensor) else
                {n: t.clone() for n, t in v.items()} if isinstance(v, dict)
                else v) for k, v in opt.state_dict(s1).items()}
    p2, s2 = opt.step(s1, g)
    d2 = p2["w"].float() - a1
    assert a1.unique().numel() > 1 and d2.unique().numel() > 1
    # a skipped step: nothing moves, count stays
    bad = {"w": torch.full((4096,), float("inf"))}
    before = s2.master.clone()
    _, s2b = opt.step(s2, bad, skip_if_nonfinite=True)
    assert s2b.count == s2.count == 2 and torch.equal(s2b.master, before)
    # replay step 2 from the checkpoint of step 1
    s1r = opt.load_state_dict(opt.init(params), ckpt)
    p2r, _ = opt.step(s1r, g)
    assert torch.equal(p2r["w"].view(torch.int16), before.view(torch.int16))


def test_fused_mixed_precision_lamb_matches_reference():
    """An fp32 master over fp32 and bf16 leaves; ``step`` returns each
    leaf in its own dtype (the bf16 one the master rounded to nearest).
    The master within test_torch_lamb.py's p tolerance of the
    reference's each step (the trust ratios' sums in another order),
    each step starting from the reference's master."""
    rng = np.random.RandomState(12)
    w32 = rng.randn(300, 7).astype(np.float32)
    wb = _bf16_bits(rng.randn(5000).astype(np.float32))
    kw = dict(lr=1e-2, weight_decay=0.01, segmented=False)
    ref = RefMPLamb(impl="xla", reduced_precision_dtype=jnp.bfloat16, **kw)
    opt = FusedMixedPrecisionLamb(reduced_precision_dtype=torch.bfloat16,
                                  **kw)
    rs = ref.init({"a": jnp.asarray(w32), "b": _jbf(wb)})
    ps = opt.init({"a": _t(w32), "b": _tbf(wb)})
    assert ps.master.dtype == torch.float32
    assert ps.space.offsets == rs.space.offsets
    for i in range(3):
        before = np.asarray(rs.master)
        ga = rng.randn(300, 7).astype(np.float32)
        gb = rng.randn(5000).astype(np.float32)
        rp, rs = ref.step(rs, {"a": jnp.asarray(ga), "b": jnp.asarray(gb)})
        pp, ps = opt.step(ps, {"a": _t(ga), "b": _t(gb)})
        assert pp["a"].dtype == torch.float32
        assert pp["b"].dtype == torch.bfloat16
        got, want = ps.master.numpy(), np.asarray(rs.master)
        step = np.abs(before - want)
        bound = (1e-5 * step + 2 * np.spacing(step)
                 + np.spacing(np.abs(want)).astype(np.float32))
        assert (np.abs(got - want) <= bound).all()
        views = ps.space.unpack(ps.master, "buffer")
        assert torch.equal(pp["a"], views["a"])
        assert torch.equal(pp["b"].view(torch.int16),
                           views["b"].bfloat16().view(torch.int16))
        assert ps.count == int(rs.count) == i + 1
        ps.master.copy_(_t(want))


def test_fused_lamb_bf16_u_stash_config():
    """``seg_u_dtype`` names the stash; ``seg_allow_bf16_u`` lets the
    configuration take bf16 where it covers more of the tree within the
    budget (the reference's candidate, counted at 2 bytes of u and 4 of
    p an element)."""
    params = {"w": torch.empty(600_000, device="meta"),
              "b": torch.empty(1024, device="meta")}
    budget = 2 << 20
    seg, stash, u_dt = FusedLAMB(seg_vmem_budget=budget)._segment_config(
        params)
    assert (seg, stash, u_dt) == (65536, True, torch.float32)
    seg2, _, u_dt2 = FusedLAMB(seg_vmem_budget=budget,
                               seg_allow_bf16_u=True)._segment_config(params)
    assert u_dt2 == torch.bfloat16 and seg2 > seg
    _, meta = FusedLAMB(seg_u_dtype=torch.bfloat16).layout(
        {"w": torch.zeros(5000)})
    assert meta.u_dtype_name == "bfloat16"
