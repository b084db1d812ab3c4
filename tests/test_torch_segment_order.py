"""The segment pass's per-slot sums in one documented order, the CUDA
kernel's (``csrc/lamb_segment.cu``), and the plain pass in that order
against the reference's segment kernel in interpret mode.

The plain version (``multi_tensor/segmented.py`` ``_slot_sums``) is held
bitwise to a numpy evaluation of the order written out here, block by
block and warp by warp; the kernel is held to the plain version on the
card (``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``). The plain
pass against the reference: the tolerances of ``tests/test_torch_lamb.py``
(m' and v' bitwise; p' within 1e-5 of each element's step plus two ulps
of the step and one of p'; the per-slot g^2 sums within 1e-5 relative:
fp32 sums in another order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from apex_tpu.multi_tensor.flat_buffer import segmented_space as ref_segspace
from apex_tpu.multi_tensor.segmented import _small_segment_pass as ref_pass

from apex_tpu_torch.multi_tensor import segmented_space
from apex_tpu_torch.multi_tensor.flat_buffer import (
    BLOCK_SMEM_BYTES,
    CHUNK,
    CLUSTER_BLOCKS,
    DEFAULT_SEG_SMEM_BUDGET,
    segment_smem_bytes,
)
from apex_tpu_torch.multi_tensor.segmented import (
    _slot_sums,
    _small_segment_pass,
)

SEG = 65536
SM_SMEM_BYTES = 233472          # an H100 SM's shared memory, 1 KB a block
SCALARS = dict(b1=0.9, b2=0.999, beta3=0.1, eps=1e-6, wd=0.01, bc1=0.19,
               bc2=0.002997, mode=1.0, inv_scale=2.0, lr=2e-3)


def _documented_slot_sums(x: np.ndarray, slot: np.ndarray,
                          max_slots: int) -> np.ndarray:
    """Per-slot sums of x^2 as the kernel takes them: a segment is 16
    blocks' slices; a block's slice is warp rounds of 512 elements, lane
    l holding elements 128 j + 4 l + k (j, k < 4); a lane adds its
    squares in (j, k) order from +0, a warp its lanes by the xor
    butterfly 16, 8, 4, 2, 1; a subtile (2048 elements) is ((w0 + w1) +
    w2) + w3 of its four warps; a block adds its subtiles into its slots
    in order from +0, the segment its blocks' slots in order from +0."""
    n_small, se = x.shape
    e = se // 16
    out = np.zeros((n_small, max_slots), np.float32)
    lanes_ix = np.arange(32)
    for s in range(n_small):
        total = np.zeros(max_slots, np.float32)
        for b in range(16):
            xb = x[s, b * e:(b + 1) * e].astype(np.float32)
            warps = []
            for c in range(e // 512):
                piece = xb[c * 512:(c + 1) * 512].reshape(4, 32, 4)
                lanes = np.zeros(32, np.float32)
                for j in range(4):
                    for k in range(4):
                        sq = (piece[j, :, k] * piece[j, :, k]).astype(
                            np.float32)
                        lanes = (lanes + sq).astype(np.float32)
                for off in (16, 8, 4, 2, 1):
                    lanes = (lanes + lanes[lanes_ix ^ off]).astype(np.float32)
                warps.append(lanes[0])
            acc = np.zeros(max_slots, np.float32)
            ids = slot[s, b * (e // 2048):(b + 1) * (e // 2048)]
            for t, sl in enumerate(ids):
                w = warps[4 * t:4 * t + 4]
                sub = np.float32(np.float32(np.float32(w[0] + w[1]) + w[2])
                                 + w[3])
                if sl >= 0:
                    acc[sl] = np.float32(acc[sl] + sub)
            total = (total + acc).astype(np.float32)
        out[s] = total
    return out


def _bits(a):
    return np.asarray(a).view(np.int32)


@pytest.mark.parametrize("seg_elems", [SEG, 2 * SEG])
def test_slot_sums_follow_the_documented_order(seg_elems):
    """Slots of one subtile, of several, across blocks, and padding (-1),
    over values spanning many binades."""
    rng = np.random.RandomState(seg_elems // SEG)
    n_small, sub = 3, seg_elems // 2048
    slot = np.full((n_small, sub), -1, np.int32)
    for s in range(n_small):
        t, sl = 0, 0
        while t < sub - 2:
            run = int(rng.randint(1, sub // 3))
            slot[s, t:t + run] = sl
            t += run
            sl += 1
    max_slots = int(slot.max()) + 1
    x = (rng.randn(n_small, seg_elems)
         * np.exp(rng.randn(n_small, seg_elems) * 3)).astype(np.float32)
    got = _slot_sums(torch.from_numpy(x), torch.from_numpy(slot), max_slots)
    want = _documented_slot_sums(x, slot, max_slots)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def _case(seg_elems, seed):
    shapes = [(3000,), (10,), (70000,), (40, 700), (5,), (130000,),
              (2048,), (61000,), (7,), (9000,)]
    rng = np.random.RandomState(seed)
    tree = {f"l{i:02d}": (rng.randn(*s) * 0.5).astype(np.float32)
            for i, s in enumerate(shapes)}
    rspace, rmeta = ref_segspace({k: jnp.asarray(v) for k, v in tree.items()},
                                 seg_elems=seg_elems)
    space, meta = segmented_space({k: torch.from_numpy(v)
                                   for k, v in tree.items()},
                                  seg_elems=seg_elems)
    n = space.total
    p = np.array(rspace.pack({k: jnp.asarray(v) for k, v in tree.items()}))
    m = (rng.randn(n) * 0.01).astype(np.float32)
    v = (np.abs(rng.randn(n)) * 1e-4).astype(np.float32)
    g = (rng.randn(n) * 0.5).astype(np.float32)
    return rmeta, meta, p, m, v, g


def test_plain_pass_grad_sums_are_the_documented_order():
    _, meta, p, m, v, g = _case(SEG, 3)
    s = SCALARS
    ts = [torch.from_numpy(a.copy()) for a in (p, m, v, g)]
    _, gg = _small_segment_pass(
        *ts, [t.clone() for t in ts[:3]], meta=meta,
        scalars=[s[k] for k in ("b1", "b2", "beta3", "eps", "wd", "bc1",
                                "bc2", "mode")],
        inv_scale=s["inv_scale"], lr=s["lr"], use_nvlamb=False,
        wd_is_zero=False, with_grad_norm=True)
    segs = np.asarray(meta.small_segments)
    want = _documented_slot_sums(g.reshape(-1, SEG)[segs], meta.slot_ids,
                                 meta.max_slots)
    np.testing.assert_array_equal(_bits(gg.numpy()), _bits(want))


@pytest.mark.parametrize("seg_elems", [SEG, 2 * SEG])
@pytest.mark.parametrize("flags", [dict(), dict(use_nvlamb=True,
                                                wd_is_zero=True),
                                   dict(wd_is_zero=True)],
                         ids=["default", "nvlamb_wd0", "wd0"])
def test_plain_pass_matches_reference_kernel(seg_elems, flags):
    """The plain pass, its sums in the kernel's order, against the
    reference's Pallas kernel in interpret mode; two blocks' rounds a
    block at 2 * 65,536 elements a segment."""
    rmeta, meta, p, m, v, g = _case(seg_elems, 5)
    kw = dict(dict(use_nvlamb=False, wd_is_zero=False), **flags)
    s = SCALARS
    scal = jnp.asarray([s[k] for k in ("b1", "b2", "beta3", "eps", "wd",
                                       "bc1", "bc2", "mode", "inv_scale",
                                       "lr")], jnp.float32)
    want = ref_pass(*(jnp.asarray(a) for a in (p, m, v, g)), meta=rmeta,
                    scalars=scal, out_dtype=jnp.float32, sr_seed=None,
                    interpret=True, with_grad_norm=True, **kw)
    ts = [torch.from_numpy(a.copy()) for a in (p, m, v, g)]
    found, gg = _small_segment_pass(
        *ts, ts[:3], meta=meta,
        scalars=[s[k] for k in ("b1", "b2", "beta3", "eps", "wd", "bc1",
                                "bc2", "mode")],
        inv_scale=s["inv_scale"], lr=s["lr"], with_grad_norm=True, **kw)
    assert float(found) == float(want[3]) == 0.0
    for i in (1, 2):
        np.testing.assert_array_equal(_bits(ts[i].numpy()), _bits(want[i]))
    small = np.zeros(p.shape[0], bool)
    for seg in meta.small_segments:
        small[seg * seg_elems:(seg + 1) * seg_elems] = True
    got_p, want_p = ts[0].numpy()[small], np.asarray(want[0])[small]
    step = np.abs(p[small] - want_p)
    bound = (1e-5 * step + 2 * np.spacing(step)
             + np.spacing(np.abs(want_p)).astype(np.float32))
    assert (np.abs(got_p - want_p) <= bound).all()
    np.testing.assert_array_equal(ts[0].numpy()[~small], p[~small])
    np.testing.assert_allclose(gg.numpy(), np.asarray(want[4]), rtol=1e-5)


@pytest.mark.parametrize("stash_p", [True, False])
@pytest.mark.parametrize("u_bytes", [4, 2])
def test_every_budgeted_segment_fits_two_blocks_an_sm(stash_p, u_bytes):
    """The largest segment the default budget allows for each stash
    leaves a block of the 16-block cluster under half an SM's shared
    memory (at the most slots a segment takes), so two blocks share an
    SM; the budget itself is the layout's and did not move."""
    assert DEFAULT_SEG_SMEM_BUDGET == 8 * (BLOCK_SMEM_BYTES - 16384)
    assert CLUSTER_BLOCKS == 16
    bpe = u_bytes + (4 if stash_p else 0)
    seg = DEFAULT_SEG_SMEM_BUDGET // bpe // CHUNK * CHUNK
    smem = segment_smem_bytes(seg, 512, stash_p, u_bytes=u_bytes)
    assert 2 * (smem + 1024) <= SM_SMEM_BYTES, smem
