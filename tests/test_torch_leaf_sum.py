"""Per-leaf sums in one fixed order, and the square root of the plain
paths.

The per-tensor norms (NovoGrad's denominators, LARS's and LAMB's ratios)
sum each leaf's per-subtile partials. ``engine.leaf_sums`` does it in one
documented order, the ``leaf_sum`` kernel's (``csrc/sumsq.cu``): each run
cut into chunks of 2048, in a chunk 256 strided running sums from +0 and
a halving tree, then the chunks' sums in chunk order. Its plain version is
held bitwise to a numpy evaluation of that order written out here, and
the kernel to the plain version on the card
(``tests/test_torch_kernels_cuda.py``, ``chip_smoke.py``). Tolerances:
bitwise, except the per-tensor norms against the reference (fp32 sums in
another order: 1e-6 relative).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from apex_tpu.multi_tensor import FlatSpace as RefSpace
from apex_tpu.multi_tensor import per_tensor_l2norm as ref_per_tensor

from apex_tpu_torch.multi_tensor import FlatSpace, engine
from apex_tpu_torch.multi_tensor.flat_buffer import segmented_space
from apex_tpu_torch.multi_tensor import ops as mt_ops
from apex_tpu_torch.multi_tensor.engine import sqrt_rn


def _documented_order(x: np.ndarray) -> np.float32:
    """A run of fp32 partials summed as the kernel does: cut into chunks
    of 2048 (an empty run one chunk of nothing); in a chunk, element j to
    running sum j % 256, in turn, from +0, then v[i] += v[i + s] for s =
    128, 64, ..., 1; the chunks' sums added in chunk order."""
    x = x.astype(np.float32)
    sums = []
    for lo in range(0, max(len(x), 1), 2048):
        v = np.zeros(256, np.float32)
        for j, a in enumerate(x[lo:lo + 2048]):
            v[j % 256] = np.float32(v[j % 256] + a)
        s = 128
        while s >= 1:
            v[:s] = (v[:s] + v[s:2 * s]).astype(np.float32)
            s //= 2
        sums.append(v[0])
    total = sums[0]
    for c in sums[1:]:
        total = np.float32(total + c)
    return total


def _space(sizes):
    return FlatSpace.create({f"t{i}": torch.empty(n, device="meta")
                             for i, n in enumerate(sizes)})


@pytest.mark.parametrize("sizes", [
    (3000, 10, 4097), (1,), (2048 * 300, 5, 2048 * 1000 + 3),
    (2048 * 2047, 2048 * 2048, 2048 * 2049, 7, 2048 * 4097),
    (2048 * 25152, 1024, 2048 * 1536)],
    ids=["small", "one", "long_runs", "chunk_edges", "embedding"])
def test_leaf_sums_follow_the_documented_order(sizes):
    space = _space(sizes)
    n_sub = space.total // 2048
    rng = np.random.RandomState(len(sizes))
    x = (rng.rand(n_sub) * np.exp(rng.randn(n_sub) * 4)).astype(np.float32)
    got = engine.leaf_sums(torch.from_numpy(x), space).numpy()
    runs = engine.leaf_runs(space).numpy()
    want = np.array([_documented_order(x[a:b]) for a, b in runs],
                    np.float32)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    again = engine.leaf_sums(torch.from_numpy(x), space, plain=True)
    assert torch.equal(again, torch.from_numpy(got))


def test_leaf_chunks_cut_each_run_in_order():
    runs = torch.tensor([[0, 0], [0, 1], [1, 2049], [2049, 4098],
                         [4098, 4098 + 25152]], dtype=torch.int32)
    chunks = engine.leaf_chunks(runs)
    assert chunks.dtype == torch.int32
    counts = np.bincount(chunks[:, 0].numpy(), minlength=len(runs))
    assert counts.tolist() == [1, 1, 1, 2, 13]
    for leaf in range(len(runs)):
        mine = chunks[chunks[:, 0] == leaf, 1].tolist()
        assert mine == list(range(counts[leaf]))
    # a leaf's chunks are consecutive rows
    assert (np.diff(chunks[:, 0].numpy()) >= 0).all()


def test_plain_leaf_sum_of_an_empty_run_is_plus_zero():
    x = torch.tensor([-0.0, 1.5, -2.0, 0.25])
    runs = torch.tensor([[0, 0], [0, 1], [1, 4], [4, 4]], dtype=torch.int32)
    got = engine._leaf_sum_torch(x, runs)
    want = np.array([0.0, 0.0, _documented_order(np.array([1.5, -2.0,
                                                            0.25])), 0.0],
                    np.float32)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


def test_leaf_runs_cover_each_leaf_once():
    space = _space((3000, 10, 4097, 2048))
    runs = engine.leaf_runs(space)
    ids = space.tile_leaf_ids(2048)
    for leaf, (a, b) in enumerate(runs.tolist()):
        assert (ids[a:b] == leaf).all()
    assert int(runs[-1, 1]) == len(ids)
    assert (runs[1:, 0] == runs[:-1, 1]).all()


def test_per_tensor_norms_match_reference():
    rng = np.random.RandomState(5)
    tree = {"a": rng.randn(3000).astype(np.float32),
            "b": rng.randn(10).astype(np.float32),
            "c": rng.randn(70000).astype(np.float32)}
    rs = RefSpace.create({k: jnp.asarray(v) for k, v in tree.items()})
    ps = FlatSpace.create({k: torch.from_numpy(v) for k, v in tree.items()})
    want = np.asarray(ref_per_tensor(rs.pack({k: jnp.asarray(v) for k, v in
                                              tree.items()}), rs,
                                     impl="xla"))
    got = mt_ops.per_tensor_l2norm(ps.pack({k: torch.from_numpy(v) for k, v
                                            in tree.items()}), ps)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_segmented_index_adds_take_one_value_per_kept_leaf():
    """The two ``index_add_`` calls of the segmented LAMB add at most one
    value per kept index, so their order cannot change a sum: each small
    leaf has one slot (empty slots go to the dropped row past the last
    leaf), and each large leaf appears once in ``leaves``."""
    sizes = [70000, 300, 5, 1 << 20, 4097, 12, 2048, 1 << 19]
    tensors = {f"t{i}": torch.zeros(n) for i, n in enumerate(sizes)}
    space, meta = segmented_space(tensors, seg_elems=1 << 18)
    nl = space.num_leaves
    slots = meta.device_slot_leaf("cpu", nl).numpy()
    kept = slots[slots < nl]
    assert np.bincount(kept, minlength=nl).max() <= 1
    if meta.large:
        _, leaves, _ = meta.device_large("cpu")
        assert len(set(leaves.tolist())) == leaves.numel()
        assert not set(leaves.tolist()) & set(kept.tolist())


def test_plain_sqrt_rounds_once_through_numpy():
    x = np.array([0.0, 2.0, 1e-45, 3.4e38, np.inf, 0.25], np.float32)
    got = sqrt_rn(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.sqrt(x).view(np.uint32))
    scalar = sqrt_rn(torch.tensor(9.0))
    assert scalar.shape == () and float(scalar) == 3.0
    assert sqrt_rn(torch.tensor([4.0], dtype=torch.float64)).item() == 2.0


def test_leaf_sum_kernel_spans_cover_each_chunk_once():
    """The kernel's block descriptors: chunk c of a leaf's n reads
    ``[start + 2048 c, min(start + 2048 (c + 1), end))``; an empty run
    is one block of nothing; the counters and the scratch start at 0."""
    runs = torch.tensor([[0, 0], [0, 1], [1, 2049], [2049, 4098],
                         [4098, 4098 + 25152]], dtype=torch.int32)
    spans, partial, count = engine._leaf_sum_scratch(runs)
    assert spans.dtype == torch.int32 and spans.shape == (18, 4)
    lo, hi, leaf, packed = (spans[:, i].tolist() for i in range(4))
    c, n = [p >> 16 for p in packed], [p & 0xFFFF for p in packed]
    assert leaf == [0, 1, 2, 3, 3] + [4] * 13
    assert n == [1, 1, 1, 2, 2] + [13] * 13
    assert c == [0, 0, 0, 0, 1] + list(range(13))
    assert list(zip(lo, hi))[:5] == [(0, 0), (0, 1), (1, 2049),
                                     (2049, 4097), (4097, 4098)]
    assert lo[5:] == [4098 + 2048 * k for k in range(13)]
    assert hi[-1] == 4098 + 25152 and hi[-2] == lo[-1]
    assert not partial.any() and partial.shape == (18,)
    assert not count.any() and count.shape == (5,)
