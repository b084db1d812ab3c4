"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

Every test here needs a CUDA device and skips without one (a CUDA
kernel has no CPU mode; the plain versions are held against apex_tpu on
the CPU by test_torch_layer_norm.py, test_torch_attention.py and their
_bwd counterparts, test_torch_adam.py, test_torch_softmax.py,
test_torch_sgd.py, test_torch_scale_axpby.py,
test_torch_novograd_adagrad.py, test_torch_xentropy.py and
test_torch_rope.py). This
file imports neither JAX nor apex_tpu, so it runs on a machine with
only PyTorch: ``python -m pytest --noconftest -m cuda
tests/test_torch_kernels_cuda.py``.

Tolerances, in the working dtype bf16: LayerNorm outputs and dx within
one bf16 ulp of the value (2^-7 |y|: fp32 sums in another order may
round to the neighbouring bf16 value) plus 1e-5 near zero (fp32 values
a few 1e-7 apart there span several of bf16's tiny ulps), statistics
within 1e-5, the fp32 dw and db within 1e-5 of their largest |value|;
attention outputs within 2e-2 absolute (the kernel rounds P to bf16
before P.V, the plain version does not) and the fp32 lse within 1e-3;
dq, dk and dv within 2^-6 of each one's largest |value| (both round dS
to bf16 before its products; fp32 values that differ in their last bits
may round to neighbouring bf16 values). Adam: bitwise (the kernel
rounds every operation on its own, in the plain version's order).
Softmax forwards within one bf16 ulp of the value (2^-7; fp32 within
1e-5 of the value: sums in another order), the backward within one ulp
of each row's largest |dx| (the row's dot product is summed in another
order). SGD, LARS, scale, axpby, Adagrad and NovoGrad: bitwise (the
tolerances of the whole LARS and NovoGrad updates are stated with their
tests). Cross entropy and RoPE: stated with their tests.
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch import _build
from apex_tpu_torch.multi_tensor import fused_adam_update, ops as mt_ops
from apex_tpu_torch.ops import attention, layer_norm


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("h", [1024, 1000, 4096, 4100])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layer_norm_kernel_matches_plain(cuda_device, h, dtype, rms):
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(37, h).astype(np.float32) * 2 + 0.5)
    x = x.to(cuda_device, dtype)
    w = torch.from_numpy(1 + 0.1 * rng.randn(h).astype(np.float32)).cuda()
    b = None if rms else torch.from_numpy(
        0.1 * rng.randn(h).astype(np.float32)).cuda()
    before = _build.launch_counts().get(layer_norm.KERNEL, 0)
    with torch.no_grad():
        y, mean, rstd = layer_norm._fwd_cuda(x, w, b, 1e-5, rms)
        py, pmean, prstd = layer_norm._fwd_torch(x, w, b, 1e-5, rms)
    torch.cuda.synchronize()
    assert _build.launch_counts()[layer_norm.KERNEL] == before + 1
    torch.testing.assert_close(mean, pmean, rtol=0, atol=1e-5)
    torch.testing.assert_close(rstd, prstd, rtol=1e-5, atol=0)
    if dtype == torch.bfloat16:
        diff = (y.float() - py.float()).abs()
        assert (diff <= 2.0 ** -7 * py.float().abs() + 1e-5).all()
    else:
        torch.testing.assert_close(y, py, rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("h", [1024, 1000, 4096, 4100])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_layer_norm_bwd_kernel_matches_plain(cuda_device, h, dtype, rms):
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(37, h).astype(np.float32) * 2 + 0.5)
    x = x.to(cuda_device, dtype)
    g = torch.from_numpy(rng.randn(37, h).astype(np.float32)).to(
        cuda_device, dtype)
    w = torch.from_numpy(1 + 0.1 * rng.randn(h).astype(np.float32)).cuda()
    _, mean, rstd = layer_norm._fwd_torch(x, w, None, 1e-5, rms)
    before = _build.launch_counts().get(layer_norm.BWD_KERNEL, 0)
    dx, dw, db = layer_norm._bwd_cuda(x, w, mean, rstd, g, rms)
    pdx, pdw, pdb = layer_norm._bwd_torch(x, w, mean, rstd, g, rms)
    torch.cuda.synchronize()
    assert _build.launch_counts()[layer_norm.BWD_KERNEL] == before + 1
    assert dx.dtype == dtype
    diff = (dx.float() - pdx.float()).abs()
    assert (diff <= 2.0 ** -7 * pdx.float().abs() + 1e-5).all()
    for got, want in ((dw, pdw), (db, pdb)):
        torch.testing.assert_close(
            got, want, rtol=0, atol=1e-5 * float(want.abs().max()))


@pytest.mark.cuda
def test_layer_norm_autograd_runs_both_kernels(cuda_device):
    x = torch.randn(64, 256, device=cuda_device,
                    dtype=torch.bfloat16).requires_grad_()
    w = torch.ones(256, device=cuda_device, requires_grad=True)
    b = torch.zeros(256, device=cuda_device, requires_grad=True)
    counts = _build.launch_counts()
    layer_norm.fused_layer_norm(x, w, b).float().sum().backward()
    torch.cuda.synchronize()
    after = _build.launch_counts()
    for k in (layer_norm.KERNEL, layer_norm.BWD_KERNEL):
        assert after[k] == counts.get(k, 0) + 1
    assert x.grad is not None and w.grad is not None and b.grad is not None


ATTENTION_CASES = {
    # name: (b, h, hk, sq, sk, d, causal, window, segments)
    "causal": (2, 4, 4, 130, 130, 64, True, None, False),
    "chunk": (2, 4, 4, 48, 200, 64, True, None, True),
    "decode": (3, 4, 4, 1, 77, 64, False, None, True),
    "gqa": (2, 8, 2, 64, 64, 128, True, None, False),
    "window": (1, 2, 2, 150, 150, 32, True, 40, False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ATTENTION_CASES))
def test_flash_kernel_matches_plain(cuda_device, case):
    b, h, hk, sq, sk, d, causal, window, segs = ATTENTION_CASES[case]
    rng = np.random.RandomState(7)
    q, k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        cuda_device, torch.bfloat16)
        for shape in ((b, h, sq, d), (b, hk, sk, d), (b, hk, sk, d)))
    kw = dict(causal=causal, window_size=window, return_lse=True)
    if segs:
        kw["kv_segment_ids"] = torch.from_numpy(
            (rng.rand(b, sk) < 0.2).astype(np.int32)).to(cuda_device)
    before = _build.launch_counts().get(attention.KERNEL, 0)
    with torch.no_grad():
        out, lse = attention.flash_attention(q, k, v, **kw)
        pout, plse = attention.attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts()[attention.KERNEL] == before + 1
    torch.testing.assert_close(out.float(), pout.float(), rtol=0, atol=2e-2)
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_flash_kernel_refuses_unported_options(cuda_device):
    q = torch.zeros(1, 2, 8, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="bias"):
        attention.flash_attention(
            q, q, q, bias=torch.zeros(1, 1, 8, 8, device=cuda_device))
    with pytest.raises(NotImplementedError, match="dropout"):
        attention.flash_attention(q, q, q, dropout_rate=0.1, dropout_rng=1)
    with pytest.raises(NotImplementedError, match="head_dim"):
        z = torch.zeros(1, 2, 8, 48, device=cuda_device,
                        dtype=torch.bfloat16)
        attention.flash_attention(z, z, z)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ATTENTION_CASES))
def test_flash_bwd_kernels_match_plain(cuda_device, case):
    b, h, hk, sq, sk, d, causal, window, segs = ATTENTION_CASES[case]
    rng = np.random.RandomState(9)
    q, k, v, do = (torch.from_numpy(rng.randn(*shape).astype(
        np.float32)).to(cuda_device, torch.bfloat16) for shape in (
        (b, h, sq, d), (b, hk, sk, d), (b, hk, sk, d), (b, h, sq, d)))
    q_seg = k_seg = None
    if segs:
        k_seg = torch.from_numpy(
            (rng.rand(b, sk) < 0.2).astype(np.int32)).to(cuda_device)
        q_seg = torch.zeros(b, sq, dtype=torch.int32, device=cuda_device)
    scale = d ** -0.5
    with torch.no_grad():
        out, lse = attention._flash_cuda(q, k, v, q_seg, k_seg, scale,
                                         causal, window)
    delta = (out.float() * do.float()).sum(-1)
    args = (q, k, v, lse, do, delta, q_seg, k_seg, scale, causal, window)
    counts = _build.launch_counts()
    got = attention._flash_bwd_cuda(*args)
    want = attention._flash_bwd_torch(*args)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    for kname in (attention.BWD_DQ_KERNEL, attention.BWD_DKV_KERNEL):
        assert after[kname] == counts.get(kname, 0) + 1
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        scale_w = max(float(w.float().abs().max()), 1e-6)
        err = float((g.float() - w.float()).abs().max())
        assert err <= 2.0 ** -6 * scale_w, (name, err, scale_w)


@pytest.mark.cuda
def test_flash_autograd_runs_the_backward_kernels(cuda_device):
    q = torch.randn(1, 2, 70, 64, device=cuda_device,
                    dtype=torch.bfloat16).requires_grad_()
    counts = _build.launch_counts()
    attention.flash_attention(q, q, q, causal=True).float().sum().backward()
    torch.cuda.synchronize()
    after = _build.launch_counts()
    for kname in (attention.KERNEL, attention.BWD_DQ_KERNEL,
                  attention.BWD_DKV_KERNEL):
        assert after[kname] == counts.get(kname, 0) + 1
    assert torch.isfinite(q.grad.float()).all()
    with pytest.raises(NotImplementedError, match="lse"):
        attention.flash_attention(q, q, q, return_lse=True)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3 * 2048 + 517, 1 << 20])
@pytest.mark.parametrize("adam_w_mode", [True, False])
def test_adam_kernel_bitwise_equals_plain(cuda_device, n, adam_w_mode):
    rng = np.random.RandomState(10)
    p, m, g = (torch.from_numpy(rng.randn(n).astype(np.float32)).to(
        cuda_device) for _ in range(3))
    v = torch.from_numpy(np.abs(rng.randn(n)).astype(np.float32)).to(
        cuda_device)
    kw = dict(lr=1e-3, weight_decay=0.01, step=5, adam_w_mode=adam_w_mode,
              grad_scale=8.0)
    want = fused_adam_update(p.clone(), m.clone(), v.clone(), g, plain=True,
                             **kw)
    before = _build.launch_counts().get(mt_ops.ADAM_KERNEL, 0)
    got = fused_adam_update(p, m, v, g, **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts()[mt_ops.ADAM_KERNEL] == before + 1
    assert got[0] is p and got[1] is m and got[2] is v      # in place
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert float(got[3]) == float(want[3]) == 0.0


@pytest.mark.cuda
def test_adam_kernel_found_inf_and_out_of_place(cuda_device):
    n = 10_000
    p, m, v = (torch.rand(n, device=cuda_device) for _ in range(3))
    g = torch.randn(n, device=cuda_device)
    g[4321] = float("nan")
    g[n - 1] = float("inf")
    saved = [t.clone() for t in (p, m, v)]
    p2, m2, v2, found = fused_adam_update(p, m, v, g, lr=1e-3,
                                          in_place=False)
    torch.cuda.synchronize()
    assert float(found) == 1.0
    for t, s_ in zip((p, m, v), saved):
        assert torch.equal(t, s_)
    assert p2.data_ptr() != p.data_ptr()


# -- the sum-of-squares and LAMB kernels ------------------------------------
#
# Tolerances: sums of squares, norms and trust ratios relative 1e-5 (fp32
# sums in another order); LAMB stage 1's u, m' and v', stage 2's p' and
# the segment pass's m' and v': bitwise (every operation rounded on its
# own in the plain version's order); the segment pass's p' within 1e-5 of
# each element's step |p - p'| plus one ulp of p' (its ratios come from
# sums in another order).


def _rand(rng, n, dev, scale=1.0, positive=False):
    a = rng.randn(n).astype(np.float32) * scale
    return torch.from_numpy(np.abs(a) if positive else a).to(dev)


def _lamb_scalars():
    return dict(beta1=0.9, beta2=0.999, beta3=0.1, eps=1e-6,
                weight_decay=0.01, bias_correction1=0.271,
                bias_correction2=0.002997)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 517, 3 * 65536 + 517])
@pytest.mark.parametrize("tile_rows", [None, 16])
@pytest.mark.parametrize("scale", [None, 0.375, "device"])
def test_sumsq_kernel_matches_plain(cuda_device, n, tile_rows, scale):
    from apex_tpu_torch.multi_tensor import engine
    x = _rand(np.random.RandomState(n), n, cuda_device)
    if scale == "device":
        scale = torch.tensor(0.25, device=cuda_device)
    name = engine.SUMSQ_KERNEL if scale is None else \
        engine.SUMSQ_SCALED_KERNEL
    before = _build.launch_counts().get(name, 0)
    got = engine.fused_sumsq_partials(x, tile_rows, scale=scale)
    want = engine.fused_sumsq_partials(x, tile_rows, scale=scale, plain=True)
    torch.cuda.synchronize()
    assert _build.launch_counts()[name] == before + 1
    torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    again = engine.fused_sumsq_partials(x, tile_rows, scale=scale)
    assert torch.equal(got, again)                     # deterministic


@pytest.mark.cuda
def test_unscale_l2norm_found_inf_on_card(cuda_device):
    from apex_tpu_torch.multi_tensor import fused_unscale_l2norm
    x = torch.randn(100_000, device=cuda_device)
    assert float(fused_unscale_l2norm(x)[1]) == 0.0
    for bad in (float("inf"), float("nan")):
        y = x.clone()
        y[4321] = bad
        assert float(fused_unscale_l2norm(y, inv_scale=0.5)[1]) == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("n", [3 * 2048 + 517, 1 << 20])
@pytest.mark.parametrize("adam_w_mode", [True, False])
@pytest.mark.parametrize("grad_partials", [False, True])
@pytest.mark.parametrize("inv", ["host", "device"])
def test_lamb_stage1_kernel_bitwise_equals_plain(cuda_device, n, adam_w_mode,
                                                 grad_partials, inv):
    from apex_tpu_torch.multi_tensor import fused_lamb_compute_update_term
    rng = np.random.RandomState(11)
    p, m, g = (_rand(rng, n, cuda_device) for _ in range(3))
    v = _rand(rng, n, cuda_device, positive=True)
    inv_scale = 3.0 if inv == "host" else torch.tensor(3.0,
                                                       device=cuda_device)
    kw = dict(_lamb_scalars(), adam_w_mode=adam_w_mode, inv_scale=inv_scale,
              with_norm_partials=True, with_grad_partials=grad_partials)
    want, wf = fused_lamb_compute_update_term(p, m.clone(), v.clone(), g,
                                              plain=True, **kw)
    before = _build.launch_counts().get(mt_ops.LAMB_STAGE1_KERNEL, 0)
    got, f = fused_lamb_compute_update_term(p, m, v, g, **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts()[mt_ops.LAMB_STAGE1_KERNEL] == before + 1
    assert got[1] is m and got[2] is v
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert len(got) == len(want)
    for a, b in zip(got[3:], want[3:]):
        torch.testing.assert_close(a.sum(-1), b.sum(-1), rtol=1e-5, atol=0)
    assert float(f) == float(wf) == 0.0
    g[n - 1] = float("nan")
    assert float(fused_lamb_compute_update_term(p, m, v, g, **kw)[1]) == 1.0


@pytest.mark.cuda
def test_lamb_stage2_kernel_bitwise_equals_plain(cuda_device):
    from apex_tpu_torch.multi_tensor import FlatSpace
    space = FlatSpace.create({"a": torch.empty(5000), "b": torch.empty(7),
                              "c": torch.empty(70000)})
    rng = np.random.RandomState(12)
    p, u = (_rand(rng, space.total, cuda_device) for _ in range(2))
    ratio = torch.tensor([0.5, 2.0, 1.25], device=cuda_device)
    ids = space.device_subtile_leaf_ids(cuda_device)
    want = mt_ops.lamb_apply(p, u, ratio, lr=1e-3, tile_ids=ids,
                             in_place=False, plain=True)
    before = _build.launch_counts().get(mt_ops.LAMB_STAGE2_KERNEL, 0)
    got = mt_ops.lamb_apply(p, u, ratio, lr=1e-3, tile_ids=ids)
    torch.cuda.synchronize()
    assert _build.launch_counts()[mt_ops.LAMB_STAGE2_KERNEL] == before + 1
    assert got is p
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def _segmented_case(dev, seed, seg_elems=65536):
    from apex_tpu_torch.multi_tensor import segmented_space
    shapes = [(3000,), (10,), (70000,), (40, 700), (5,), (130000,),
              (2048,), (61000,), (7,), (9000,), (1024,), (1024,)]
    space, meta = segmented_space(
        {f"l{i:02d}": torch.empty(s, device="meta")
         for i, s in enumerate(shapes)}, seg_elems=seg_elems)
    rng = np.random.RandomState(seed)
    bufs = []
    for scale, pos in ((1.0, False), (0.01, False), (1e-4, True), (0.5, False)):
        b = torch.zeros(space.total, device=dev)
        for off, size in zip(space.offsets, space.sizes):
            b[off:off + size] = _rand(rng, size, dev, scale, pos)
        bufs.append(b)
    return space, meta, bufs


@pytest.mark.cuda
@pytest.mark.parametrize("stash_p", [True, False])
@pytest.mark.parametrize("with_grad_norm", [False, True])
@pytest.mark.parametrize("clip", [False, True])
def test_segmented_lamb_kernels_match_plain(cuda_device, stash_p,
                                            with_grad_norm, clip):
    from apex_tpu_torch.multi_tensor import fused_lamb_segmented_update
    from apex_tpu_torch.multi_tensor.segmented import SEGMENT_KERNEL
    space, meta, (p, m, v, g) = _segmented_case(cuda_device, 13)
    kw = dict(lr=2e-3, weight_decay=0.01, step=3, stash_p=stash_p,
              with_grad_norm=with_grad_norm,
              max_grad_norm=1.0 if clip else 0.0, grad_scale=4.0)
    want = fused_lamb_segmented_update(p.clone(), m.clone(), v.clone(), g,
                                       space, meta, plain=True, **kw)
    counts = _build.launch_counts()
    got = fused_lamb_segmented_update(p.clone(), m.clone(), v.clone(), g,
                                      space, meta, **kw)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    assert after[SEGMENT_KERNEL] == counts.get(SEGMENT_KERNEL, 0) + 1
    assert meta.large                  # one launch each for all of them
    for k in (mt_ops.LAMB_STAGE1_KERNEL, mt_ops.LAMB_STAGE2_KERNEL):
        assert after[k] == counts.get(k, 0) + 1
    for a, b in zip(got[1:3], want[1:3]):
        if clip:     # each side's own norm may differ in its last bit
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-9)
        else:
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    step = (p - want[0]).abs()
    bound = 1e-5 * step + torch.finfo(torch.float32).eps * want[0].abs()
    assert bool(((got[0] - want[0]).abs() <= bound + 1e-12).all())
    assert float(got[3]) == float(want[3]) == 0.0
    if with_grad_norm:
        torch.testing.assert_close(got[4], want[4], rtol=1e-5, atol=0)
    # deterministic: the same bits again
    again = fused_lamb_segmented_update(p.clone(), m.clone(), v.clone(), g,
                                        space, meta, **kw)
    for a, b in zip(got[:3], again[:3]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_segment_kernel_found_inf_and_out_of_place(cuda_device):
    from apex_tpu_torch.multi_tensor import fused_lamb_segmented_update
    space, meta, (p, m, v, g) = _segmented_case(cuda_device, 14)
    g[meta.small_segments[0] * meta.seg_elems + 3] = float("inf")
    saved = [t.clone() for t in (p, m, v)]
    got = fused_lamb_segmented_update(p, m, v, g, space, meta, lr=1e-3,
                                      in_place=False)
    torch.cuda.synchronize()
    assert float(got[3]) == 1.0
    for t, s_ in zip((p, m, v), saved):
        assert torch.equal(t, s_)
    # out of place writes every element: with a finite gradient the new
    # buffers equal the in-place result bit for bit
    g[meta.small_segments[0] * meta.seg_elems + 3] = 0.0
    new = fused_lamb_segmented_update(p, m, v, g, space, meta, lr=1e-3,
                                      in_place=False)
    fused_lamb_segmented_update(p, m, v, g, space, meta, lr=1e-3)
    for a, b in zip(new[:3], (p, m, v)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("segmented", [True, False])
def test_fused_lamb_step_on_card_matches_plain(cuda_device, segmented):
    """FusedLAMB.step_flat through the kernels against the same step
    through the plain versions (``plain`` runs the update's plain
    versions on the card)."""
    from apex_tpu_torch.multi_tensor import (fused_lamb_segmented_update,
                                             fused_lamb_update)
    from apex_tpu_torch.optimizers import FusedLAMB
    params = {f"w{i}": torch.randn(s, device=cuda_device)
              for i, s in enumerate([(300, 1000), (1000,), (2, 7), (5000,)])}
    opt = FusedLAMB(lr=1e-2, segmented=segmented, seg_elems=65536)
    state = opt.init(params)
    g = torch.randn(state.master.shape[0], device=cuda_device)
    kw = dict(lr=1e-2, weight_decay=0.01, max_grad_norm=1.0, step=1)
    args = (state.master.clone(), state.slots["m"].clone(),
            state.slots["v"].clone(), g, state.space)
    want = (fused_lamb_segmented_update(*args, state.seg_meta, plain=True,
                                        **kw) if segmented else
            fused_lamb_update(*args, plain=True, **kw))
    _, state = opt.step_flat(state, g)
    torch.cuda.synchronize()
    torch.testing.assert_close(state.slots["m"], want[1], rtol=1e-5,
                               atol=1e-9)
    torch.testing.assert_close(state.master, want[0], rtol=1e-6, atol=1e-7)


# -- the softmax family (ops/softmax.py, csrc/softmax.cu) --------------------

# name: (mode, x shape, mask batch or None)
SOFTMAX_CASES = {
    "scaled_bert": ("scaled", (2, 4, 64, 512), None),
    "scaled_ragged_37": ("scaled", (3, 5, 37), None),
    "scaled_1000": ("scaled", (6, 1000), None),
    "scaled_block_2048": ("scaled", (2, 3, 2048), None),
    "scaled_block_3001": ("scaled", (5, 3001), None),
    "causal_square": ("causal", (4, 128, 128), None),
    "causal_1024": ("causal", (2, 1024, 1024), None),
    "causal_offset_33x100": ("causal", (3, 33, 100), None),
    "causal_block_1500": ("causal", (2, 40, 1500), None),
    "masked_bert": ("masked", (2, 4, 128, 512), 2),
    "masked_broadcast": ("masked", (2, 4, 128, 512), 1),
    "masked_ragged_45": ("masked", (2, 3, 20, 45), 2),
    "masked_block_1100": ("masked", (2, 2, 24, 1100), 2),
}


def _softmax_inputs(case, dev, dtype, seed=0):
    """x and the mask (the outer-product padding mask of BERT, pad query
    rows fully masked) for one case."""
    mode, shape, mb = SOFTMAX_CASES[case]
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(3 * rng.randn(*shape).astype(np.float32)).to(
        dev, dtype)
    mask = None
    if mode == "masked":
        b, _, sq, sk = shape
        lens = rng.randint(sk // 4, sk, b)
        keep = np.arange(sk)[None, :] < lens[:, None]
        qkeep = np.arange(sq)[None, :] < np.minimum(lens, sq - 2)[:, None]
        full = ~(qkeep[:, :, None] & keep[:, None, :])[:, None]
        mask = torch.from_numpy(full[:mb]).to(dev)
    return mode, x, mask


def _close_to_plain(got, want, dtype):
    """bf16: within one bf16 ulp of the value elementwise; fp32: within
    1e-5 of the value (fp32 sums in another order)."""
    a, b = got.float(), want.float()
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    excess = (a - b).abs() - tol * torch.maximum(a.abs(), b.abs())
    assert float(excess.max()) <= 0.0, float(excess.max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(SOFTMAX_CASES))
def test_softmax_fwd_kernels_match_plain(cuda_device, case, dtype):
    from apex_tpu_torch.ops import softmax
    mode, x, mask = _softmax_inputs(case, cuda_device, dtype)
    kernel = softmax._MODES[mode][1]
    before = _build.launch_counts().get(kernel, 0)
    if mask is not None:
        mask = mask.expand(mask.shape[0], 1, *x.shape[2:])
    y = softmax._fwd_cuda(x, mask, 0.8, mode)
    want = softmax._fwd_torch(x, mask, 0.8, mode)
    torch.cuda.synchronize()
    assert _build.launch_counts()[kernel] == before + 1
    assert y.dtype == dtype and y.shape == x.shape
    _close_to_plain(y, want, dtype)
    if mode == "causal":
        sq, sk = x.shape[-2:]
        upper = torch.arange(sk, device=cuda_device)[None, :] > torch.arange(
            sq, device=cuda_device)[:, None]
        assert bool((y[:, upper] == 0).all())
    if mode == "masked":
        # pad query rows (every key masked): the softmax of the shifted
        # scores, not zeros
        pad = mask[:, 0].all(dim=-1)
        rows = y[pad.expand(x.shape[0], -1)[:, None].expand(
            -1, x.shape[1], -1)]
        assert rows.numel() and bool((rows.float().sum(-1) > 0.9).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("sk", [512, 1024, 37, 1000, 2048, 3001])
def test_softmax_bwd_kernel_matches_plain(cuda_device, sk, dtype):
    """dx within one ulp of each row's largest |dx| (bf16 2^-7, fp32
    1e-5): dot = sum(g * y) is summed in another order, and where g and
    dot nearly cancel that moves dx by a share of the row's scale, not of
    the element."""
    from apex_tpu_torch.ops import softmax
    rng = np.random.RandomState(1)
    x = torch.from_numpy(2 * rng.randn(40, sk).astype(np.float32)).to(
        cuda_device, dtype)
    y = softmax._fwd_torch(x, None, 1.0, "scaled")
    g = torch.from_numpy(rng.randn(40, sk).astype(np.float32)).to(
        cuda_device, dtype)
    before = _build.launch_counts().get(softmax.BWD_KERNEL, 0)
    dx = softmax._bwd_cuda(y, g, 0.125)
    want = softmax._bwd_torch(y, g, 0.125)
    torch.cuda.synchronize()
    assert _build.launch_counts()[softmax.BWD_KERNEL] == before + 1
    tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    row = want.float().abs().amax(dim=-1, keepdim=True).clamp_min(1e-6)
    assert float(((dx.float() - want.float()).abs() / row).max()) <= tol


@pytest.mark.cuda
def test_softmax_autograd_runs_both_kernels(cuda_device):
    from apex_tpu_torch.ops import softmax
    from apex_tpu_torch.transformer.functional import FusedScaleMaskSoftmax
    _, x, mask = _softmax_inputs("masked_ragged_45", cuda_device,
                                 torch.bfloat16)
    x.requires_grad_()
    counts = dict(_build.launch_counts())
    y = FusedScaleMaskSoftmax()(x, mask)
    y.float().sum().backward()
    torch.cuda.synchronize()
    after = _build.launch_counts()
    for k in (softmax.MASKED_KERNEL, softmax.BWD_KERNEL):
        assert after.get(k, 0) == counts.get(k, 0) + 1, k
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())


@pytest.mark.cuda
def test_softmax_kernel_refuses_other_dtypes(cuda_device):
    from apex_tpu_torch.ops import softmax
    with pytest.raises(TypeError, match="softmax kernel"):
        softmax.scaled_softmax(torch.zeros(4, 8, device=cuda_device,
                                           dtype=torch.float16))


# -- the SGD and LARS kernels -------------------------------------------------
#
# Tolerances: p' and mom' bitwise against the plain versions given the
# same scalars and ratios (every operation rounded on its own in the plain
# version's order). A whole LARS update computes its ratios from the
# sum-of-squares kernel's partials, summed in another order than the plain
# norms: mom' within 1e-6 of its terms (|mu * mom| + |mom'|), p' within lr
# times that plus one ulp of the larger of |p| and |p'|.

SGD_FLAGS = {
    "no_momentum": dict(momentum=0.0),
    "momentum": dict(momentum=0.9),
    "nesterov": dict(momentum=0.9, nesterov=True),
    "dampening": dict(momentum=0.9, dampening=0.1),
    "wd_after_momentum": dict(momentum=0.9, wd_after_momentum=True),
    "first_run": dict(momentum=0.9, first_run=True),
    "first_run_device": dict(momentum=0.9, first_run="device"),
    "scale_device": dict(momentum=0.9, nesterov=True, scale="device"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 517, 3 * 2048 + 517, 1 << 20])
@pytest.mark.parametrize("case", sorted(SGD_FLAGS))
def test_sgd_kernel_bitwise_equals_plain(cuda_device, n, case):
    rng = np.random.RandomState(n % 997)
    p, mom, g = (_rand(rng, n, cuda_device) for _ in range(3))
    kw = {"lr": 0.1, "weight_decay": 1e-4, "scale": 0.125,
          **SGD_FLAGS[case]}
    if kw.get("first_run") == "device":
        kw["first_run"] = torch.zeros((), device=cuda_device) == 0
    if kw["scale"] == "device":
        kw["scale"] = torch.full((), 0.125, device=cuda_device)
    want = mt_ops.fused_sgd_update(p.clone(), mom.clone(), g, plain=True,
                                   **kw)
    before = _build.launch_counts().get(mt_ops.SGD_KERNEL, 0)
    got = mt_ops.fused_sgd_update(p, mom, g, **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts()[mt_ops.SGD_KERNEL] == before + 1
    assert got[0] is p and got[1] is mom                    # in place
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert float(got[2]) == float(want[2]) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("lars", [False, True])
def test_sgd_and_lars_kernels_found_inf_and_out_of_place(cuda_device, lars):
    from apex_tpu_torch.multi_tensor import FlatSpace
    space = FlatSpace.create({"a": torch.empty(5000), "b": torch.empty(7)})
    rng = np.random.RandomState(13)
    p, mom, g = (_rand(rng, space.total, cuda_device) for _ in range(3))
    g[4321] = float("nan")
    g[space.total - 1] = float("inf")
    saved = [p.clone(), mom.clone()]
    if lars:
        p2, m2, found = mt_ops.fused_lars_update(p, mom, g, space, lr=0.1,
                                                 in_place=False)
    else:
        p2, m2, found = mt_ops.fused_sgd_update(p, mom, g, lr=0.1,
                                                momentum=0.9, in_place=False)
    torch.cuda.synchronize()
    assert float(found) == 1.0
    assert torch.equal(p, saved[0]) and torch.equal(mom, saved[1])
    assert p2.data_ptr() != p.data_ptr() and m2.data_ptr() != mom.data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [517, 3 * 2048 + 517, 70000])
@pytest.mark.parametrize("first_run", [False, True, "device"])
def test_lars_kernel_bitwise_equals_plain_given_the_ratios(cuda_device, n,
                                                           first_run):
    rng = np.random.RandomState(n)
    p, mom, g = (_rand(rng, n, cuda_device) for _ in range(3))
    n_sub = -(-n // 2048)
    ids = torch.from_numpy((np.arange(n_sub) % 3).astype(np.int32)).to(
        cuda_device)
    ratio = torch.tensor([0.5, 0.0123, 1.0], device=cuda_device)
    if first_run == "device":
        first_run = torch.ones((), device=cuda_device) > 0
    kw = dict(lr=0.1, momentum=0.9, weight_decay=1e-4, first_run=first_run,
              tile_ids=ids)
    want = mt_ops.lars_apply(p.clone(), mom.clone(), g, ratio, plain=True,
                             **kw)
    before = _build.launch_counts().get(mt_ops.LARS_KERNEL, 0)
    got = mt_ops.lars_apply(p, mom, g, ratio, **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts()[mt_ops.LARS_KERNEL] == before + 1
    assert got[0] is p and got[1] is mom
    for a, b in zip(got[:2], want[:2]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("clip", [True, False])
def test_fused_lars_update_on_card_matches_plain(cuda_device, clip):
    from apex_tpu_torch.multi_tensor import FlatSpace
    space = FlatSpace.create({"a": torch.empty(70000), "b": torch.empty(7),
                              "c": torch.empty(3, 3000), "z": torch.empty(9)})
    rng = np.random.RandomState(14)
    p = torch.zeros(space.total, device=cuda_device)
    g = torch.zeros(space.total, device=cuda_device)
    for name, off, size in zip(space.names, space.offsets, space.sizes):
        if name != "z":                      # a zero leaf: ratio 1
            p[off:off + size] = _rand(rng, size, cuda_device)
            g[off:off + size] = _rand(rng, size, cuda_device, 0.01)
    mom = _rand(rng, space.total, cuda_device)
    kw = dict(lr=0.1, momentum=0.9, weight_decay=1e-4, clip=clip)
    want = mt_ops.fused_lars_update(p.clone(), mom.clone(), g, space,
                                    plain=True, **kw)
    counts = _build.launch_counts()
    got = mt_ops.fused_lars_update(p.clone(), mom.clone(), g, space, **kw)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    assert after[mt_ops.LARS_KERNEL] == counts.get(mt_ops.LARS_KERNEL, 0) + 1
    from apex_tpu_torch.multi_tensor import engine
    assert after[engine.SUMSQ_KERNEL] == counts.get(engine.SUMSQ_KERNEL,
                                                     0) + 2
    tm = want[1].abs() + (0.9 * mom).abs()
    assert ((got[1] - want[1]).abs() <= 1e-6 * tm).all()
    tp = torch.maximum(p.abs(), want[0].abs())
    ulp = torch.nextafter(tp, torch.full_like(tp, float("inf"))) - tp
    assert ((got[0] - want[0]).abs() <= 0.1 * 1e-6 * tm + ulp).all()


@pytest.mark.cuda
def test_fused_sgd_lars_and_larc_steps_launch_their_kernels(cuda_device):
    from apex_tpu_torch.optimizers import FusedLARS, FusedSGD
    from apex_tpu_torch.parallel import LARC
    params = {"w": torch.randn(300, 7, device=cuda_device),
              "b": torch.randn(7, device=cuda_device)}
    for opt, kernel in ((FusedSGD(lr=0.1, momentum=0.9), mt_ops.SGD_KERNEL),
                        (FusedLARS(lr=0.1), mt_ops.LARS_KERNEL),
                        (LARC(FusedSGD(lr=0.1, momentum=0.9)),
                         mt_ops.SGD_KERNEL)):
        state = opt.init(params)
        g = torch.randn_like(state.master)
        before = _build.launch_counts().get(kernel, 0)
        _, state = opt.step_flat(state, g)
        _, state = opt.step_flat(state, g, skip_if_nonfinite=True)
        torch.cuda.synchronize()
        assert _build.launch_counts()[kernel] == before + 2
        assert state.count == 2 and float(state.slots["initialized"]) == 1.0
        bad = g.clone()
        bad[3] = float("inf")
        master = state.master.clone()
        _, state = opt.step_flat(state, bad, skip_if_nonfinite=True)
        assert state.count == 2 and torch.equal(state.master, master)


# -- the scale, axpby, Adagrad and NovoGrad kernels ---------------------------
#
# Tolerances: bitwise against the plain versions (every operation and
# cast rounded on its own in the plain version's order), NovoGrad given
# the same denominators. A whole NovoGrad update computes its per-leaf
# norms from the sum-of-squares kernel's partials, summed in another
# order than the plain norms: v' within 1e-6 relative, m' within 1e-6 of
# its terms (|b1 m| + |m'| + |wd p|) plus one ulp, p' within lr times
# that plus one ulp of the larger of |p| and |p'|.

SCALE_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _same_bits(a, b) -> bool:
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def _launches(kernel):
    return _build.launch_counts().get(kernel, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 517, 3 * 2048 + 517, 1 << 20])
@pytest.mark.parametrize("out_dtype", SCALE_DTYPES)
@pytest.mark.parametrize("in_dtype", SCALE_DTYPES)
def test_scale_kernel_bitwise_equals_plain(cuda_device, in_dtype, out_dtype,
                                           n):
    rng = np.random.RandomState(n % 991)
    x = _rand(rng, n, cuda_device, 3.0).to(in_dtype)
    for scale in (0.37, torch.full((), 0.37, device=cuda_device)):
        want = mt_ops.multi_tensor_scale(x, scale, out_dtype=out_dtype,
                                         plain=True)
        before = _launches(mt_ops.SCALE_KERNEL)
        got = mt_ops.multi_tensor_scale(x, scale, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert _launches(mt_ops.SCALE_KERNEL) == before + 1
        assert _same_bits(got[0], want[0])
        assert float(got[1]) == float(want[1]) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["inf", "nan", "fp16_overflow",
                                  "bf16_in_inf"])
def test_scale_kernel_found_inf_over_outputs(cuda_device, case):
    n = 3 * 2048 + 517
    x = _rand(np.random.RandomState(31), n, cuda_device)
    out_dtype, scale = None, 0.5
    if case == "inf":
        x[n - 1] = float("inf")
    elif case == "nan":
        x[1234] = float("nan")
    elif case == "fp16_overflow":            # finite in, inf after the cast
        x[77] = 3e4
        out_dtype, scale = torch.float16, 4.0
    else:
        x = x.to(torch.bfloat16)
        x[5] = float("-inf")
    want = mt_ops.multi_tensor_scale(x, scale, out_dtype=out_dtype,
                                     plain=True)
    got = mt_ops.multi_tensor_scale(x, scale, out_dtype=out_dtype)
    assert float(got[1]) == float(want[1]) == 1.0
    assert _same_bits(got[0], want[0])


@pytest.mark.cuda
def test_scale_kernel_in_place(cuda_device):
    x = _rand(np.random.RandomState(32), 70001, cuda_device)
    want = mt_ops.multi_tensor_scale(x, 2.0 ** -7, plain=True)[0]
    got, found = mt_ops.multi_tensor_scale(x, 2.0 ** -7, in_place=True)
    assert got is x and float(found) == 0.0 and _same_bits(x, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 517, 3 * 2048 + 517, 1 << 20])
@pytest.mark.parametrize("out_dtype", SCALE_DTYPES)
@pytest.mark.parametrize("xy", ["fp32_fp32", "bf16_fp32", "bf16_bf16"])
def test_axpby_kernel_bitwise_equals_plain(cuda_device, xy, out_dtype, n):
    rng = np.random.RandomState(n % 983)
    dts = {"fp32": torch.float32, "bf16": torch.bfloat16}
    x, y = (_rand(rng, n, cuda_device).to(dts[d]) for d in xy.split("_"))
    for a, b in ((2.0, -3.0), (torch.full((), 0.5, device=cuda_device),
                               torch.full((), 1.5, device=cuda_device))):
        want = mt_ops.multi_tensor_axpby(x, y, a, b, out_dtype=out_dtype,
                                         plain=True)
        before = _launches(mt_ops.AXPBY_KERNEL)
        got = mt_ops.multi_tensor_axpby(x, y, a, b, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert _launches(mt_ops.AXPBY_KERNEL) == before + 1
        assert _same_bits(got[0], want[0])
        assert float(got[1]) == float(want[1]) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("bad", [float("inf"), float("nan")])
@pytest.mark.parametrize("arg_to_check,bad_x,expect", [
    (-1, True, 1.0), (-1, False, 1.0), (0, True, 1.0),
    (0, False, 0.0), (1, False, 1.0), (1, True, 0.0),
])
def test_axpby_kernel_arg_to_check(cuda_device, arg_to_check, bad_x, expect,
                                   bad):
    rng = np.random.RandomState(33)
    n = 3 * 2048 + 517
    x, y = _rand(rng, n, cuda_device), _rand(rng, n, cuda_device)
    (x if bad_x else y)[n - 2] = bad
    got = mt_ops.multi_tensor_axpby(x, y, 1.0, 1.0,
                                    arg_to_check=arg_to_check)
    want = mt_ops.multi_tensor_axpby(x, y, 1.0, 1.0,
                                     arg_to_check=arg_to_check, plain=True)
    assert float(got[1]) == float(want[1]) == expect


ADAGRAD_FLAGS = {
    "plain": dict(),
    "weight_decay": dict(weight_decay=0.01),
    "grad_scale": dict(grad_scale=65536.0, weight_decay=0.01),
    "device_scale": dict(grad_scale="device", weight_decay=0.01),
}


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 517, 3 * 2048 + 517, 1 << 20])
@pytest.mark.parametrize("case", sorted(ADAGRAD_FLAGS))
def test_adagrad_kernel_bitwise_equals_plain(cuda_device, n, case):
    rng = np.random.RandomState(n % 977)
    p, g = _rand(rng, n, cuda_device), _rand(rng, n, cuda_device)
    h = _rand(rng, n, cuda_device, positive=True)
    kw = {"lr": 1e-3, "eps": 1e-10, **ADAGRAD_FLAGS[case]}
    if kw.get("grad_scale") == "device":
        kw["grad_scale"] = torch.full((), 3.0 * 2 ** 15, device=cuda_device)
    want = mt_ops.fused_adagrad_update(p.clone(), h.clone(), g, plain=True,
                                       **kw)
    before = _launches(mt_ops.ADAGRAD_KERNEL)
    got = mt_ops.fused_adagrad_update(p, h, g, **kw)
    torch.cuda.synchronize()
    assert _launches(mt_ops.ADAGRAD_KERNEL) == before + 1
    assert got[0] is p and got[1] is h                      # in place
    assert _same_bits(got[0], want[0]) and _same_bits(got[1], want[1])
    assert float(got[2]) == float(want[2]) == 0.0


def _novograd_space():
    from apex_tpu_torch.multi_tensor import FlatSpace
    return FlatSpace.create({"a": torch.empty(70000), "b": torch.empty(7),
                             "c": torch.empty(3, 3000),
                             "z": torch.empty(9)})


@pytest.mark.cuda
@pytest.mark.parametrize("novograd", [False, True])
@pytest.mark.parametrize("bad", [float("inf"), float("nan")])
def test_adagrad_and_novograd_found_inf_and_out_of_place(cuda_device, bad,
                                                         novograd):
    space = _novograd_space()
    rng = np.random.RandomState(34)
    p, s, g = (_rand(rng, space.total, cuda_device, positive=True)
               for _ in range(3))
    v = torch.ones(space.num_leaves, device=cuda_device)
    g[4321] = bad
    saved = [p.clone(), s.clone(), v.clone()]
    if novograd:
        p2, s2, v2, found = mt_ops.fused_novograd_update(
            p, s, v, g, space, lr=1e-2, step=2, in_place=False)
        assert torch.equal(v, saved[2]) and v2.data_ptr() != v.data_ptr()
    else:
        p2, s2, found = mt_ops.fused_adagrad_update(p, s, g, lr=1e-2,
                                                    in_place=False)
    torch.cuda.synchronize()
    assert float(found) == 1.0
    assert torch.equal(p, saved[0]) and torch.equal(s, saved[1])
    assert p2.data_ptr() != p.data_ptr() and s2.data_ptr() != s.data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [517, 3 * 2048 + 517, 70000])
@pytest.mark.parametrize("grad_averaging", [True, False])
@pytest.mark.parametrize("bc1", [1.0, 0.05])
def test_novograd_kernel_bitwise_equals_plain_given_denominators(
        cuda_device, n, grad_averaging, bc1):
    rng = np.random.RandomState(n)
    p, m, g = (_rand(rng, n, cuda_device) for _ in range(3))
    n_sub = -(-n // 2048)
    ids = torch.from_numpy((np.arange(n_sub) % 3).astype(np.int32)).to(
        cuda_device)
    denom = torch.tensor([0.5, 12.3, 1e-3], device=cuda_device)
    kw = dict(lr=1e-2, beta1=0.95, beta3=0.05 if grad_averaging else 1.0,
              weight_decay=1e-3, bc1=bc1, tile_ids=ids)
    want = mt_ops.novograd_apply(p.clone(), m.clone(), g, denom, plain=True,
                                 **kw)
    before = _launches(mt_ops.NOVOGRAD_KERNEL)
    got = mt_ops.novograd_apply(p, m, g, denom, **kw)
    torch.cuda.synchronize()
    assert _launches(mt_ops.NOVOGRAD_KERNEL) == before + 1
    assert got[0] is p and got[1] is m
    assert _same_bits(got[0], want[0]) and _same_bits(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("step", [1, 2])
def test_fused_novograd_update_on_card_matches_plain(cuda_device, step):
    space = _novograd_space()
    rng = np.random.RandomState(35)
    p = torch.zeros(space.total, device=cuda_device)
    g = torch.zeros(space.total, device=cuda_device)
    for name, off, size in zip(space.names, space.offsets, space.sizes):
        if name != "z":                      # a zero leaf: g / eps
            p[off:off + size] = _rand(rng, size, cuda_device)
            g[off:off + size] = _rand(rng, size, cuda_device, 0.01)
    m = _rand(rng, space.total, cuda_device, 0.01)
    v = torch.rand(space.num_leaves, device=cuda_device)
    kw = dict(lr=1e-2, beta1=0.95, beta2=0.98, weight_decay=1e-3, step=step,
              bias_correction=True)
    want = mt_ops.fused_novograd_update(p.clone(), m.clone(), v.clone(), g,
                                        space, plain=True, **kw)
    counts = _build.launch_counts()
    got = mt_ops.fused_novograd_update(p.clone(), m.clone(), v.clone(), g,
                                       space, **kw)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    from apex_tpu_torch.multi_tensor import engine
    assert after[mt_ops.NOVOGRAD_KERNEL] == counts.get(
        mt_ops.NOVOGRAD_KERNEL, 0) + 1
    assert after[engine.SUMSQ_KERNEL] == counts.get(engine.SUMSQ_KERNEL,
                                                     0) + 1
    torch.testing.assert_close(got[2], want[2], rtol=1e-6, atol=0)
    tm = (0.95 * m).abs() + want[1].abs() + (1e-3 * p).abs()
    ulp_m = torch.nextafter(want[1].abs(), torch.full_like(m, float("inf"))) \
        - want[1].abs()
    assert ((got[1] - want[1]).abs() <= 1e-6 * tm + ulp_m).all()
    bc1 = 1.0 - 0.95 ** step
    tp = torch.maximum(p.abs(), want[0].abs())
    ulp_p = torch.nextafter(tp, torch.full_like(tp, float("inf"))) - tp
    assert ((got[0] - want[0]).abs()
            <= 1e-2 / bc1 * (1e-6 * tm + ulp_m) + ulp_p).all()


@pytest.mark.cuda
def test_novograd_adagrad_and_clip_launch_their_kernels(cuda_device):
    from apex_tpu_torch.contrib.clip_grad import clip_grad_norm_
    from apex_tpu_torch.multi_tensor import engine
    from apex_tpu_torch.optimizers import (FusedAdagrad, FusedNovoGrad,
                                           make_train_step)
    from apex_tpu_torch.amp import LossScaler
    params = {"w": torch.randn(300, 7, device=cuda_device),
              "b": torch.randn(7, device=cuda_device)}
    opt = FusedNovoGrad(lr=1e-2)
    state = opt.init(params)
    g = torch.randn_like(state.master)
    before = _build.launch_counts()
    clip_grad_norm_(g, 1.0)
    _, state = opt.step_flat(state, g)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    for k, n in ((engine.SUMSQ_KERNEL, 2), (mt_ops.SCALE_KERNEL, 1),
                 (mt_ops.NOVOGRAD_KERNEL, 1)):
        assert after[k] == before.get(k, 0) + n, k
    assert state.count == 1 and state.slots["v"].shape == (2,)
    opt = FusedAdagrad(lr=1e-3, weight_decay=0.01)
    tstep = make_train_step(opt, scaler=LossScaler(), max_grad_norm=1.0)
    state, ss = opt.init(params), tstep.scaler.init()
    before = _build.launch_counts()
    state, ss, aux = tstep(state, g * ss.loss_scale, ss)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    for k in (engine.SUMSQ_SCALED_KERNEL, mt_ops.ADAGRAD_KERNEL):
        assert after[k] == before.get(k, 0) + 1, k
    bad = g.clone()
    bad[3] = float("inf")
    master, h = state.master.clone(), state.slots["h"].clone()
    state2, ss2, aux = tstep(state, bad, ss)
    assert float(aux.found_inf) == 1.0 and state2.count == 1
    assert torch.equal(state2.master, master)
    assert torch.equal(state2.slots["h"], h)
    assert ss2.loss_scale == ss.loss_scale / 2


# -- the cross-entropy and RoPE kernels ---------------------------------------
#
# Tolerances: the xentropy forward's loss and lse within 1e-5 of
# max(1, |value|) (fp32 logsumexp and mean summed in another order: an
# online max and rescaled sum per thread, combined across the block); the
# backward bitwise given the same lse (every operation rounded on its own
# in the plain version's order, `expf`), padding rows (g = 0) exactly 0.
# RoPE bitwise for every dtype, layout and the -sin flag (products and
# sums rounded on their own, in the plain version's order).

XENT_TOL = 1e-5
XENT_CASES = [(16, 50304), (37, 131), (64, 1000), (8, 32128), (5, 3)]


def _xent_inputs(rows, k, dev, dtype, seed):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((3 * rng.randn(rows, k)).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, k, rows).astype(np.int32))
    g = torch.from_numpy(rng.randn(rows).astype(np.float32))
    g[::3] = 0.0                                 # padding rows
    return x.to(dev, dtype), y.to(dev), g.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape", XENT_CASES)
def test_xentropy_kernels_match_plain(cuda_device, shape, dtype, smoothing):
    from apex_tpu_torch.ops import xentropy
    x, y, g = _xent_inputs(*shape, cuda_device, dtype, seed=11)
    before = _build.launch_counts()
    loss, lse = xentropy._fwd_cuda(x, y, smoothing)
    want_loss, want_lse = xentropy._fwd_torch(x, y, smoothing)
    dx = xentropy._bwd_cuda(x, y, want_lse, g, smoothing)
    want_dx = xentropy._bwd_torch(x, y, want_lse, g, smoothing)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    for k in (xentropy.FWD_KERNEL, xentropy.BWD_KERNEL):
        assert after[k] == before.get(k, 0) + 1, k
    for got, want in ((loss, want_loss), (lse, want_lse)):
        assert bool(((got - want).abs()
                     <= XENT_TOL * want.abs().clamp_min(1.0)).all())
    assert dx.dtype == dtype
    assert torch.equal(dx.view(torch.int16 if dtype != torch.float32
                               else torch.int32),
                       want_dx.view(torch.int16 if dtype != torch.float32
                                    else torch.int32))
    assert bool((dx[::3] == 0).all())


@pytest.mark.cuda
def test_xentropy_kernel_out_of_range_labels(cuda_device):
    from apex_tpu_torch.ops import xentropy
    x, _, g = _xent_inputs(4, 40, cuda_device, torch.float32, seed=12)
    y = torch.tensor([-1, 40, -100, 3], dtype=torch.int32,
                     device=cuda_device)
    loss, lse = xentropy._fwd_cuda(x, y, 0.1)
    want_loss, want_lse = xentropy._fwd_torch(x, y, 0.1)
    dx = xentropy._bwd_cuda(x, y, want_lse, g, 0.1)
    assert bool(((loss - want_loss).abs() <= XENT_TOL * 10).all())
    assert torch.equal(dx, xentropy._bwd_torch(x, y, want_lse, g, 0.1))


@pytest.mark.cuda
def test_xentropy_autograd_runs_both_kernels(cuda_device):
    from apex_tpu_torch.contrib.xentropy import softmax_cross_entropy
    from apex_tpu_torch.ops import xentropy
    x, y, _ = _xent_inputs(2 * 33, 517, cuda_device, torch.bfloat16,
                           seed=13)
    x = x.reshape(2, 33, 517).requires_grad_()
    y = y.reshape(2, 33).long()
    y[:, 30:] = 0
    before = _build.launch_counts()
    with torch.no_grad():
        softmax_cross_entropy(x, y, 0.1)
    mid = _build.launch_counts()
    assert mid[xentropy.FWD_KERNEL] == before.get(xentropy.FWD_KERNEL, 0) + 1
    assert mid.get(xentropy.BWD_KERNEL, 0) == before.get(
        xentropy.BWD_KERNEL, 0)
    softmax_cross_entropy(x, y, 0.1).sum().backward()
    torch.cuda.synchronize()
    after = _build.launch_counts()
    for k in (xentropy.FWD_KERNEL, xentropy.BWD_KERNEL):
        assert after[k] == mid.get(k, 0) + 1, k
    assert bool((x.grad[:, 30:] == 0).all())
    assert bool(torch.isfinite(x.grad.float()).all())


@pytest.mark.cuda
def test_xentropy_kernel_refuses_other_inputs(cuda_device):
    from apex_tpu_torch.ops import softmax_cross_entropy_loss
    y = torch.zeros(4, dtype=torch.long, device=cuda_device)
    with pytest.raises(TypeError):
        softmax_cross_entropy_loss(
            torch.zeros(4, 8, device=cuda_device, dtype=torch.float64), y)
    with pytest.raises(ValueError, match="contiguous"):
        softmax_cross_entropy_loss(
            torch.zeros(8, 4, device=cuda_device).t(), y)


ROPE_CASES = {
    # name: (t shape, rot, thd lengths or None)
    "sbhd_full": ((33, 2, 4, 128), 128, None),
    "sbhd_partial": ((17, 3, 2, 64), 32, None),
    "neox_rot24": ((9, 2, 3, 96), 24, None),
    "odd_pairs": ((5, 2, 2, 22), 6, None),
    "thd": ((40, 4, 128), 128, (7, 1, 20, 12)),
    "thd_partial": ((40, 3, 96), 24, (13, 27)),
}


def _rope_inputs(case, dev, dtype, seed=14):
    shape, rot, lens = ROPE_CASES[case]
    rng = np.random.RandomState(seed)
    t = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dev, dtype)
    s_max = shape[0] if lens is None else max(lens) + 3
    freqs = torch.from_numpy(
        (3 * rng.randn(s_max, 1, 1, rot)).astype(np.float32)).to(dev)
    cu = None if lens is None else torch.tensor(
        np.concatenate([[0], np.cumsum(lens)]), dtype=torch.int32,
        device=dev)
    return t, freqs, cu


@pytest.mark.cuda
@pytest.mark.parametrize("negate", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("case", sorted(ROPE_CASES))
def test_rope_kernel_bitwise_equals_plain(cuda_device, case, dtype, negate):
    from apex_tpu_torch.ops import rope
    t, freqs, cu = _rope_inputs(case, cuda_device, dtype)
    tab = freqs.reshape(freqs.shape[0], -1)
    cos, sin = torch.cos(tab), torch.sin(tab)
    before = _build.launch_counts().get(rope.KERNEL, 0)
    if cu is None:
        got = rope._rope_cuda(t, cos[:, None, None], sin[:, None, None],
                              None, negate)
        c, s = cos[:, None, None], sin[:, None, None]
    else:
        got = rope._rope_cuda(t, cos, sin, cu, negate)
        pos = rope._thd_positions(cu, t.shape[0], tab.shape[0])
        c, s = cos[pos][:, None], sin[pos][:, None]
    want = rope._apply_torch(t, c, -s if negate else s)
    torch.cuda.synchronize()
    assert _build.launch_counts()[rope.KERNEL] == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_rope_autograd_runs_the_kernel_both_ways(cuda_device):
    from apex_tpu_torch.ops import rope
    from apex_tpu_torch.transformer.functional import (
        fused_apply_rotary_pos_emb, fused_apply_rotary_pos_emb_thd)
    t, freqs, _ = _rope_inputs("sbhd_partial", cuda_device, torch.bfloat16)
    t.requires_grad_()
    before = _build.launch_counts().get(rope.KERNEL, 0)
    fused_apply_rotary_pos_emb(t, freqs).float().sum().backward()
    torch.cuda.synchronize()
    assert _build.launch_counts()[rope.KERNEL] == before + 2
    want = rope._apply_torch(torch.ones_like(t), torch.cos(freqs),
                             -torch.sin(freqs))
    assert torch.equal(t.grad, want)
    t, freqs, cu = _rope_inputs("thd", cuda_device, torch.float32)
    t.requires_grad_()
    out = fused_apply_rotary_pos_emb_thd(t, cu, freqs)
    out.sum().backward()
    t_cpu = t.detach().cpu().requires_grad_()
    want = fused_apply_rotary_pos_emb_thd(t_cpu, cu.cpu(), freqs.cpu())
    want.sum().backward()
    # the card's cos/sin against the CPU's: an ulp apart at most
    torch.testing.assert_close(out.cpu(), want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(t.grad.cpu(), t_cpu.grad, rtol=1e-6,
                               atol=1e-6)


@pytest.mark.cuda
def test_rope_kernel_refuses_other_inputs(cuda_device):
    from apex_tpu_torch.transformer.functional import (
        fused_apply_rotary_pos_emb, fused_apply_rotary_pos_emb_cached)
    t = torch.zeros(4, 2, 2, 8, device=cuda_device)
    with pytest.raises(ValueError):            # odd rotated width
        fused_apply_rotary_pos_emb(t, torch.zeros(4, 1, 1, 7,
                                                  device=cuda_device))
    with pytest.raises(ValueError):            # wider than the head
        fused_apply_rotary_pos_emb(t, torch.zeros(4, 1, 1, 10,
                                                  device=cuda_device))
    with pytest.raises(ValueError):            # not contiguous
        fused_apply_rotary_pos_emb(t.transpose(1, 2),
                                   torch.zeros(4, 1, 1, 8,
                                               device=cuda_device))
    cos = torch.zeros(4, 2, 1, 8, device=cuda_device)
    with pytest.raises(ValueError):            # varies along the batch
        fused_apply_rotary_pos_emb_cached(t, cos, cos)
    with pytest.raises(TypeError):
        fused_apply_rotary_pos_emb(t.double(), torch.zeros(
            4, 1, 1, 8, device=cuda_device))
