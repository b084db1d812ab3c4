"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

Every test here needs a CUDA device and skips without one (a CUDA
kernel has no CPU mode; the plain versions are held against apex_tpu on
the CPU by test_torch_layer_norm.py, test_torch_attention.py and their
_bwd counterparts, test_torch_adam.py, test_torch_softmax.py,
test_torch_sgd.py, test_torch_scale_axpby.py,
test_torch_novograd_adagrad.py, test_torch_xentropy.py,
test_torch_rope.py, test_torch_attention_bias.py and
test_torch_multihead_attn.py). This
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
tests). Cross entropy and RoPE: stated with their tests. Flash attention
with dropout: outputs within 2^-6 of each row's largest |value| (two
bf16 ulps: the kept probabilities and the outputs grow by 1 / (1 -
rate), so an absolute bound would not keep up with them), the lse and
the gradients as above, and its keep mask bitwise (read off
an output: q = 0 makes the probabilities uniform, V the identity puts
key j's weight in column j). With a bias, global positions or an lse
cotangent: outputs, lse and gradients as with dropout, dbias (recomputed
in PyTorch from the kernels' lse) within 2^-6 of its largest |value|
against autograd through the plain forward, the masks bitwise; rows
with no live key exactly 0. One multi-head attention layer (bf16,
dropout and an additive key-padding mask) on the kernels against its
plain path: the output within 2e-2 absolute, each gradient within 2e-2
in relative L2 norm (bf16 projections and LayerNorm on both sides; the
attention rounds P and dS to bf16 on one). Dropout (``csrc/dropout.cu``): output and
gradient bitwise. Stochastic rounding (a bf16 master): stated with its
tests. The fp32 backward (wgmma, exact three-part products): dq, dk and
dv within 1e-5 of each one's largest |value| (fp32 sums in other
orders); its split pass bitwise. The fp32 forward (the same design): the
output within 1e-5 of its largest |value|, the lse within 1e-5. The
LayerNorm forward's streamed rows: as above, fp16 within one fp16 ulp
(2^-10 of the value) plus 1e-5, and a repeated call bitwise.
"""

import numpy as np
import pytest
import torch

from apex_tpu_torch import _build
from apex_tpu_torch.multi_tensor import fused_adam_update, ops as mt_ops
from apex_tpu_torch.ops import attention, layer_norm
from apex_tpu_torch.ops import dropout as dropout_op


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
@pytest.mark.parametrize("rows", [5, 8192, 8199])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_layer_norm_streamed_rows_match_plain_and_repeat(cuda_device, dtype,
                                                          rows):
    """The forward's warps walk rows at a stride of the resident grid: 5
    rows (fewer than one block's warps), 8192 (the training rows, past one
    row a resident warp) and 8199 (a ragged tail of the stride loop), at h
    1024, within the tolerances above; a repeated call is bitwise equal."""
    h = 1024
    rng = np.random.RandomState(rows)
    x = torch.from_numpy(rng.randn(rows, h).astype(np.float32) * 2 + 0.5)
    x = x.to(cuda_device, dtype)
    w = torch.from_numpy(1 + 0.1 * rng.randn(h).astype(np.float32)).cuda()
    b = torch.from_numpy(0.1 * rng.randn(h).astype(np.float32)).cuda()
    with torch.no_grad():
        got = layer_norm._fwd_cuda(x, w, b, 1e-5, False)
        again = layer_norm._fwd_cuda(x, w, b, 1e-5, False)
        py, pmean, prstd = layer_norm._fwd_torch(x, w, b, 1e-5, False)
    torch.cuda.synchronize()
    for a_, b_ in zip(got, again):
        assert torch.equal(a_, b_)
    y, mean, rstd = got
    torch.testing.assert_close(mean, pmean, rtol=0, atol=1e-5)
    torch.testing.assert_close(rstd, prstd, rtol=1e-5, atol=0)
    if dtype == torch.float32:
        torch.testing.assert_close(y, py, rtol=0, atol=1e-5)
    else:
        # one ulp of the value (bf16 2^-7, fp16 2^-10) plus 1e-5 near zero
        ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -10
        diff = (y.float() - py.float()).abs()
        assert (diff <= ulp * py.float().abs() + 1e-5).all()


@pytest.mark.cuda
@pytest.mark.parametrize("norm", ["layer", "layer_no_affine", "rms"])
@pytest.mark.parametrize("rows", [5, 8192, 8199])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_layer_norm_bwd_streamed_rows_match_plain_and_repeat(
        cuda_device, dtype, rows, norm):
    """The backward's warps stream rows through their shared-memory rings
    at a stride of the resident grid: 5 rows (fewer than one block's
    warps), 8192 (the training rows) and 8199 (a ragged tail of the
    stride loop), at h 1024, with and without gamma, LayerNorm and
    RMSNorm. dx, dw and db (summed by the library's second kernel) within
    the tolerances above, dw and db tensors of their own, a repeated call
    bitwise equal, one launch counted a call."""
    h = 1024
    rng = np.random.RandomState(rows + 3)
    x = torch.from_numpy(rng.randn(rows, h).astype(np.float32) * 2 + 0.5)
    x = x.to(cuda_device, dtype)
    g = torch.from_numpy(rng.randn(rows, h).astype(np.float32)).to(
        cuda_device, dtype)
    w = None if norm == "layer_no_affine" else torch.from_numpy(
        1 + 0.1 * rng.randn(h).astype(np.float32)).cuda()
    rms = norm == "rms"
    _, mean, rstd = layer_norm._fwd_torch(x, w, None, 1e-5, rms)
    name = layer_norm.kernel_name(layer_norm.BWD_KERNEL, dtype)
    before = _build.launch_counts().get(name, 0)
    got = layer_norm._bwd_cuda(x, w, mean, rstd, g, rms)
    again = layer_norm._bwd_cuda(x, w, mean, rstd, g, rms)
    torch.cuda.synchronize()
    assert _build.launch_counts()[name] == before + 2
    for a_, b_ in zip(got, again):
        assert torch.equal(a_, b_)
    dx, dw, db = got
    pdx, pdw, pdb = layer_norm._bwd_torch(x, w, mean, rstd, g, rms)
    assert dx.dtype == dtype and dw.dtype == db.dtype == torch.float32
    assert (dw.untyped_storage().data_ptr()
            != db.untyped_storage().data_ptr())
    if dtype == torch.float32:
        torch.testing.assert_close(dx, pdx, rtol=0, atol=1e-5)
    else:
        ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -10
        diff = (dx.float() - pdx.float()).abs()
        assert (diff <= ulp * pdx.float().abs() + 1e-5).all()
    for got_, want in ((dw, pdw), (db, pdb)):
        torch.testing.assert_close(
            got_, want, rtol=0, atol=1e-5 * float(want.abs().max()))


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
    # bias and positions have kernels, and so (since fp16 and fp32 were
    # ported and head widths pad to the built ones) do fp32 and fp16 q/k/v,
    # head_dim 48 and an fp16 bias: each launches its dtype's kernel. What
    # is still refused: a head_dim past 128 in fp32, past 256 in bf16 and
    # fp16, and integer inputs.
    q = torch.zeros(1, 2, 8, 64, device=cuda_device, dtype=torch.bfloat16)
    before = _build.launch_counts()
    attention.flash_attention(
        q, q, q, bias=torch.zeros(1, 1, 8, 8, device=cuda_device))
    pos = torch.arange(8, device=cuda_device)
    attention.flash_attention(q, q, q, causal=True, q_positions=pos,
                              kv_positions=pos)
    z = torch.zeros(1, 2, 8, 48, device=cuda_device, dtype=torch.bfloat16)
    attention.flash_attention(z, z, z)
    attention.flash_attention(q, q, q, bias=torch.zeros(
        1, 1, 8, 8, device=cuda_device, dtype=torch.float16))
    after = _build.launch_counts()
    assert after[attention.KERNEL] == before.get(attention.KERNEL, 0) + 4
    for dtype in (torch.float32, torch.float16):
        name = attention.kernel_name(attention.KERNEL, dtype)
        n0 = _build.launch_counts().get(name, 0)
        out = attention.flash_attention(q.to(dtype), q.to(dtype),
                                        q.to(dtype))
        assert out.dtype == dtype
        assert _build.launch_counts()[name] == n0 + 1
    with pytest.raises(NotImplementedError, match="head_dim 160 in fp32"):
        w = torch.zeros(1, 2, 8, 160, device=cuda_device,
                        dtype=torch.float32)
        attention.flash_attention(w, w, w)
    with pytest.raises(NotImplementedError, match="head_dim"):
        w = torch.zeros(1, 2, 8, 272, device=cuda_device,
                        dtype=torch.bfloat16)
        attention.flash_attention(w, w, w)
    with pytest.raises(TypeError, match="dtype"):
        i = torch.zeros(1, 2, 8, 64, device=cuda_device, dtype=torch.int32)
        attention.flash_attention(i, i, i)


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


# The bf16/fp16 backward (wgmma, TMA; csrc/flash_bwd_sm90.cuh) over its
# options: name -> keyword arguments of _sm90_case
SM90_OPTIONS = {
    "causal": dict(),
    "window": dict(window=37),
    "noncausal_segments": dict(causal=False, segments=True),
    "bias": dict(bias="full"),
    "positions_glse": dict(positions=True, glse=True),
    "dropout": dict(rate=0.1),
    "all": dict(segments=True, bias="keys", glse=True, rate=0.1),
}
SM90_TOLS = {torch.bfloat16: 2.0 ** -6, torch.float16: 2.0 ** -9}


def _sm90_case(dev, dtype, d, *, causal=True, window=None, segments=False,
               bias=None, positions=False, glse=False, rate=0.0, seed=3):
    """Backward arguments at a ragged GQA shape (b 2, h 4 over hk 2, sq 150,
    sk 200), the lse from the plain forward."""
    b, h, hk, sq, sk = 2, 4, 2, 150, 200
    if positions:
        sq = sk = 192
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(*shape).astype(
        np.float32)).to(dev, dtype) for shape in (
        (b, h, sq, d), (b, hk, sk, d), (b, hk, sk, d), (b, h, sq, d)))
    q_seg = k_seg = None
    if segments:
        q_seg = torch.from_numpy(np.sort(rng.randint(0, 3, (b, sq)), -1)
                                 .astype(np.int32)).to(dev)
        k_seg = torch.from_numpy(np.sort(rng.randint(0, 3, (b, sk)), -1)
                                 .astype(np.int32)).to(dev)
        if segments == "keys":
            # key-side segments only: every query in segment 0
            q_seg = torch.zeros_like(q_seg)
    bt = None
    if bias == "full":
        bt = torch.from_numpy(rng.randn(b, h, sq, sk).astype(
            np.float32)).to(dev)
    elif bias == "keys":
        bt = torch.from_numpy(2 * rng.randn(b, 1, 1, sk).astype(
            np.float32)).to(dev, torch.bfloat16)
    q_pos = k_pos = None
    if positions:
        q_pos = torch.from_numpy(np.sort(rng.permutation(2 * sq)[:sq])
                                 .astype(np.int32)).to(dev)
        k_pos = torch.from_numpy(np.sort(rng.permutation(2 * sk)[:sk])
                                 .astype(np.int32)).to(dev)
    seed_ = 1234 if rate > 0 else None
    scale = d ** -0.5
    out, lse = attention._attention_torch(
        q, k, v, bt, q_seg, k_seg, scale, causal, window, rate, seed_,
        return_lse=True, q_pos=q_pos, k_pos=k_pos)
    delta = (out.float() * do.float()).sum(-1)
    gl = (torch.from_numpy(rng.randn(b, h, sq).astype(np.float32)).to(dev)
          if glse else None)
    args = (q, k, v, lse, do, delta, q_seg, k_seg, scale, causal, window,
            rate, seed_)
    return args, dict(bias=bt, glse=gl, q_pos=q_pos, k_pos=k_pos)


@pytest.mark.cuda
@pytest.mark.parametrize("opt", sorted(SM90_OPTIONS))
@pytest.mark.parametrize("d", [32, 40, 64, 96, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_sm90_flash_bwd_matches_plain(cuda_device, dtype, d, opt):
    args, kw = _sm90_case(cuda_device, dtype, d, **SM90_OPTIONS[opt])
    names = [attention.kernel_name(k_, dtype) for k_ in (
        attention.BWD_DQ_KERNEL, attention.BWD_DKV_KERNEL)]
    counts = _build.launch_counts()
    got = attention._flash_bwd_cuda(*args, **kw)
    want = attention._flash_bwd_torch(*args, **kw)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    for n_ in names:
        assert after[n_] == counts.get(n_, 0) + 1
    for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
        assert g_.dtype == dtype and g_.shape == w_.shape
        assert bool(torch.isfinite(g_.float()).all()), name
        scale_w = max(float(w_.float().abs().max()), 1e-6)
        err = float((g_.float() - w_.float()).abs().max())
        assert err <= SM90_TOLS[dtype] * scale_w, (name, err, scale_w)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_sm90_flash_bwd_repeats_bitwise(cuda_device, dtype, d):
    """No atomics: each output element is written once, so two calls on
    the same inputs give the same bits."""
    args, kw = _sm90_case(cuda_device, dtype, d, **SM90_OPTIONS["all"])
    first = attention._flash_bwd_cuda(*args, **kw)
    second = attention._flash_bwd_cuda(*args, **kw)
    torch.cuda.synchronize()
    for a_, b_ in zip(first, second):
        assert torch.equal(a_, b_)


# The fp32 backward (wgmma, TMA, exact three-part products;
# csrc/flash_bwd32_sm90.cuh) over its options, at _sm90_case's ragged GQA
# shape, plus the short sequences that take one dq warpgroup a block (64
# tokens with a key-padding bias: the multi-head attention stacks; one
# decoded query over key segments). Within 1e-5 of each gradient's largest
# |value|: exact products, fp32 sums in other orders.
FP32_SM90_OPTIONS = dict(SM90_OPTIONS, **{
    "key_segments_window": dict(segments="keys", window=70),
    "positions_window_glse": dict(positions=True, window=50, glse=True),
})
FP32_SHORT = {"mha_bias": (2, 4, 4, 64, 64), "decode": (2, 4, 2, 1, 130),
              "short_causal": (1, 2, 1, 40, 40)}


def _fp32_short_case(dev, d, case, seed=5):
    b, h, hk, sq, sk = FP32_SHORT[case]
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(*shape).astype(
        np.float32)).to(dev) for shape in (
        (b, h, sq, d), (b, hk, sk, d), (b, hk, sk, d), (b, h, sq, d)))
    causal, bias, q_seg, k_seg = case == "short_causal", None, None, None
    if case == "mha_bias":
        bias = torch.where(torch.from_numpy(rng.rand(b, 1, 1, sk)) < 0.25,
                           -10000.0, 0.0).float().to(dev)
    if case == "decode":
        k_seg = torch.from_numpy((np.arange(sk)[None, :] >= np.array(
            [[100], [57]])).astype(np.int32)).to(dev)
        q_seg = torch.zeros((b, sq), dtype=torch.int32, device=dev)
    scale = d ** -0.5
    out, lse = attention._attention_torch(q, k, v, bias, q_seg, k_seg,
                                          scale, causal, return_lse=True)
    delta = (out * do).sum(-1)
    args = (q, k, v, lse, do, delta, q_seg, k_seg, scale, causal, None)
    return args, dict(bias=bias)


def _fp32_check(got, want):
    for name, g_, w_ in zip(("dq", "dk", "dv"), got, want):
        assert g_.dtype == torch.float32 and g_.shape == w_.shape
        assert bool(torch.isfinite(g_).all()), name
        scale_w = max(float(w_.abs().max()), 1e-6)
        err = float((g_ - w_).abs().max())
        assert err <= 1e-5 * scale_w, (name, err, scale_w)


def _fp32_counted(args, kw):
    names = [attention.kernel_name(k_, torch.float32) for k_ in (
        attention.BWD_DQ_KERNEL, attention.BWD_DKV_KERNEL)]
    names.append(attention.SPLIT_KERNEL)
    counts = _build.launch_counts()
    got = attention._flash_bwd_cuda(*args, **kw)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    for n_ in names:
        assert after[n_] == counts.get(n_, 0) + 1, n_
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("opt", sorted(FP32_SM90_OPTIONS))
@pytest.mark.parametrize("d", [16, 32, 40, 64, 96, 128])
def test_sm90_fp32_flash_bwd_matches_plain(cuda_device, d, opt):
    args, kw = _sm90_case(cuda_device, torch.float32, d,
                          **FP32_SM90_OPTIONS[opt])
    got = _fp32_counted(args, kw)
    _fp32_check(got, attention._flash_bwd_torch(*args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FP32_SHORT))
@pytest.mark.parametrize("d", [32, 64, 128])
def test_sm90_fp32_flash_bwd_short_sequences(cuda_device, d, case):
    args, kw = _fp32_short_case(cuda_device, d, case)
    got = _fp32_counted(args, kw)
    _fp32_check(got, attention._flash_bwd_torch(*args, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 64, 128])
def test_sm90_fp32_flash_bwd_repeats_bitwise(cuda_device, d):
    """No atomics: two calls on the same inputs give the same bits."""
    args, kw = _sm90_case(cuda_device, torch.float32, d,
                          **SM90_OPTIONS["all"])
    first = attention._flash_bwd_cuda(*args, **kw)
    second = attention._flash_bwd_cuda(*args, **kw)
    torch.cuda.synchronize()
    for a_, b_ in zip(first, second):
        assert torch.equal(a_, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 20, 64, 100, 128])
def test_split_kernel_bitwise_equals_plain(cuda_device, d):
    """The split pass: the planes of up to four tensors in one launch,
    bitwise the plain version's (normal values and subnormals, zeros)."""
    rng = np.random.RandomState(d)
    xs = [torch.from_numpy((rng.randn(2, 3, n, d) * np.exp(rng.uniform(
        -30, 30, (2, 3, n, d)))).astype(np.float32)).to(cuda_device)
        for n in (33, 70, 70, 33)]
    xs[1].view(-1)[:7] = torch.tensor(
        [0.0, -0.0, 1e-40, -3e-42, 2.0 ** -126, 1e-45, 3.0e38])
    width = attention.tma_width(d)
    before = _build.launch_counts().get(attention.SPLIT_KERNEL, 0)
    got = attention._split3_cuda(xs, width)
    torch.cuda.synchronize()
    assert _build.launch_counts()[attention.SPLIT_KERNEL] == before + 1
    for x, g_ in zip(xs, got):
        want = attention._split3_torch(x, width)
        assert g_.shape == want.shape and torch.equal(
            g_.view(torch.int16), want.view(torch.int16))


# The bf16/fp16 forward (wgmma, TMA; csrc/flash_fwd_sm90.cuh) over its
# options: name -> keyword arguments of _sm90_fwd_case. "short" (sq 50) and
# "decode" (sq 1, key-side segment ids) take the one-warpgroup blocks.
SM90_FWD_OPTIONS = {
    "causal": dict(),
    "window": dict(window=37),
    "noncausal_segments": dict(causal=False, segments=True),
    "bias_full": dict(bias="full"),
    "bias_keys": dict(causal=False, bias="keys"),
    "positions": dict(positions=True),
    "positions_window": dict(positions=True, window=70),
    "dropout": dict(rate=0.1),
    "all": dict(segments=True, bias="keys", rate=0.1),
    "short": dict(sq=50, bias="keys"),
    "decode": dict(causal=False, sq=1, key_segments=True),
    # more query tiles than the card runs blocks at once: each block walks
    # several (query tile, head) items
    "many_causal": dict(many=True),
    "many_window_segments_dropout": dict(many=True, window=200,
                                         segments=True, rate=0.1),
    "many_short_bias": dict(many=True, sq=50, causal=False, bias="keys"),
}


def _sm90_fwd_case(dev, dtype, d, *, sq=150, causal=True, window=None,
                   segments=False, key_segments=False, bias=None,
                   positions=False, rate=0.0, many=False, seed=5):
    """Forward arguments at a ragged GQA shape (b 2, h 4 over hk 2, sk 200,
    sq 150 unless given; 192 and 192 with positions; with ``many``, b 8, h
    32 over hk 16, sk 700 and sq 600): ``(args, kw)`` of
    ``_flash_cuda``."""
    b, h, hk, sk = (8, 32, 16, 700) if many else (2, 4, 2, 200)
    if many and sq == 150:
        sq = 600
    if positions:
        sq = sk = 192
    rng = np.random.RandomState(seed)
    q, k, v = (torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
        dev, dtype) for shape in ((b, h, sq, d), (b, hk, sk, d),
                                  (b, hk, sk, d)))
    q_seg = k_seg = None
    if segments:
        # queries of segment 3 find no key: rows of exactly 0
        q_seg, k_seg = (torch.from_numpy(np.sort(rng.randint(
            0, top, (b, n)), -1).astype(np.int32)).to(dev)
            for top, n in ((4, sq), (3, sk)))
    if key_segments:
        # the decode context mask: queries in segment 0, a ragged tail of
        # keys in segment 1
        k_seg = torch.from_numpy((np.arange(sk)[None, :] >= np.array(
            [[150], [61]])).astype(np.int32)).to(dev)
        q_seg = torch.zeros(b, sq, dtype=torch.int32, device=dev)
    bt = None
    if bias == "full":
        bt = torch.from_numpy(rng.randn(b, h, sq, sk).astype(
            np.float32)).to(dev)
    elif bias == "keys":
        # a key-padding bias, as the multi-head attention stacks pass it
        bt = torch.from_numpy(np.where(rng.rand(b, 1, 1, sk) < 0.25,
                                       -10000.0, 0.0).astype(
            np.float32)).to(dev, dtype)
    q_pos = k_pos = None
    if positions:
        q_pos, k_pos = (torch.from_numpy(np.sort(rng.permutation(2 * n)[:n])
                                         .astype(np.int32)).to(dev)
                        for n in (sq, sk))
    args = (q, k, v, q_seg, k_seg, d ** -0.5, causal, window, rate,
            1234 if rate > 0 else None)
    return args, dict(bias=bt, q_pos=q_pos, k_pos=k_pos)


# (dtype, head_dim) of the forward's cases: bf16 and fp16 to 256; fp32 (the
# exact three-part design, csrc/flash_fwd32_sm90.cuh) to 128, with widths
# whose rows are no multiple of 4 (33: single stores) or of 8 (20, 100)
SM90_FWD_WIDTHS = ([(dt, d) for dt in (torch.bfloat16, torch.float16)
                    for d in (32, 40, 64, 96, 128, 256)]
                   + [(torch.float32, d) for d in (20, 32, 33, 64, 96, 100,
                                                   128)])


@pytest.mark.cuda
@pytest.mark.parametrize("opt", sorted(SM90_FWD_OPTIONS))
@pytest.mark.parametrize("dtype,d", SM90_FWD_WIDTHS)
def test_sm90_flash_fwd_matches_plain(cuda_device, dtype, d, opt):
    """bf16 and fp16 within SM90_TOLS of each row's largest |value|, the
    lse within 1e-3; fp32 within 1e-5 of the output's largest |value| and
    the lse within 1e-5 (exact products, fp32 sums in other orders), its
    split pass launched once beside it."""
    args, kw = _sm90_fwd_case(cuda_device, dtype, d,
                              **SM90_FWD_OPTIONS[opt])
    names = [attention.kernel_name(attention.KERNEL, dtype)]
    if dtype == torch.float32:
        names.append(attention.SPLIT_KERNEL)
    before = _build.launch_counts()
    out, lse = attention._flash_cuda(*args, **kw)
    q, k, v, q_seg, k_seg, scale, causal, window, rate, seed = args
    pout, plse = attention._attention_torch(
        q, k, v, kw["bias"], q_seg, k_seg, scale, causal, window, rate,
        seed, return_lse=True, q_pos=kw["q_pos"], k_pos=kw["k_pos"])
    torch.cuda.synchronize()
    for n_ in names:
        assert _build.launch_counts()[n_] == before.get(n_, 0) + 1, n_
    assert out.dtype == dtype and out.shape == pout.shape
    assert bool(torch.isfinite(out.float()).all())
    live = plse > attention.NEG_INF * 0.5
    assert torch.equal(live, lse > attention.NEG_INF * 0.5)
    # rows with no live key: out exactly 0, lse NEG_INF
    assert (out[~live] == 0).all() and (lse[~live] == attention.NEG_INF).all()
    if dtype == torch.float32:
        err = float((out - pout).abs().max())
        assert err <= 1e-5 * float(pout.abs().max()), err
        torch.testing.assert_close(lse[live], plse[live], rtol=0, atol=1e-5)
    else:
        assert _row_rel_err(out, pout) <= SM90_TOLS[dtype]
        torch.testing.assert_close(lse[live], plse[live], rtol=0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("opt", ["all", "decode", "positions"])
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 64),
                                     (torch.bfloat16, 256),
                                     (torch.float16, 64),
                                     (torch.float16, 256),
                                     (torch.float32, 64),
                                     (torch.float32, 128)])
def test_sm90_flash_fwd_repeats_bitwise(cuda_device, dtype, d, opt):
    """No atomics: each output element is written once, so two calls on
    the same inputs give the same bits."""
    args, kw = _sm90_fwd_case(cuda_device, dtype, d,
                              **SM90_FWD_OPTIONS[opt])
    first = attention._flash_cuda(*args, **kw)
    second = attention._flash_cuda(*args, **kw)
    torch.cuda.synchronize()
    for a_, b_ in zip(first, second):
        assert torch.equal(a_, b_)


def _row_rel_err(got, want) -> float:
    """The largest |got - want| of each row over the row's largest
    |want|: with dropout the kept probabilities are 1 / (1 - rate) larger,
    and so are the outputs and their bf16 ulps."""
    diff = (got.float() - want.float()).abs()
    return float((diff / want.float().abs().amax(-1, keepdim=True)
                  .clamp_min(1e-6)).max())


def _flash_inputs(case, cuda_device, seed):
    b, h, hk, sq, sk, d, causal, window, segs = ATTENTION_CASES[case]
    rng = np.random.RandomState(seed)
    q, k, v, do = (torch.from_numpy(rng.randn(*shape).astype(
        np.float32)).to(cuda_device, torch.bfloat16) for shape in (
        (b, h, sq, d), (b, hk, sk, d), (b, hk, sk, d), (b, h, sq, d)))
    q_seg = k_seg = None
    if segs:
        k_seg = torch.from_numpy(
            (rng.rand(b, sk) < 0.2).astype(np.int32)).to(cuda_device)
        q_seg = torch.zeros(b, sq, dtype=torch.int32, device=cuda_device)
    return (q, k, v, do, q_seg, k_seg, d ** -0.5, causal, window)


@pytest.mark.cuda
@pytest.mark.parametrize("rate", [0.1, 0.4])
@pytest.mark.parametrize("case", sorted(ATTENTION_CASES))
def test_flash_kernel_with_dropout_matches_plain(cuda_device, case, rate):
    q, k, v, _, q_seg, k_seg, scale, causal, window = _flash_inputs(
        case, cuda_device, 11)
    seed = 0x9E3779B9
    before = _build.launch_counts().get(attention.KERNEL, 0)
    out, lse = attention._flash_cuda(q, k, v, q_seg, k_seg, scale, causal,
                                     window, rate, seed)
    pout, plse = attention._attention_torch(
        q, k, v, None, q_seg, k_seg, scale, causal, window, rate, seed,
        return_lse=True)
    torch.cuda.synchronize()
    assert _build.launch_counts()[attention.KERNEL] == before + 1
    assert _row_rel_err(out, pout) <= 2.0 ** -6
    # the normaliser sums the undropped probabilities
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ATTENTION_CASES))
def test_flash_bwd_kernels_with_dropout_match_plain(cuda_device, case):
    q, k, v, do, q_seg, k_seg, scale, causal, window = _flash_inputs(
        case, cuda_device, 13)
    rate, seed = 0.1, 12345
    out, lse = attention._flash_cuda(q, k, v, q_seg, k_seg, scale, causal,
                                     window, rate, seed)
    delta = (out.float() * do.float()).sum(-1)
    args = (q, k, v, lse, do, delta, q_seg, k_seg, scale, causal, window,
            rate, seed)
    got = attention._flash_bwd_cuda(*args)
    want = attention._flash_bwd_torch(*args)
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        scale_w = max(float(w.float().abs().max()), 1e-6)
        err = float((g.float() - w.float()).abs().max())
        assert err <= 2.0 ** -6 * scale_w, (name, err, scale_w)


@pytest.mark.cuda
@pytest.mark.parametrize("gqa", [False, True])
def test_flash_dropout_mask_is_the_plain_mask(cuda_device, gqa):
    b, h, sq, sk = 2, 4, 200, 64
    hk = 2 if gqa else h
    q = torch.zeros(b, h, sq, sk, dtype=torch.bfloat16, device=cuda_device)
    k = torch.randn(b, hk, sk, sk, device=cuda_device).to(torch.bfloat16)
    v = torch.eye(sk, device=cuda_device).to(torch.bfloat16).expand(
        b, hk, sk, sk).contiguous()
    rate, seed = 0.25, 7
    out, _ = attention._flash_cuda(q, k, v, None, None, 1.0, False, None,
                                   rate, seed)
    bh = torch.arange(b * h, device=cuda_device).reshape(b, h, 1, 1)
    row = torch.arange(sq, device=cuda_device).reshape(sq, 1)
    col = torch.arange(sk, device=cuda_device).reshape(1, sk)
    keep = attention._dropout_keep(seed, bh, row, col, rate)
    assert torch.equal(out != 0, keep)
    kept = out[keep].float()
    assert torch.equal(kept, torch.full_like(kept, float(torch.tensor(
        1.0 / sk / 0.75).to(torch.bfloat16))))
    # the dk/dv kernel hashes the q head of its GQA sweep: with dO the
    # identity over the same keys, dv row j sums the kept p of column j
    do = torch.eye(sq, sk, device=cuda_device).to(torch.bfloat16).expand(
        b, h, sq, sk).contiguous()
    lse = torch.full((b, h, sq), float(np.log(sk)), device=cuda_device)
    delta = torch.zeros(b, h, sq, device=cuda_device)
    args = (q, k, v, lse, do, delta, None, None, 1.0, False, None, rate,
            seed)
    got = attention._flash_bwd_cuda(*args)
    want = attention._flash_bwd_torch(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[2], want[2])


@pytest.mark.cuda
def test_flash_autograd_with_dropout_runs_the_kernels(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    q, k, v, do = (torch.randn(2, 4, 96, 64, device=cuda_device,
                               generator=gen).to(torch.bfloat16)
                   for _ in range(4))
    kw = dict(causal=True, dropout_rate=0.1,
              dropout_rng=torch.tensor([3, 4]))
    grads = []
    for fn in (attention.flash_attention, attention.attention_plain):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        counts = _build.launch_counts()
        out = fn(*leaves, **kw)
        out.backward(do)
        torch.cuda.synchronize()
        after = _build.launch_counts()
        for kname in (attention.KERNEL, attention.BWD_DQ_KERNEL,
                      attention.BWD_DKV_KERNEL):
            n = 1 if fn is attention.flash_attention else 0
            assert after.get(kname, 0) == counts.get(kname, 0) + n
        grads.append((out.detach(), [t.grad for t in leaves]))
    (out, got), (pout, want) = grads
    assert _row_rel_err(out, pout) <= 2.0 ** -6
    for g, w in zip(got, want):
        scale_w = max(float(w.float().abs().max()), 1e-6)
        assert float((g.float() - w.float()).abs().max()) <= \
            2.0 ** -6 * scale_w


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape", [(1,), (3,), (4097,), (8, 16, 64, 65),
                                   (1 << 20, 3)])
def test_dropout_kernel_bitwise_equals_plain(cuda_device, dtype, shape):
    x = (torch.randn(*shape, device=cuda_device) * 3).to(dtype)
    key = (0x12345678, 0x9ABCDEF0)
    before = _build.launch_counts().get(dropout_op.FWD_KERNEL, 0)
    got = dropout_op._dropout_cuda(x, key, 0.1)
    want = dropout_op._dropout_torch(x, key, 0.1)
    torch.cuda.synchronize()
    assert _build.launch_counts()[dropout_op.FWD_KERNEL] == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got.view(-1).view(torch.uint8),
                       want.view(-1).view(torch.uint8))
    if x.numel() > 100000:
        kept = float((got != 0).float().mean())
        assert abs(kept - 0.9) < 0.002


@pytest.mark.cuda
def test_dropout_autograd_runs_both_launches(cuda_device):
    x = torch.randn(64, 1000, device=cuda_device,
                    dtype=torch.bfloat16).requires_grad_()
    g = torch.randn(64, 1000, device=cuda_device, dtype=torch.bfloat16)
    counts = _build.launch_counts()
    y = dropout_op.dropout(x, 0.1, torch.tensor([5, 6]))
    y.backward(g)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    for kname in (dropout_op.FWD_KERNEL, dropout_op.BWD_KERNEL):
        assert after[kname] == counts.get(kname, 0) + 1
    assert torch.equal(x.grad, dropout_op._dropout_torch(g, (5, 6), 0.1))
    with pytest.raises(TypeError):
        dropout_op._dropout_cuda(x.detach().double(), (0, 1), 0.1)


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
    # a differentiated lse takes the same kernels (its cotangent as glse)
    q.grad = None
    counts = _build.launch_counts()
    out, lse = attention.flash_attention(q, q, q, causal=True,
                                         return_lse=True)
    (out.float().sum() + lse.sum()).backward()
    torch.cuda.synchronize()
    after = _build.launch_counts()
    for kname in (attention.KERNEL, attention.BWD_DQ_KERNEL,
                  attention.BWD_DKV_KERNEL):
        assert after[kname] == counts.get(kname, 0) + 1
    assert torch.isfinite(q.grad.float()).all()


BIAS_CLASSES = {
    "q_k": lambda b, h, sq, sk: (1, 1, sq, sk),
    "key_padding": lambda b, h, sq, sk: (b, 1, 1, sk),
    "full": lambda b, h, sq, sk: (b, h, sq, sk),
}


def _grad_rel_errs(got, want):
    return {n: float((g.float() - w.float()).abs().max())
            / max(float(w.float().abs().max()), 1e-6)
            for n, g, w in zip(("dq", "dk", "dv"), got, want)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", sorted(BIAS_CLASSES))
@pytest.mark.parametrize("case", ["causal", "chunk", "gqa", "window"])
def test_flash_kernels_with_bias_match_plain(cuda_device, case, shape,
                                             dtype):
    q, k, v, do, q_seg, k_seg, scale, causal, window = _flash_inputs(
        case, cuda_device, 17)
    b, h, sq, sk = q.shape[0], q.shape[1], q.shape[2], k.shape[2]
    rng = np.random.RandomState(19)
    bias = torch.from_numpy(2 * rng.randn(*BIAS_CLASSES[shape](
        b, h, sq, sk)).astype(np.float32)).to(cuda_device, dtype)
    kw = dict(bias=bias)
    counts = _build.launch_counts()
    out, lse = attention._flash_cuda(q, k, v, q_seg, k_seg, scale, causal,
                                     window, **kw)
    pout, plse = attention._attention_torch(
        q, k, v, bias, q_seg, k_seg, scale, causal, window, return_lse=True)
    delta = (out.float() * do.float()).sum(-1)
    args = (q, k, v, lse, do, delta, q_seg, k_seg, scale, causal, window)
    got = attention._flash_bwd_cuda(*args, **kw)
    want = attention._flash_bwd_torch(*args, **kw)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    for kname in (attention.KERNEL, attention.BWD_DQ_KERNEL,
                  attention.BWD_DKV_KERNEL):
        assert after[kname] == counts.get(kname, 0) + 1
    assert _row_rel_err(out, pout) <= 2.0 ** -6
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-3)
    for name, e in _grad_rel_errs(got, want).items():
        assert e <= 2.0 ** -6, (name, e)


@pytest.mark.cuda
def test_flash_bias_with_dropout_keeps_the_plain_mask(cuda_device):
    # q = 0: the probabilities are softmax(bias) along each row, all > 0;
    # V the identity over 64 keys puts key j's dropped weight in column j
    b, h, sq, sk = 2, 4, 130, 64
    q = torch.zeros(b, h, sq, sk, dtype=torch.bfloat16, device=cuda_device)
    k = torch.randn(b, h, sk, sk, device=cuda_device).to(torch.bfloat16)
    v = torch.eye(sk, device=cuda_device).to(torch.bfloat16).expand(
        b, h, sk, sk).contiguous()
    bias = torch.randn(b, 1, 1, sk, device=cuda_device)
    rate, seed = 0.1, 99
    out, lse = attention._flash_cuda(q, k, v, None, None, 1.0, False, None,
                                     rate, seed, bias=bias)
    pout, plse = attention._attention_torch(
        q, k, v, bias, None, None, 1.0, False, None, rate, seed,
        return_lse=True)
    bh = torch.arange(b * h, device=cuda_device).reshape(b, h, 1, 1)
    keep = attention._dropout_keep(
        seed, bh, torch.arange(sq, device=cuda_device).reshape(sq, 1),
        torch.arange(sk, device=cuda_device).reshape(1, sk), rate)
    torch.cuda.synchronize()
    assert torch.equal(out != 0, keep) and torch.equal(pout != 0, keep)
    assert _row_rel_err(out, pout) <= 2.0 ** -6
    torch.testing.assert_close(lse, plse, rtol=0, atol=1e-3)


def _zigzag_shard_pos(seq, cp, i, dev):
    piece = seq // (2 * cp)
    pos = np.concatenate([np.arange(i * piece, (i + 1) * piece),
                          np.arange((2 * cp - 1 - i) * piece,
                                    (2 * cp - i) * piece)])
    return torch.from_numpy(pos.astype(np.int32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("window", [None, 70])
@pytest.mark.parametrize("pair", [(0, 0), (1, 0), (0, 3), (2, 1), (3, 3)])
def test_flash_kernels_with_positions_match_plain(cuda_device, pair, window):
    # 4 zig-zag shards of two 40-token chunks: tiles of 64 straddle chunks
    seq, cp = 320, 4
    qi, kj = pair
    qp = _zigzag_shard_pos(seq, cp, qi, cuda_device)
    kp = _zigzag_shard_pos(seq, cp, kj, cuda_device)
    rng = np.random.RandomState(23)
    q, k, v, do = (torch.from_numpy(rng.randn(1, 4, 80, 64).astype(
        np.float32)).to(cuda_device, torch.bfloat16) for _ in range(4))
    glse = torch.from_numpy(rng.randn(1, 4, 80).astype(np.float32)).to(
        cuda_device)
    kw = dict(q_pos=qp, k_pos=kp)
    scale = 0.125
    out, lse = attention._flash_cuda(q, k, v, None, None, scale, True,
                                     window, **kw)
    pout, plse = attention._attention_torch(
        q, k, v, None, None, None, scale, True, window, return_lse=True,
        **kw)
    delta = (out.float() * do.float()).sum(-1)
    args = (q, k, v, lse, do, delta, None, None, scale, True, window)
    got = attention._flash_bwd_cuda(*args, glse=glse, **kw)
    want = attention._flash_bwd_torch(*args, glse=glse, **kw)
    torch.cuda.synchronize()
    live = plse > attention.NEG_INF * 0.5
    assert torch.equal(live, lse > attention.NEG_INF * 0.5)
    # rows with no live key: out exactly 0, lse NEG_INF, dq exactly 0
    assert (out[~live] == 0).all() and (lse[~live] == attention.NEG_INF).all()
    assert (got[0][~live] == 0).all()
    if live.any():
        assert _row_rel_err(out[live], pout[live]) <= 2.0 ** -6
        torch.testing.assert_close(lse[live], plse[live], rtol=0, atol=1e-3)
    for name, e in _grad_rel_errs(got, want).items():
        assert e <= 2.0 ** -6, (name, e)
    if not live.any():
        assert all((g == 0).all() for g in got)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(ATTENTION_CASES))
def test_flash_bwd_kernels_with_glse_match_plain(cuda_device, case):
    q, k, v, do, q_seg, k_seg, scale, causal, window = _flash_inputs(
        case, cuda_device, 29)
    out, lse = attention._flash_cuda(q, k, v, q_seg, k_seg, scale, causal,
                                     window)
    glse = torch.randn(lse.shape, device=cuda_device)
    delta = (out.float() * do.float()).sum(-1)
    args = (q, k, v, lse, do, delta, q_seg, k_seg, scale, causal, window)
    got = attention._flash_bwd_cuda(*args, glse=glse)
    want = attention._flash_bwd_torch(*args, glse=glse)
    torch.cuda.synchronize()
    for name, e in _grad_rel_errs(got, want).items():
        assert e <= 2.0 ** -6, (name, e)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(BIAS_CLASSES))
def test_flash_dbias_matches_autograd_through_plain(cuda_device, shape):
    q, k, v, do, _, _, scale, causal, window = _flash_inputs(
        "gqa", cuda_device, 31)
    b, h, sq, sk = q.shape[0], q.shape[1], q.shape[2], k.shape[2]
    bias0 = torch.randn(BIAS_CLASSES[shape](b, h, sq, sk),
                        device=cuda_device)
    grads = []
    for flash in (True, False):
        leaves = [t.clone().requires_grad_() for t in (q, k, v, bias0)]
        if flash:
            out = attention.flash_attention(*leaves[:3], bias=leaves[3],
                                            causal=causal)
        else:
            out = attention._attention_torch(
                *leaves[:3], leaves[3], None, None, scale, causal, window)
        out.backward(do)
        grads.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), *grads):
        assert g.shape == w.shape and g.dtype == w.dtype
        err = float((g.float() - w.float()).abs().max())
        assert err <= 2.0 ** -6 * float(w.float().abs().max()), (name, err)


@pytest.mark.cuda
def test_multihead_attn_layer_on_card_matches_plain(cuda_device):
    from apex_tpu_torch.contrib.multihead_attn import SelfMultiheadAttn
    s, b, e = 64, 6, 256
    mods = [SelfMultiheadAttn(e, 4, dropout=0.1, bias=True,
                              include_norm_add=True, impl=impl,
                              mask_additive=True, dtype=torch.bfloat16,
                              device=cuda_device,
                              generator=torch.Generator().manual_seed(5))
            for impl in ("fast", "default")]
    x = (0.5 * torch.randn(s, b, e, device=cuda_device)).to(torch.bfloat16)
    lens = torch.tensor([64, 40, 33, 64, 50, 61], device=cuda_device)
    mask = torch.where(torch.arange(s, device=cuda_device)[None]
                       >= lens[:, None], -10000.0, 0.0)
    outs = []
    for mod in mods:
        counts = _build.launch_counts()
        xl = x.clone().requires_grad_()
        out, _ = mod(xl, key_padding_mask=mask, dropout_key=(3, 4))
        out.float().pow(2).sum().backward()
        torch.cuda.synchronize()
        after = _build.launch_counts()
        n = 1 if mod.impl == "fast" else 0
        for kname in (attention.KERNEL, attention.BWD_DQ_KERNEL,
                      attention.BWD_DKV_KERNEL):
            assert after.get(kname, 0) == counts.get(kname, 0) + n
        for kname in (layer_norm.KERNEL, layer_norm.BWD_KERNEL):
            assert after[kname] == counts.get(kname, 0) + 1
        outs.append((out.detach(), xl.grad,
                     {n_: p.grad for n_, p in mod.named_parameters()}))
    (out, gx, gp), (pout, pgx, pgp) = outs
    assert float((out.float() - pout.float()).abs().max()) <= 2e-2
    for name, g, w in [("x", gx, pgx)] + [(n_, gp[n_], pgp[n_])
                                          for n_ in gp]:
        rel = float((g.float() - w.float()).norm()
                    / w.float().norm().clamp_min(1e-6))
        assert rel <= 2e-2, (name, rel)


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
    # fp16 has kernels now (counted as <kernel>_fp16); fp64 is refused
    from apex_tpu_torch.ops import softmax
    name = softmax.kernel_name(softmax.SCALED_KERNEL, torch.float16)
    n0 = _build.launch_counts().get(name, 0)
    softmax.scaled_softmax(torch.zeros(4, 8, device=cuda_device,
                                       dtype=torch.float16))
    assert _build.launch_counts()[name] == n0 + 1
    with pytest.raises(TypeError, match="softmax kernel"):
        softmax.scaled_softmax(torch.zeros(4, 8, device=cuda_device,
                                           dtype=torch.float64))


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
    cos = torch.zeros(4, 3, 1, 8, device=cuda_device)
    with pytest.raises(ValueError):            # does not broadcast
        fused_apply_rotary_pos_emb_cached(t, cos, cos)
    with pytest.raises(TypeError):
        fused_apply_rotary_pos_emb(t.double(), torch.zeros(
            4, 1, 1, 8, device=cuda_device))


# -- stochastic rounding: the bf16-master kernels ---------------------------
#
# Tolerances: the cast and every functor's p' bitwise (the kernels run the
# plain version's fp32 arithmetic and hash the same stream); the slots
# bitwise as without SR; the segmented update's p' within one bf16 ulp
# (its ratios come from sums in another order, which may move the fp32
# value across a rounding boundary), m' and v' bitwise.


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in bf16 ulps, from the bit patterns (same-sign values)."""
    return (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 4097, 1 << 20])
def test_stochastic_round_cast_kernel_bitwise_equals_plain(cuda_device, n):
    from apex_tpu_torch.multi_tensor import engine
    x = _rand(np.random.RandomState(n), n, cuda_device) * 3.0
    if n > 3:
        x[:3] = torch.tensor([float("inf"), -float("inf"), 1.0 + 2 ** -10])
    before = _build.launch_counts().get(engine.SR_CAST_KERNEL, 0)
    got = engine.stochastic_round_cast(x, 7, 2)
    want = engine.stochastic_round_cast(x, 7, 2, plain=True)
    torch.cuda.synchronize()
    assert _build.launch_counts()[engine.SR_CAST_KERNEL] == before + 1
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def _sr_space(dev):
    from apex_tpu_torch.multi_tensor import FlatSpace
    space = FlatSpace.create({"a": torch.empty(5000), "b": torch.empty(7),
                              "c": torch.empty(70000)})
    return space, space.device_subtile_leaf_ids(dev)


def _sr_adam(p, s, g, _space, plain):
    return fused_adam_update(p, *s, g, lr=1e-3, weight_decay=0.01, step=3,
                             grad_scale=4.0, sr_seed=5, plain=plain)


def _sr_adagrad(p, s, g, _space, plain):
    return mt_ops.fused_adagrad_update(p, s[0].abs(), g, lr=1e-2,
                                       weight_decay=0.01, sr_seed=5,
                                       plain=plain)


def _sr_sgd(p, s, g, _space, plain):
    return mt_ops.fused_sgd_update(p, s[0], g, lr=0.1, momentum=0.9,
                                   nesterov=True, weight_decay=1e-4,
                                   sr_seed=5, plain=plain)


def _sr_novograd(p, s, g, space, plain):
    ids = space.device_subtile_leaf_ids(p.device)
    denom = torch.tensor([0.5, 2.0, 1.25], device=p.device)
    return mt_ops.novograd_apply(p, s[0], g, denom, lr=0.01, beta1=0.95,
                                 beta3=0.05, weight_decay=1e-3,
                                 bc1=torch.tensor(1.0), tile_ids=ids,
                                 sr_seed=5, plain=plain)


def _sr_lars(p, s, g, space, plain):
    ids = space.device_subtile_leaf_ids(p.device)
    ratio = torch.tensor([0.5, 2.0, 1.25], device=p.device)
    return mt_ops.lars_apply(p, s[0], g, ratio, lr=0.1, momentum=0.9,
                             weight_decay=1e-4, tile_ids=ids, sr_seed=5,
                             plain=plain)


def _sr_lamb2(p, s, g, space, plain):
    ids = space.device_subtile_leaf_ids(p.device)
    ratio = torch.tensor([0.5, 2.0, 1.25], device=p.device)
    return (mt_ops.lamb_apply(p, g, ratio, lr=1e-3, tile_ids=ids, sr_seed=5,
                              plain=plain),)


SR_FUNCTORS = {"adam": (_sr_adam, mt_ops.ADAM_KERNEL),
               "adagrad": (_sr_adagrad, mt_ops.ADAGRAD_KERNEL),
               "sgd": (_sr_sgd, mt_ops.SGD_KERNEL),
               "novograd": (_sr_novograd, mt_ops.NOVOGRAD_KERNEL),
               "lars": (_sr_lars, mt_ops.LARS_KERNEL),
               "lamb_stage2": (_sr_lamb2, mt_ops.LAMB_STAGE2_KERNEL)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SR_FUNCTORS))
def test_sr_functor_kernels_bitwise_equal_plain(cuda_device, name):
    fn, kernel = SR_FUNCTORS[name]
    space, _ = _sr_space(cuda_device)
    rng = np.random.RandomState(20)
    p = _rand(rng, space.total, cuda_device).bfloat16()
    slots = [_rand(rng, space.total, cuda_device, 0.01),
             _rand(rng, space.total, cuda_device, 1e-4, positive=True)]
    g = _rand(rng, space.total, cuda_device)
    want = fn(p.clone(), [t.clone() for t in slots], g, space, True)
    kernel = mt_ops.sr_variant(kernel, (0, 0))
    before = _build.launch_counts().get(kernel, 0)
    got = fn(p, slots, g, space, False)
    torch.cuda.synchronize()
    assert _build.launch_counts()[kernel] == before + 1
    assert got[0] is p and p.dtype == torch.bfloat16        # in place
    assert torch.equal(got[0].view(torch.int16), want[0].view(torch.int16))
    for a, b in zip(got[1:], want[1:]):
        if a.dtype == torch.float32 and a.ndim:
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_sr_kernels_refuse_what_they_do_not_take(cuda_device):
    n = 4096
    p = torch.zeros(n, device=cuda_device)
    m, v, g = (torch.zeros(n, device=cuda_device) for _ in range(3))
    with pytest.raises(ValueError, match="targets bfloat16"):
        fused_adam_update(p, m, v, g, lr=1e-3, sr_seed=1)
    with pytest.raises(TypeError):         # a bf16 p needs SR
        fused_adam_update(p.bfloat16(), m, v, g, lr=1e-3)


@pytest.mark.cuda
def test_lamb_stage1_and_sumsq_read_bf16_p(cuda_device):
    from apex_tpu_torch.multi_tensor import (engine,
                                             fused_lamb_compute_update_term)
    rng = np.random.RandomState(21)
    n = 3 * 65536 + 517
    p = _rand(rng, n, cuda_device).bfloat16()
    m, g = (_rand(rng, n, cuda_device) for _ in range(2))
    v = _rand(rng, n, cuda_device, positive=True)
    kw = dict(_lamb_scalars(), adam_w_mode=True, inv_scale=3.0,
              with_norm_partials=True)
    want, _ = fused_lamb_compute_update_term(p, m.clone(), v.clone(), g,
                                             plain=True, **kw)
    got, _ = fused_lamb_compute_update_term(p, m, v, g, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    for a, b in zip(got[3:], want[3:]):
        torch.testing.assert_close(a.sum(-1), b.sum(-1), rtol=1e-5, atol=0)
    torch.testing.assert_close(engine.fused_sumsq_partials(p, 16),
                               engine.fused_sumsq_partials(p, 16, plain=True),
                               rtol=1e-5, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("stash_p", [True, False])
@pytest.mark.parametrize("u_dtype", [torch.float32, torch.bfloat16])
def test_segmented_lamb_sr_kernels_match_plain(cuda_device, stash_p,
                                               u_dtype):
    from apex_tpu_torch.multi_tensor import fused_lamb_segmented_update
    from apex_tpu_torch.multi_tensor.segmented import SEGMENT_SR_KERNEL
    space, meta, (p, m, v, g) = _segmented_case(cuda_device, 22)
    p = p.bfloat16()
    kw = dict(lr=2e-3, weight_decay=0.01, step=3, stash_p=stash_p,
              u_dtype=u_dtype, sr_seed=17)
    want = fused_lamb_segmented_update(p.clone(), m.clone(), v.clone(), g,
                                       space, meta, plain=True, **kw)
    counts = _build.launch_counts()
    got = fused_lamb_segmented_update(p.clone(), m.clone(), v.clone(), g,
                                      space, meta, **kw)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    for k in (SEGMENT_SR_KERNEL, mt_ops.LAMB_STAGE1_BF16_KERNEL,
              mt_ops.LAMB_STAGE2_KERNEL + mt_ops.SR_SUFFIX):
        assert after[k] == counts.get(k, 0) + 1, k
    for a, b in zip(got[1:3], want[1:3]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert got[0].dtype == torch.bfloat16
    assert int(_bf16_ulps(got[0], want[0]).max()) <= 1
    again = fused_lamb_segmented_update(p.clone(), m.clone(), v.clone(), g,
                                        space, meta, **kw)
    assert torch.equal(got[0].view(torch.int16), again[0].view(torch.int16))


@pytest.mark.cuda
def test_stage2_segment_list_sr_bitwise_equals_plain(cuda_device):
    """Stage 2 over the large leaves' segments with each leaf's stream,
    its key derived in the kernel from the layout's tables and the seed."""
    space, meta, (p, _, _, u) = _segmented_case(cuda_device, 23)
    p = p.bfloat16()
    segs, _, _ = meta.device_large(cuda_device)
    ratio = torch.linspace(0.5, 1.5, space.num_leaves, device=cuda_device)
    ids = space.device_subtile_leaf_ids(cuda_device)
    kw = dict(lr=1e-2, seg_streams=meta.device_large_streams(cuda_device),
              sr_seed=29)
    want = mt_ops.lamb_stage2_segments(p, u, p.clone(), ratio, ids, segs,
                                       meta.seg_elems, plain=True, **kw)
    name = mt_ops.LAMB_STAGE2_KERNEL + mt_ops.SR_SUFFIX
    before = _build.launch_counts().get(name, 0)
    got = mt_ops.lamb_stage2_segments(p, u, p.clone(), ratio, ids, segs,
                                      meta.seg_elems, **kw)
    torch.cuda.synchronize()
    assert _build.launch_counts()[name] == before + 1
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert not torch.equal(got.view(torch.int16), p.view(torch.int16))


@pytest.mark.cuda
def test_bf16_master_skip_leaves_state(cuda_device):
    from apex_tpu_torch.optimizers import FusedAdam
    opt = FusedAdam(lr=1e-3, master_dtype=torch.bfloat16,
                    stochastic_rounding=True)
    st = opt.init({"w": torch.randn(10_000, device=cuda_device).bfloat16()})
    g = torch.randn(st.master.shape[0], device=cuda_device)
    g[77] = float("inf")
    saved = [st.master.clone(), st.slots["m"].clone(), st.count]
    _, st2 = opt.step_flat(st, g, skip_if_nonfinite=True)
    assert float(st2.found_inf) == 1.0 and st2.count == saved[2]
    assert torch.equal(st2.master.view(torch.int16),
                       saved[0].view(torch.int16))
    assert torch.equal(st2.slots["m"], saved[1])


# -- fp16 and fp32 flash kernels, any head width up to 128 -------------------
#
# Tolerances, relative to each gradient's largest |value| and, for the
# output, to each query row's (fp16, bf16) or the output's (fp32): fp32
# within 1e-5 (the kernels' products are exact in three bf16 parts, their
# fp32 sums in another order, which errs by ulps of the terms |v|, not of
# a row's mean); fp16 within 2^-9 (two fp16 ulps: the kernel rounds P to
# fp16 before P.V, the plain forward does not; both round dS); bf16 as
# above (2^-6).

FLASH_DTYPE_TOL = {torch.float32: 1e-5, torch.float16: 2.0 ** -9,
                   torch.bfloat16: 2.0 ** -6}


def _row_rel(got, want):
    got, want = got.detach(), want.detach()
    d = (got.float() - want.float()).abs()
    scale = want.float().abs().amax(dim=-1, keepdim=True).clamp_min(1e-6)
    return float((d / scale).max())


def _grad_rel(got, want):
    got, want = got.detach(), want.detach()
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max().clamp_min(1e-6))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16], ids=str)
@pytest.mark.parametrize("d", [17, 48, 64, 96, 128])
@pytest.mark.parametrize("extra", ["causal", "bias", "dropout",
                                   "positions"])
def test_flash_kernels_take_every_dtype_and_width(cuda_device, dtype, d,
                                                  extra):
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    b, h, hk, sq, sk = 2, 4, 2, 70, 70
    if extra == "positions":
        b, sk = 1, 134

    def rnd(*shape):
        return torch.randn(*shape, device=cuda_device,
                           generator=gen).to(dtype)
    q, k, v, do = rnd(b, h, sq, d), rnd(b, hk, sk, d), rnd(b, hk, sk, d), \
        rnd(b, h, sq, d)
    kw = {"causal": extra != "bias"}
    if extra == "bias":
        kw["bias"] = rnd(b, 1, sq, sk)
    elif extra == "dropout":
        kw.update(dropout_rate=0.1, dropout_rng=(3, 4))
    elif extra == "positions":
        kw.update(q_positions=torch.arange(sk - sq, sk, device=cuda_device),
                  kv_positions=torch.arange(sk, device=cuda_device))
    names = [attention.kernel_name(n, dtype) for n in (
        attention.KERNEL, attention.BWD_DQ_KERNEL, attention.BWD_DKV_KERNEL)]
    before = _build.launch_counts()
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = attention.flash_attention(*leaves, **kw)
    grads = torch.autograd.grad(out, leaves, do)
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    pout = attention.attention_plain(*plain, **kw)
    pgrads = torch.autograd.grad(pout, plain, do)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    for n in names:
        assert after.get(n, 0) == before.get(n, 0) + 1, n
    tol = FLASH_DTYPE_TOL[dtype]
    assert out.dtype == dtype and out.shape == q.shape
    rel = _grad_rel if dtype == torch.float32 else _row_rel
    assert rel(out, pout) <= tol
    for g, pg in zip(grads, pgrads):
        assert g.dtype == dtype and g.shape == pg.shape
        assert _grad_rel(g, pg) <= tol


# -- fp16 LayerNorm and softmax ----------------------------------------------
#
# Tolerances: outputs within one fp16 ulp of the value (2^-10 |y|) plus
# 2^-14 near zero; dx within 2^-9 of each row's largest |value|; dw, db
# within 1e-5 of their largest |value|.


@pytest.mark.cuda
@pytest.mark.parametrize("h", [1024, 1000, 4096])
def test_fp16_layer_norm_kernels_match_plain(cuda_device, h):
    gen = torch.Generator(device=cuda_device).manual_seed(h)
    x = (2 * torch.randn(257, h, device=cuda_device, generator=gen)
         + 0.5).half()
    g = torch.randn(257, h, device=cuda_device, generator=gen).half()
    w = 1 + 0.1 * torch.randn(h, device=cuda_device, generator=gen)
    b = 0.1 * torch.randn(h, device=cuda_device, generator=gen)
    before = _build.launch_counts()
    y, mean, rstd = layer_norm._fwd_cuda(x, w, b, 1e-5, False)
    dx, dw, db = layer_norm._bwd_cuda(x, w, mean, rstd, g, False)
    py, pmean, prstd = layer_norm._fwd_torch(x, w, b, 1e-5, False)
    pdx, pdw, pdb = layer_norm._bwd_torch(x, w, mean, rstd, g, False)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    for base in (layer_norm.KERNEL, layer_norm.BWD_KERNEL):
        n = layer_norm.kernel_name(base, torch.float16)
        assert after[n] == before.get(n, 0) + 1
    assert y.dtype == dx.dtype == torch.float16
    excess = (y.float() - py.float()).abs() - 2.0 ** -10 * py.float().abs()
    assert float(excess.max()) <= 2.0 ** -14
    assert float((mean - pmean).abs().max()) <= 1e-5
    assert _row_rel(dx, pdx) <= 2.0 ** -9 or float(
        (dx.float() - pdx.float()).abs().max()) <= 2.0 ** -14
    for a, e in ((dw, pdw), (db, pdb)):
        assert _grad_rel(a, e) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("mode,shape", [("scaled", (4, 8, 64, 200)),
                                        ("causal", (16, 128, 128)),
                                        ("causal", (4, 64, 2000)),
                                        ("masked", (4, 8, 64, 64))])
def test_fp16_softmax_kernels_match_plain(cuda_device, mode, shape):
    from apex_tpu_torch.ops import softmax
    gen = torch.Generator(device=cuda_device).manual_seed(len(shape))
    x = (3 * torch.randn(*shape, device=cuda_device, generator=gen)).half()
    g = torch.randn(*shape, device=cuda_device, generator=gen).half()
    mask = None
    if mode == "masked":
        mask = torch.rand(shape[0], 1, shape[2], shape[3],
                          device=cuda_device, generator=gen) < 0.3
    code, counter = softmax._MODES[mode]
    before = _build.launch_counts()
    y = softmax._fwd_cuda(x, mask, 0.5, mode)
    dx = softmax._bwd_cuda(y, g, 0.5)
    py = softmax._fwd_torch(x, mask, 0.5, mode)
    pdx = softmax._bwd_torch(y, g, 0.5)
    torch.cuda.synchronize()
    after = _build.launch_counts()
    for base in (counter, softmax.BWD_KERNEL):
        n = softmax.kernel_name(base, torch.float16)
        assert after[n] == before.get(n, 0) + 1
    assert bool(torch.isfinite(y).all())       # -1e30 never stored
    excess = (y.float() - py.float()).abs() - 2.0 ** -10 * py.float().abs()
    assert float(excess.max()) <= 2.0 ** -14
    row = pdx.float().abs().amax(dim=-1, keepdim=True).clamp_min(1e-3)
    assert float(((dx.float() - pdx.float()).abs() / row).max()) <= 2.0 ** -9


# -- RoPE tables that vary beyond the position axis (bitwise) ----------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=str)
@pytest.mark.parametrize("table", ["batch", "head", "batch_head",
                                   "broadcast_positions", "expanded"])
def test_rope_kernel_reads_strided_tables(cuda_device, dtype, table):
    from apex_tpu_torch.ops import rope
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    s, b, h, d, rot = 64, 3, 4, 64, 48
    t = torch.randn(s, b, h, d, device=cuda_device, generator=gen).to(dtype)
    shape = {"batch": (s, b, 1, rot), "head": (s, 1, h, rot),
             "batch_head": (s, b, h, rot), "broadcast_positions":
             (1, b, 1, rot), "expanded": (s, 1, 1, rot)}[table]
    ang = torch.randn(*shape, device=cuda_device, generator=gen)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if table == "expanded":
        cos, sin = cos.expand(s, b, 1, rot), sin.expand(s, b, 1, rot)
    n0 = _build.launch_counts().get(rope.KERNEL, 0)
    for negate in (False, True):
        got = rope._rope_cuda(t, cos, sin, None, negate)
        want = rope._apply_torch(t, cos, -sin if negate else sin)
        assert torch.equal(got, want), (table, negate)
    assert _build.launch_counts()[rope.KERNEL] == n0 + 2


# -- the fixed-order leaf sums ------------------------------------------------


@pytest.mark.cuda
def test_leaf_sum_kernel_is_bitwise_the_plain_order(cuda_device):
    from apex_tpu_torch.multi_tensor import FlatSpace, engine
    space = FlatSpace.create({"emb": torch.zeros(25152 * 2048),
                              "b": torch.zeros(5),
                              "w": torch.zeros(3 << 20)})
    n_sub = space.total // 2048
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.rand(n_sub, device=cuda_device, generator=gen)
    n0 = _build.launch_counts().get(engine.LEAF_SUM_KERNEL, 0)
    a = engine.leaf_sums(x, space)
    b = engine.leaf_sums(x, space)
    p = engine.leaf_sums(x, space, plain=True)
    assert _build.launch_counts()[engine.LEAF_SUM_KERNEL] == n0 + 2
    assert torch.equal(a, b) and torch.equal(a, p)


# -- the probes -----------------------------------------------------------------


@pytest.mark.cuda
def test_kprobe_rungs_are_bitwise_their_plain_versions(cuda_device):
    from apex_tpu_torch.tools import kprobe
    recs = kprobe.ladder(1 << 20 | 3, device=cuda_device,
                         timer=lambda fn: 1.0)
    for rung in kprobe.KERNEL_RUNGS:
        assert recs[rung]["bitwise"], rung
    assert recs["adam_found"]["found_clean"] == 0.0
    assert recs["adam_found"]["found_inf"] == 1.0


@pytest.mark.cuda
def test_launch_probe_passes_inside_the_limits_and_fails_outside(
        cuda_device):
    from apex_tpu_torch.tools import launch_probe
    results = launch_probe.probe_all(cuda_device, echo=None)
    off = [r for r in results if r["result"] != r["expected"]]
    assert not off, off
    assert any(r["result"] == "FAIL" for r in results)
