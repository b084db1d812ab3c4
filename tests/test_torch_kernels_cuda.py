"""The port's CUDA kernels against their plain PyTorch versions, on the
card.

Every test here needs a CUDA device and skips without one (a CUDA
kernel has no CPU mode; the plain versions are held against apex_tpu on
the CPU by test_torch_layer_norm.py, test_torch_attention.py and their
_bwd counterparts, and test_torch_adam.py). This
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
