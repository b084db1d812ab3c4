#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``apex_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--out results.json]

Phases, in order; any failure exits non-zero before the last line:

1. Environment: the card's name and power limit (``nvidia-smi``), then
   the build of every CUDA kernel from ``apex_tpu_torch/csrc``.
2. Each kernel against its plain PyTorch version on the card, at the
   shapes its path gives it (bf16 activations; Adam over fp32 buffers
   the size of GPT-2 345M), with its time, the plain version's time, one
   PyTorch library call computing the same function (a yardstick only;
   the port never calls it) and the least time the card could take
   (``bound_ms``: bytes over 3.35 TB/s or operations over the peak rate
   of their type, whichever is larger). The forward kernels at the
   serving shapes; the LayerNorm backward, the flash dq and dk/dv and
   the Adam kernels at the training shapes (Adam bitwise, with an
   injected inf: found_inf set, a skipped step leaving the state as it
   was).
3. Serving at full width: GPT-2 345M (hidden 1024, 24 layers, 16 heads,
   vocab 50304, bf16 compute, fp32 parameters, random weights from the
   seed) behind ``ContinuousBatcher(max_batch=8, prefill_chunk=256)``
   over a paged KV cache of 8 x 1024 tokens. Eight greedy requests with
   prompts of 32 to 700 tokens and 32 new tokens each; every kernel's
   launch count is set to 0 just before and read just after, and each
   must have launched. Then the first request's prompt goes again
   through each serving path with the kernels and with their plain
   versions, and the logits are compared: the monolithic prefill, and
   ``DecodeStep``'s last chunk and one decode step over the same cache.
4. Training at full width: GPT-2 345M from random weights,
   ``make_gpt_pretrain_step(cfg, FusedAdam(lr=1e-4, weight_decay=0.01))``,
   ten steps on one batch of 8 x 1024 tokens with the launch counts set
   to 0 just before and read just after (each of the six kernels must
   have launched); the loss must be finite and fall. Step time, tokens/s,
   peak memory and one profiled step. Then the first step's loss and
   every parameter's gradient at batch 2 through the kernels and through
   their plain versions.
5. The ``kernels`` JSON line, then the device line the caller reads.

Needs a CUDA device and ``nvcc`` (``$CUDA_HOME`` or
``/usr/local/cuda``); exits 1 without printing a result otherwise.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch import _build
from apex_tpu_torch.models import (
    GPTConfig,
    GPTModel,
    gpt_loss_fn,
    init_gpt_pretrain_params,
    make_gpt_pretrain_step,
)
from apex_tpu_torch.multi_tensor import FlatSpace, fused_adam_update
from apex_tpu_torch.multi_tensor import ops as mt_ops
from apex_tpu_torch.ops import attention, layer_norm
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.serving import (
    ContinuousBatcher,
    DecodeStep,
    KVCache,
    Request,
    serve_loop,
)

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_TENSOR_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12

# LayerNorm output: one bf16 ulp of the value (at most 2^-7 |y|), plus
# 1e-5 for values near zero, where fp32 results a few 1e-7 apart (sums
# in another order) round to bf16 values several of their tiny ulps apart
LN_REL_TOL, LN_ABS_TOL = 2.0 ** -7, 1e-5
LN_STAT_TOL = 1e-5      # fp32 mean / rstd
# bf16 output, per query row, relative to that row's largest |output|:
# two bf16 ulps (each side rounds once; the kernel also rounds P to bf16).
# A wrong V row, head or GQA map moves a row by its own scale.
FLASH_OUT_REL_TOL = 2.0 ** -6
FLASH_LSE_TOL = 1e-3    # fp32 log-sum-exp
# logits through 24 bf16 layers, kernels against plain versions: about 3x
# the 0.031 read on an H100 for the monolithic prefill, and 1/6 of the
# random model's logit std (0.02 * sqrt(1024) = 0.64)
LOGIT_TOL = 0.1
PREFILL_CHUNK = 256
# LayerNorm backward: dx as the forward's output; dw and db, fp32 sums of
# 8192 rows taken in another order, within 1e-4 of their largest |value|
LN_PARAM_TOL = 1e-4
# flash dq, dk, dv (bf16), relative to each one's largest |value|: two
# bf16 ulps (both round dS to bf16 before its products; fp32 values that
# differ in their last bits may round dS and the result to neighbouring
# bf16 values). A wrong mask, tile or GQA sum moves them by their scale.
FLASH_BWD_REL_TOL = 2.0 ** -6
# the training step through the kernels against their plain versions, at
# batch 2 on the same weights, bf16 through 24 layers: the kernels round P
# and dS to bf16 where the plain attention keeps fp32 scores and the
# LayerNorm rounds by one bf16 ulp apart. About 3x what an H100 read: a
# loss 1.4e-4 apart (of ~9.1) and gradients at most 1.3e-2 apart in
# relative L2 norm per parameter
TRAIN_LOSS_TOL = 5e-4
TRAIN_GRAD_REL_TOL = 0.04
TRAIN_STEPS = 10
TRAIN_BATCH = 8

PROMPT_LENS = (700, 32, 411, 96, 256, 530, 64, 180)
MAX_NEW = 32


class PhaseError(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise PhaseError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def host_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean time per call of ``fn`` over ``iters`` back-to-back calls,
    from CUDA events. When the host takes longer to issue a call than
    the device to run it, this is the host's time, not the kernel's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 20, replays: int = 5) -> float:
    """Mean device time per call of ``fn``: ``iters`` calls captured in
    one CUDA graph, the graph replayed ``replays`` times between CUDA
    events. The replay issues no host work, so this is the time of the
    kernels (and the gaps between graph nodes), not of the wrapper."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):         # warm-up off the capture
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def bound(nbytes: float, ops: float, rate: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else
            "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# -- phase 2: kernels against their plain versions ----------------------------


def layer_norm_case(gen: torch.Generator, dev, rows: int) -> dict:
    h = 1024
    x = torch.randn(rows, h, generator=gen).mul_(2).add_(0.5).to(
        dev, torch.bfloat16)
    w = (1 + 0.1 * torch.randn(h, generator=gen)).to(dev)
    b = (0.1 * torch.randn(h, generator=gen)).to(dev)
    y, mean, rstd = layer_norm._fwd_cuda(x, w, b, 1e-5, False)
    py, pmean, prstd = layer_norm._fwd_torch(x, w, b, 1e-5, False)
    torch.cuda.synchronize()
    diff = (y.float() - py.float()).abs()
    err = float(diff.max())
    excess = float((diff - LN_REL_TOL * py.float().abs()).max())
    stat_err = max(float((mean - pmean).abs().max()),
                   float(((rstd - prstd) / prstd).abs().max()))
    print(f"  layer_norm_fwd rows={rows} h={h} bf16: max_abs_err={err:.3e} "
          f"max(|diff| - 2^-7|y|)={excess:.3e} (tol {LN_ABS_TOL}) "
          f"stat_err={stat_err:.3e} (tol {LN_STAT_TOL})")
    check(excess <= LN_ABS_TOL and stat_err <= LN_STAT_TOL,
          "layer_norm_fwd kernel disagrees with its plain version")
    kernel = lambda: layer_norm._fwd_cuda(x, w, b, 1e-5, False)  # noqa: E731
    ms, h_ms = device_ms(kernel), host_ms(kernel)
    plain_ms = device_ms(lambda: layer_norm._fwd_torch(x, w, b, 1e-5, False))
    # the library call takes weights in x's dtype: bf16 copies, made once
    wl, bl = w.to(x.dtype), b.to(x.dtype)
    lib_ms = device_ms(lambda: F.layer_norm(x, (h,), wl, bl, 1e-5))
    # per element: sum, centre-square-accumulate, normalise, scale, shift
    b_ms, by = bound(nbytes(x, w, b, y, mean, rstd), 8 * rows * h,
                     PEAK_FP32_FLOPS)
    print(f"    ms={ms:.5f} host_ms={h_ms:.5f} plain_ms={plain_ms:.5f} "
          f"library_ms={lib_ms:.5f} bound_ms={b_ms:.5f} ({by})")
    return {"name": layer_norm.KERNEL, "route": "cuda",
            "source": "apex_tpu_torch/csrc/layer_norm.cu",
            "replaces": "apex_tpu/ops/layer_norm.py:45",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
            "host_ms": h_ms, "shape": f"rows={rows} h={h} bf16 x, fp32 w/b"}


def _allowed(b, sq, sk, causal, kv_seg, dev):
    """(b, sq, sk) bool: the (query, key) pairs the mask leaves live."""
    qi = torch.arange(sq, device=dev)[:, None]
    kj = torch.arange(sk, device=dev)[None, :]
    live = torch.ones(b, sq, sk, dtype=torch.bool, device=dev)
    if causal:
        live &= (kj <= qi + (sk - sq))[None]
    if kv_seg is not None:
        live &= (kv_seg == 0)[:, None, :]       # queries are segment 0
    return live


def flash_case(name, gen, dev, b, h, hk, sq, sk, d, causal, written=None):
    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dev, torch.bfloat16)
    q, k, v = rnd(b, h, sq, d), rnd(b, hk, sk, d), rnd(b, hk, sk, d)
    kv_seg = None
    kw = {"causal": causal}
    if written is not None:
        # the serving layout: written context keys are segment 0, the
        # unwritten context tail 1, this call's own sq keys 0
        L = sk - sq
        ctx = torch.arange(L)[None, :] >= torch.tensor(written)[:, None]
        kv_seg = torch.cat([ctx.int(), torch.zeros(b, sq, dtype=torch.int32)],
                           dim=1).to(dev)
        kw["kv_segment_ids"] = kv_seg
    out, lse = attention.flash_attention(q, k, v, return_lse=True, **kw)
    pout, plse = attention.attention_plain(q, k, v, return_lse=True, **kw)
    torch.cuda.synchronize()
    diff = (out.float() - pout.float()).abs()
    err = float(diff.max())
    # fully masked rows are 0 on both sides: any floor keeps them at 0
    row_scale = pout.float().abs().amax(dim=-1, keepdim=True).clamp_min(1e-6)
    rel_err = float((diff / row_scale).max())
    lse_err = float((lse - plse).abs().max())
    check(bool(torch.isfinite(out).all()), f"flash_fwd[{name}]: non-finite")
    print(f"  flash_fwd[{name}] b={b} h={h} hk={hk} sq={sq} sk={sk} d={d} "
          f"causal={causal} segments={written is not None}: "
          f"max_abs_err={err:.3e} row_rel_err={rel_err:.3e} "
          f"(tol {FLASH_OUT_REL_TOL}) "
          f"lse_err={lse_err:.3e} (tol {FLASH_LSE_TOL})")
    check(rel_err <= FLASH_OUT_REL_TOL and lse_err <= FLASH_LSE_TOL,
          f"flash_fwd[{name}] kernel disagrees with its plain version")
    kernel = lambda: attention.flash_attention(q, k, v, **kw)  # noqa: E731
    ms, h_ms = device_ms(kernel), host_ms(kernel)
    plain_ms = device_ms(lambda: attention.attention_plain(q, k, v, **kw),
                         iters=5)
    live = _allowed(b, sq, sk, causal, kv_seg, dev)
    if written is None and not causal:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, enable_gqa=hk != h)
    elif written is None and sq == sk:
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=True, enable_gqa=hk != h)
    else:
        mask = live[:, None]
        lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=mask, enable_gqa=hk != h)
    lib_ms = device_ms(lib)
    pairs = int(live.sum()) * h        # live (query, key) pairs, all heads
    b_ms, by = bound(nbytes(q, k, v, out, lse, kv_seg), 4 * d * pairs,
                     PEAK_BF16_TENSOR_FLOPS)
    print(f"    ms={ms:.5f} host_ms={h_ms:.5f} plain_ms={plain_ms:.5f} "
          f"library_ms={lib_ms:.5f} bound_ms={b_ms:.5f} ({by})")
    return {"case": name, "max_abs_err": err, "row_rel_err": rel_err,
            "lse_err": lse_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": lib_ms, "host_ms": h_ms,
            "shape": f"b={b} h={h} hk={hk} sq={sq} sk={sk} d={d} "
                     f"causal={causal} segments={written is not None}"}


def flash_cases(gen, dev) -> dict:
    cases = [
        flash_case("prefill", gen, dev, 4, 16, 16, 512, 512, 64, True),
        flash_case("chunk", gen, dev, 4, 16, 16, 128, 384 + 128, 64, True,
                   written=[384, 300, 200, 100]),
        # the serving path's own chunk length, resuming at 512 as the
        # 700-token prompt's last chunk does
        flash_case("chunk256", gen, dev, 4, 16, 16, PREFILL_CHUNK,
                   512 + PREFILL_CHUNK, 64, True,
                   written=[512, 400, 256, 100]),
        flash_case("decode", gen, dev, 8, 16, 16, 1, 1025, 64, False,
                   written=[1024, 700, 512, 300, 200, 100, 64, 32]),
        flash_case("gqa", gen, dev, 4, 16, 4, 512, 512, 64, True),
        # the training path's shape
        flash_case("train", gen, dev, TRAIN_BATCH, 16, 16, 1024, 1024, 64,
                   True),
    ]
    # the headline numbers are the decode case's: decode is where the
    # serving path launches this kernel most
    top = dict(cases[3])
    top.pop("case")
    return {"name": attention.KERNEL, "route": "cuda",
            "source": "apex_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "apex_tpu/ops/attention.py:182",
            **top, "max_abs_err": max(c["max_abs_err"] for c in cases),
            "row_rel_err": max(c["row_rel_err"] for c in cases),
            "cases": cases}


def layer_norm_bwd_case(gen: torch.Generator, dev) -> dict:
    rows, h = TRAIN_BATCH * 1024, 1024
    x = torch.randn(rows, h, generator=gen).mul_(2).add_(0.5).to(
        dev, torch.bfloat16)
    g = torch.randn(rows, h, generator=gen).to(dev, torch.bfloat16)
    w = (1 + 0.1 * torch.randn(h, generator=gen)).to(dev)
    b = (0.1 * torch.randn(h, generator=gen)).to(dev)
    _, mean, rstd = layer_norm._fwd_cuda(x, w, b, 1e-5, False)
    dx, dw, db = layer_norm._bwd_cuda(x, w, mean, rstd, g, False)
    pdx, pdw, pdb = layer_norm._bwd_torch(x, w, mean, rstd, g, False)
    torch.cuda.synchronize()
    diff = (dx.float() - pdx.float()).abs()
    err = float(diff.max())
    excess = float((diff - LN_REL_TOL * pdx.float().abs()).max())
    p_err = max(float((a - e).abs().max()) / float(e.abs().max())
                for a, e in ((dw, pdw), (db, pdb)))
    print(f"  layer_norm_bwd rows={rows} h={h} bf16: max_abs_err={err:.3e} "
          f"max(|diff| - 2^-7|dx|)={excess:.3e} (tol {LN_ABS_TOL}) "
          f"dw/db rel_err={p_err:.3e} (tol {LN_PARAM_TOL})")
    check(excess <= LN_ABS_TOL and p_err <= LN_PARAM_TOL,
          "layer_norm_bwd kernel disagrees with its plain version")
    kernel = lambda: layer_norm._bwd_cuda(  # noqa: E731
        x, w, mean, rstd, g, False)
    ms, h_ms = device_ms(kernel), host_ms(kernel)
    plain_ms = device_ms(
        lambda: layer_norm._bwd_torch(x, w, mean, rstd, g, False), iters=5)
    # the library's LayerNorm backward on bf16 weights, from its own
    # forward's statistics
    wl, bl = w.to(x.dtype), b.to(x.dtype)
    _, lmean, lrstd = torch.native_layer_norm(x, (h,), wl, bl, 1e-5)
    lib_ms = device_ms(lambda: torch.ops.aten.native_layer_norm_backward(
        g, x, (h,), lmean, lrstd, wl, bl, [True, True, True]))
    # per element: x-hat, w*g, two row sums, dw/db sums, dx
    b_ms, by = bound(nbytes(x, g, w, mean, rstd, dx, dw, db), 13 * rows * h,
                     PEAK_FP32_FLOPS)
    print(f"    ms={ms:.5f} host_ms={h_ms:.5f} plain_ms={plain_ms:.5f} "
          f"library_ms={lib_ms:.5f} bound_ms={b_ms:.5f} ({by})")
    return {"name": layer_norm.BWD_KERNEL, "route": "cuda",
            "source": "apex_tpu_torch/csrc/layer_norm.cu",
            "replaces": "apex_tpu/ops/layer_norm.py:67",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
            "host_ms": h_ms, "shape": f"rows={rows} h={h} bf16 x, fp32 w"}


def flash_bwd_case(name, gen, dev, b, h, hk, sq, sk, d) -> dict:
    """Both backward kernels on one causal case against the plain
    backward, from the forward kernel's output and lse."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dev, torch.bfloat16)
    q, k, v, do = rnd(b, h, sq, d), rnd(b, hk, sk, d), rnd(b, hk, sk, d), \
        rnd(b, h, sq, d)
    scale = d ** -0.5
    out, lse = attention._flash_cuda(q, k, v, None, None, scale, True, None)
    delta = (out.float() * do.float()).sum(-1)
    args = (q, k, v, lse, do, delta, None, None, scale, True, None)
    got = attention._flash_bwd_cuda(*args)
    want = attention._flash_bwd_torch(*args)
    torch.cuda.synchronize()
    errs = {}
    for gname, gt, wt in zip(("dq", "dk", "dv"), got, want):
        check(bool(torch.isfinite(gt.float()).all()),
              f"flash_bwd[{name}] {gname}: non-finite")
        diff = float((gt.float() - wt.float()).abs().max())
        errs[gname] = (diff, diff / max(float(wt.float().abs().max()), 1e-6))
    print(f"  flash_bwd[{name}] b={b} h={h} hk={hk} sq={sq} sk={sk} d={d} "
          f"causal: " + " ".join(f"{n} max_abs_err={a:.3e} rel={r:.3e}"
                                 for n, (a, r) in errs.items())
          + f" (tol {FLASH_BWD_REL_TOL})")
    check(all(r <= FLASH_BWD_REL_TOL for _, r in errs.values()),
          f"flash_bwd[{name}] kernels disagree with the plain backward")
    plain_ms = device_ms(lambda: attention._flash_bwd_torch(*args), iters=3,
                         replays=2)
    # the library's attention backward (SDPA), from its own forward
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
    with torch.enable_grad():
        if sq == sk:
            lo = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True,
                                                enable_gqa=hk != h)
        else:
            lo = F.scaled_dot_product_attention(
                ql, kl, vl, enable_gqa=hk != h,
                attn_mask=_allowed(b, sq, sk, True, None, dev)[:, None])
    lib_ms = host_ms(lambda: torch.autograd.grad(lo, (ql, kl, vl), do,
                                                 retain_graph=True), iters=10)
    pairs = int(_allowed(b, sq, sk, True, None, dev).sum()) * h
    rows = []
    for kname, n_products, outs in (
            (attention.BWD_DQ_KERNEL, 3, got[:1]),
            (attention.BWD_DKV_KERNEL, 4, got[1:])):
        kernel = lambda kname=kname: attention._flash_bwd_cuda(  # noqa: E731
            *args, kernels=(kname,))
        ms, h_ms = device_ms(kernel), host_ms(kernel)
        b_ms, by = bound(nbytes(q, k, v, do, lse, delta, *outs),
                         2 * d * n_products * pairs, PEAK_BF16_TENSOR_FLOPS)
        print(f"    {kname}: ms={ms:.5f} host_ms={h_ms:.5f} "
              f"bound_ms={b_ms:.5f} ({by}); both kernels' plain_ms="
              f"{plain_ms:.5f} SDPA backward library_ms={lib_ms:.5f}")
        rows.append({"case": name, "ms": ms, "host_ms": h_ms,
                     "bound_ms": b_ms, "bound_by": by, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "errors": errs,
                     "shape": f"b={b} h={h} hk={hk} sq={sq} sk={sk} d={d} "
                              f"causal"})
    return rows


def flash_bwd_cases(gen, dev) -> list:
    cases = [
        flash_bwd_case("train", gen, dev, TRAIN_BATCH, 16, 16, 1024, 1024,
                       64),
        flash_bwd_case("gqa", gen, dev, 4, 16, 4, 1024, 1024, 64),
        flash_bwd_case("chunk_offset", gen, dev, 4, 16, 16, 256, 1024, 64),
    ]
    out = []
    for i, (kname, replaces) in enumerate((
            (attention.BWD_DQ_KERNEL, "apex_tpu/ops/attention.py:402"),
            (attention.BWD_DKV_KERNEL, "apex_tpu/ops/attention.py:470"))):
        rows = [c[i] for c in cases]
        # the headline numbers are the training shape's
        top = {k_: v_ for k_, v_ in rows[0].items() if k_ != "case"}
        out.append({"name": kname, "route": "cuda",
                    "source": "apex_tpu_torch/csrc/flash_bwd.cu",
                    "replaces": replaces, **top,
                    "max_abs_err": max(
                        e[0] for r in rows for e in r["errors"].values()),
                    "cases": rows})
    return out


def gpt_flat_size(cfg: GPTConfig) -> int:
    """Elements of the optimizer's flat buffers for GPT of ``cfg``
    (every parameter padded to the flat space's alignment)."""
    h, f = cfg.hidden_size, cfg.ffn
    qkv = (cfg.num_heads + 2 * cfg.kv_heads) * cfg.head_dim
    layer = [(h,), (h,), (qkv, h), (qkv,), (h, h), (h,), (h,), (h,),
             (f, h), (f,), (h, f), (h,)]
    shapes = [(cfg.vocab_size, h), (cfg.max_seq_len, h), (h,), (h,)] \
        + layer * cfg.num_layers
    return FlatSpace.create({str(i): torch.empty(s_, device="meta")
                             for i, s_ in enumerate(shapes)}).total


def adam_case(dev) -> dict:
    cfg = GPTConfig.gpt2_345m()
    n = gpt_flat_size(cfg)
    cgen = torch.Generator(device=dev).manual_seed(1)
    p = torch.randn(n, generator=cgen, device=dev)
    m = torch.randn(n, generator=cgen, device=dev).mul_(1e-3)
    v = torch.rand(n, generator=cgen, device=dev).mul_(1e-6)
    g = torch.randn(n, generator=cgen, device=dev).mul_(1e-2)
    kw = dict(lr=1e-4, weight_decay=0.01, step=3)
    want = fused_adam_update(p.clone(), m.clone(), v.clone(), g, plain=True,
                             **kw)
    got = fused_adam_update(p.clone(), m.clone(), v.clone(), g, **kw)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a.view(torch.int32), e.view(torch.int32))
                  for a, e in zip(got[:3], want[:3]))
    err = max(float((a - e).abs().max()) for a, e in zip(got[:3], want[:3]))
    del want, got
    # an inf and a nan in the gradient: found_inf set, and a step that
    # may be skipped (out of place) leaves p, m, v as they were
    bad = g.clone()
    bad[12345] = float("inf")
    bad[n - 7] = float("nan")
    before = [t.clone() for t in (p, m, v)]
    *_, found = fused_adam_update(p, m, v, bad, in_place=False, **kw)
    untouched = all(torch.equal(a, e) for a, e in zip((p, m, v), before))
    found = float(found)
    del bad, before
    print(f"  fused_adam n={n} fp32: bitwise={bitwise} max_abs_err={err:.3e}"
          f" found_inf={found} state_untouched={untouched}")
    check(bitwise, "fused_adam kernel is not bitwise equal to its plain "
          "version")
    check(found == 1.0 and untouched, "fused_adam found_inf / skip wrong")
    kernel = lambda: fused_adam_update(p, m, v, g, **kw)  # noqa: E731
    ms = host_ms(kernel, iters=20)
    plain_ms = host_ms(lambda: fused_adam_update(
        p, m, v, g, plain=True, **kw), iters=3, warmup=1)
    # the optimizer step in place against the skip-capable step (out of
    # place, plus one host read of found_inf)
    opt = FusedAdam(lr=1e-4, weight_decay=0.01)
    state = opt.init({"flat": p})
    step_ms = host_ms(lambda: opt.step_flat(state, g), iters=10)
    skip_ms = host_ms(lambda: opt.step_flat(state, g, skip_if_nonfinite=True),
                      iters=10)
    del state
    print(f"    step_flat in place {step_ms:.5f} ms, with skip_if_nonfinite "
          f"{skip_ms:.5f} ms")
    param = torch.nn.Parameter(p)
    param.grad = g
    lib = torch.optim.AdamW([param], lr=1e-4, weight_decay=0.01, fused=True)
    lib_ms = host_ms(lib.step, iters=20)
    # per element: p, m, v, g read; p, m, v written; ~16 fp32 operations
    b_ms, by = bound(28 * n, 16 * n, PEAK_FP32_FLOPS)
    print(f"    ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms={lib_ms:.5f} "
          f"(AdamW fused) bound_ms={b_ms:.5f} ({by})")
    return {"name": mt_ops.ADAM_KERNEL, "route": "cuda",
            "source": "apex_tpu_torch/csrc/fused_adam.cu",
            "replaces": "apex_tpu/multi_tensor/engine.py:243",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
            "step_flat_ms": step_ms, "step_flat_skip_ms": skip_ms,
            "shape": f"n={n} fp32 (GPT-2 345M flat buffers)"}


# -- phase 4: training at full width --------------------------------------------


def _grads(step, model, fwd, x, y):
    """The loss and the flat gradient of one forward through ``fwd``."""
    step._grad.zero_()
    loss = gpt_loss_fn(fwd(x), y)
    loss.backward()
    torch.cuda.synchronize()
    return float(loss.detach()), step._grad.clone()


def train(seed: int, dev, card: str) -> dict:
    cfg = GPTConfig.gpt2_345m()           # bf16 compute, fp32 parameters
    t0 = time.perf_counter()
    model = init_gpt_pretrain_params(
        cfg, torch.Generator().manual_seed(seed), device=dev)
    step, state = make_gpt_pretrain_step(
        cfg, FusedAdam(lr=1e-4, weight_decay=0.01))(model)
    rng = np.random.RandomState(seed)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size,
                                       (TRAIN_BATCH, cfg.max_seq_len + 1)),
                           device=dev).long()
    x, y = toks[:, :-1], toks[:, 1:]
    print(f"  GPT-2 345M: {sum(p.numel() for p in model.parameters())} "
          f"parameters, flat buffers of {state.master.numel()} fp32, "
          f"batch {TRAIN_BATCH} x {cfg.max_seq_len}, set-up "
          f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, loss = step(state, x, y)
        losses.append(float(loss))           # synchronises
        times.append(time.perf_counter() - t0)
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    step_s = float(np.median(times[2:]))
    tokens = TRAIN_BATCH * cfg.max_seq_len
    print(f"  losses {[round(v_, 4) for v_ in losses]}")
    print(f"  launches over {TRAIN_STEPS} steps {launches}")
    print(f"  training: step_ms median of the last {TRAIN_STEPS - 2} "
          f"{step_s * 1e3:.2f} (first {times[0] * 1e3:.1f}), tokens_per_s="
          f"{tokens / step_s:.0f}, peak memory {peak / 2**30:.2f} GiB "
          f"on {card}")
    check(all(np.isfinite(losses)), "non-finite training loss")
    check(losses[-1] < losses[0], "the training loss did not fall")
    path = (layer_norm.KERNEL, layer_norm.BWD_KERNEL, attention.KERNEL,
            attention.BWD_DQ_KERNEL, attention.BWD_DKV_KERNEL,
            mt_ops.ADAM_KERNEL)
    for kernel in path:
        check(launches.get(kernel, 0) > 0,
              f"kernel {kernel} never launched on the training path")

    # where the time goes: one more step under the profiler
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, loss = step(state, x, y)
        float(loss)
        p_wall = time.perf_counter() - t0
    per_kernel = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                         for e in prof.key_averages()), reverse=True)
    busy_ms = sum(t for t, _, _ in per_kernel)
    if busy_ms > 0:
        print(f"  profiled step: wall {p_wall * 1e3:.1f} ms, device busy "
              f"{busy_ms:.1f} ms ({100 * busy_ms / (p_wall * 1e3):.1f}%), "
              f"{sum(n for _, n, _ in per_kernel)} device ops; top:")
        for t, n, key in per_kernel[:12]:
            print(f"    {t:9.3f} ms {n:6d}x  {key[:90]}")
    else:
        print("  profiled step: the profiler traced no device time "
              "(breakdown not measured)")

    # the kernel path against the plain path: one loss and every
    # parameter's gradient at batch 2, on the same (trained) weights
    x2, y2 = x[:2], y[:2]
    loss_k, gk = _grads(step, model, model, x2, y2)
    loss_p, gp = _grads(step, model, model.forward_plain, x2, y2)
    worst = (0.0, "")
    plain = state.space.unpack(gp, "buffer")
    for name, a in state.space.unpack(gk, "buffer").items():
        e = plain[name]
        rel = float((a - e).norm() / e.norm().clamp_min(1e-30))
        worst = max(worst, (rel, name))
    print(f"  batch 2, kernels vs plain: loss {loss_k:.5f} vs {loss_p:.5f} "
          f"(tol {TRAIN_LOSS_TOL}); worst gradient relative L2 error "
          f"{worst[0]:.3e} in {worst[1]} (tol {TRAIN_GRAD_REL_TOL})")
    check(abs(loss_k - loss_p) <= TRAIN_LOSS_TOL,
          "training loss: kernel path disagrees with the plain path")
    check(worst[0] <= TRAIN_GRAD_REL_TOL,
          "gradients: kernel path disagrees with the plain path")
    return {"launches": launches, "steps": TRAIN_STEPS, "losses": losses,
            "step_ms": step_s * 1e3, "step_ms_all": [t * 1e3 for t in times],
            "tokens_per_s": tokens / step_s, "peak_gib": peak / 2**30,
            "batch2_loss": [loss_k, loss_p],
            "batch2_grad_rel_err": {"max": worst[0], "param": worst[1]},
            "profile": {"wall_ms": p_wall * 1e3, "device_busy_ms": busy_ms,
                        "top": [{"ms": t, "count": n, "name": key}
                                for t, n, key in per_kernel[:20]]}}


# -- phase 3: serving at full width --------------------------------------------


class _PlainModel:
    """A GPTModel whose calls run :meth:`GPTModel.forward_plain`, so a
    ``DecodeStep`` over it runs the plain versions of the kernels."""

    def __init__(self, model):
        self.model = model
        self.config = model.config

    def __call__(self, *args, **kw):
        return self.model.forward_plain(*args, **kw)


def _logit_diff(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    diff = float((got - want).abs().max())
    print(f"  request 0 {name} logits, kernels vs plain: max_abs_diff="
          f"{diff:.4f} (tol {LOGIT_TOL}, max |logit| "
          f"{float(want.abs().max()):.3f})")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite logits")
    check(diff <= LOGIT_TOL, f"{name}: kernel path disagrees with the "
          "plain path")
    return diff


def replay_steps(model, cache: KVCache, state, prompt: np.ndarray) -> dict:
    """``prompt`` through ``DecodeStep`` in chunks of PREFILL_CHUNK, then
    one decode step. The last chunk and the decode step run first through
    the plain versions, then through the kernels, at the same positions:
    each reads only the context written before it (the mask hides the
    rest), so both see the same gathered cache."""
    kern, plain = DecodeStep(model, cache), DecodeStep(_PlainModel(model),
                                                        cache)
    n = len(prompt)
    cache.allocate("replay", n + 1)
    tables = cache.table_array(["replay"], len(cache.table("replay")))
    starts = list(range(0, n, PREFILL_CHUNK))
    for st in starts[:-1]:
        kern.prefill_chunk(state, prompt[None, st:st + PREFILL_CHUNK], [st],
                           [PREFILL_CHUNK], tables)
    last = starts[-1]
    chunk = [state, prompt[None, last:], [last], [n - last], tables]
    want = plain.prefill_chunk(*chunk).logits[0]
    got = kern.prefill_chunk(*chunk).logits[0]
    diffs = {"chunk": _logit_diff(f"last chunk (start {last})", got, want)}
    step = [state, [int(torch.argmax(got))], [n], tables]
    want = plain.decode(*step).logits[0]
    got = kern.decode(*step).logits[0]
    diffs["decode"] = _logit_diff(f"decode (position {n})", got, want)
    cache.free("replay")
    return diffs


def serve(seed: int, dev, card: str) -> dict:
    cfg = GPTConfig.gpt2_345m()           # bf16 compute, fp32 parameters
    gen = torch.Generator().manual_seed(seed)
    t0 = time.perf_counter()
    model = GPTModel(cfg, device=dev, generator=gen)
    model.requires_grad_(False)
    cache = KVCache.for_config(cfg, num_blocks=8 * 1024 // 16,
                               block_size=16, device=dev)
    state = cache.init_state()
    print(f"  GPT-2 345M: {sum(p.numel() for p in model.parameters())} "
          f"parameters, KV pool {cache.pool_bytes() / 2**30:.3f} GiB, "
          f"set-up {time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in PROMPT_LENS]

    def engine():
        return ContinuousBatcher(model, cache, max_batch=8,
                                 prefill_chunk=PREFILL_CHUNK)

    # warm-up (cuBLAS handles, allocator) with one short request, uncounted
    state, _ = serve_loop(engine(), state,
                          [Request(id="warm", prompt=prompts[1][:16],
                                   max_new_tokens=2)])
    torch.cuda.synchronize()
    cache.reset_prefix_cache()      # the counted run starts with no hits
    batcher = engine()
    requests = [Request(id=i, prompt=p, max_new_tokens=MAX_NEW)
                for i, p in enumerate(prompts)]
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    state, results = serve_loop(batcher, state, requests)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.launch_counts()
    steps = batcher.step_idx
    check(len(results) == len(requests), "not every request finished")
    for r in results:
        check(r.finish_reason == "length" and len(r.tokens) == MAX_NEW,
              f"request {r.id} finished with {r.finish_reason}, "
              f"{len(r.tokens)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"request {r.id}: token out of range")
    for kernel in (layer_norm.KERNEL, attention.KERNEL):
        check(launches.get(kernel, 0) > 0,
              f"kernel {kernel} never launched on the serving path")
    check(cache.blocks_in_use == 0, "KV blocks leaked")
    tokens = sum(len(r.tokens) for r in results)
    ttfts = np.array([r.ttft_s for r in results]) * 1e3
    tpots = np.array([r.tpot_s for r in results]) * 1e3
    ttft, tpot = float(ttfts.mean()) / 1e3, float(tpots.mean()) / 1e3
    print(f"  served {len(results)} requests, {tokens} tokens in {wall:.3f} s "
          f"over {steps} engine steps; launches {launches}")
    print(f"  serving: tokens_per_s={tokens / wall:.1f} "
          f"mean_ttft_ms={ttft * 1e3:.2f} mean_tpot_ms={tpot * 1e3:.2f} "
          f"on {card}")
    # eight samples: the median and the maximum, no tail percentile
    print(f"  ttft_ms median {np.median(ttfts):.2f} max {ttfts.max():.2f}; "
          f"tpot_ms median {np.median(tpots):.2f} max {tpots.max():.2f}")

    # the first request's prompt (700 tokens) through the kernels and
    # through their plain versions. Both run the same bf16 model; they
    # differ in LayerNorm rounding (1 bf16 ulp) and in the kernel's bf16
    # P, compounded over 24 residual layers, hence LOGIT_TOL.
    toks = torch.as_tensor(prompts[0][None], device=dev).long()
    with torch.no_grad():
        got = model(toks)[-1, 0]
        want = model.forward_plain(toks)[-1, 0]
    diffs = {"prefill": _logit_diff("prefill", got, want)}
    diffs.update(replay_steps(model, cache, state, prompts[0]))
    # the served first token came through the chunk path in a batch of
    # four; it may differ from the plain argmax only where the two plain
    # logits are closer than the paths may disagree
    first = results[[r.id for r in results].index(0)].tokens[0]
    top = int(torch.argmax(want))
    gap = float(want[top] - want[first])
    print(f"  request 0 served first token {first}, plain argmax {top}, "
          f"plain logit gap {gap:.4f} (tol {2 * LOGIT_TOL})")
    check(first == top or gap <= 2 * LOGIT_TOL,
          "served first token is not the plain path's argmax")

    # where the time goes: the same eight requests again under the
    # profiler (device activity only), after the counted run, from the
    # same empty prefix cache
    torch.cuda.synchronize()
    cache.reset_prefix_cache()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        state, _ = serve_loop(engine(), state, requests)
        torch.cuda.synchronize()
        p_wall = time.perf_counter() - t0
    per_kernel = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                         for e in prof.key_averages()), reverse=True)
    busy_ms = sum(t for t, _, _ in per_kernel)
    if busy_ms > 0:
        print(f"  profiled re-run: wall {p_wall * 1e3:.1f} ms, device busy "
              f"{busy_ms:.1f} ms ({100 * busy_ms / (p_wall * 1e3):.1f}%), "
              f"{sum(n for _, n, _ in per_kernel)} device ops; top:")
        for t, n, key in per_kernel[:10]:
            print(f"    {t:9.3f} ms {n:6d}x  {key[:90]}")
    else:
        print("  profiled re-run: the profiler traced no device time "
              "(breakdown not measured)")
    return {"launches": launches, "steps": steps, "tokens_per_s":
            tokens / wall, "mean_ttft_ms": ttft * 1e3,
            "mean_tpot_ms": tpot * 1e3, "wall_s": wall,
            "ttft_ms": ttfts.tolist(), "tpot_ms": tpots.tolist(),
            "logit_max_abs_diff": diffs,
            "profile": {"wall_ms": p_wall * 1e3, "device_busy_ms": busy_ms,
                        "top": [{"ms": t, "count": n, "name": key}
                                for t, n, key in per_kernel[:20]]}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write every number to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 LM head in fp32
    torch.backends.cudnn.allow_tf32 = False

    print("phase 1: environment")
    card = card_line()
    print(card)
    print(f"  torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    secs = _build.build_all()
    print(f"  built {', '.join(_build.SOURCES)} in {secs:.1f} s")
    for src in _build.SOURCES:
        for line in _build.build_log(src).splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {src}: {line.strip()}")

    print("phase 2: kernels against their plain versions")
    gen = torch.Generator().manual_seed(args.seed)
    with torch.no_grad():
        # the serving path's rows (prefill of 8 x 512), then the
        # training path's (8 x 1024); the headline is the serving one's
        ln = layer_norm_case(gen, dev, 8 * 512)
        ln["cases"] = [layer_norm_case(gen, dev, TRAIN_BATCH * 1024)]
        fl = flash_cases(gen, dev)
        ln_bwd = layer_norm_bwd_case(gen, dev)
        fl_bwd = flash_bwd_cases(gen, dev)
        adam = adam_case(dev)
    torch.cuda.empty_cache()

    print("phase 3: serving GPT-2 345M")
    srv = serve(args.seed, dev, card)
    torch.cuda.empty_cache()

    print("phase 4: training GPT-2 345M")
    trn = train(args.seed, dev, card)
    kernels = [ln, fl, ln_bwd, *fl_bwd, adam]
    for k in kernels:
        # the forward kernels run on both paths: their launches are the
        # serving run's, with the training run's beside them
        serving = any(k is x for x in (ln, fl))
        run = srv if serving else trn
        k["path"] = "serving" if serving else "training"
        k["launches"] = run["launches"].get(k["name"], 0)
        k["launches_per_step"] = k["launches"] / max(run["steps"], 1)
        k["launches_training"] = trn["launches"].get(k["name"], 0)

    print("phase 5: kernels")
    line = {"kernels": kernels}
    print(json.dumps(line))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "build_s": secs, "serving": srv,
                       "training": trn, **line}, f, indent=1)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
