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
   was). Then the LAMB kernels on GPT-2 345M's buffers: both
   sum-of-squares kernels (an injected inf and nan set found_inf), LAMB
   stage 1 (u, m', v' bitwise) and stage 2 (p' bitwise) over the plain
   flat space, the one-pass segment kernel over the segmented layout with
   the p stash on and off and with the grad norms (m', v' bitwise), and
   ``FusedLAMB.step_flat``: segmented (FusedLAMB's layout, and the same
   at the reference rule's segment size) and two-stage. Then the four
   softmax kernels: the masked forward at BERT-Large's scores (8, 16,
   512, 512) bf16 with its padded outer-product mask (mask batch 8, and
   broadcast from 1), the scaled forward at the same shape, the causal
   forward at GPT-2 345M's (128, 1024, 1024), the shared backward at
   both; forwards within one bf16 ulp elementwise, the backward within
   one bf16 ulp of each row's largest |dx|. Then the SGD and LARS kernels
   over ResNet-50's flat buffers (25.7 M fp32): SGD bitwise with
   momentum, first run, nesterov, dampening with the weight decay after
   momentum, no momentum, and a device scale and first-run flag; an inf
   and a nan set found_inf and the out-of-place step leaves the state
   as it was; LARS bitwise given the same ratios, the whole update
   (norms on the sum-of-squares kernel) within LARS_TOL of the plain
   one; the library yardstick is ``torch.optim.SGD(fused=True)`` over
   the same 161 tensors (LARS has none). Then the scale, axpby, Adagrad
   and NovoGrad kernels over GPT-2 345M's flat buffers (355 M fp32):
   scale bitwise for fp32, bf16 and fp16 in and out with a host and a
   device factor (an inf, a nan and an fp16 output that overflows set
   found_inf); axpby bitwise (host and device a, b; bf16 x; bf16 and
   fp16 out), found_inf over x, y or both as ``arg_to_check`` says;
   Adagrad bitwise with weight decay and a host and a device grad_scale;
   NovoGrad bitwise given the same per-leaf denominators, the whole
   update (norms on the sum-of-squares kernel) within NOVOGRAD_TOL of
   the plain one; an inf and a nan set found_inf and the out-of-place
   calls leave their inputs as they were. Library yardsticks:
   ``torch.mul(x, s, out=y)`` for scale, ``torch.optim.Adagrad`` (fused
   where the card's PyTorch takes it, else foreach) over the GPT's
   tensors; none for axpby and NovoGrad. Then the cross-entropy kernels
   at GPT-2 345M's (8 x 1024, 50304) logits, fp32 and bf16, smoothing
   0.1 and 0, padded label rows: loss and lse within XENT_FWD_TOL, dx
   bitwise given the same lse, padding rows exactly 0 (library:
   ``F.cross_entropy`` with ``label_smoothing`` and ``ignore_index``,
   forward and backward); and the RoPE kernel, forward and the -sin
   backward bitwise, at Llama-2-7B's sbhd in bf16 and fp32, GPT-NeoX-20B's
   cached and the packed thd layout (no library call).
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
5. Training at full width with FusedLAMB: ``make_gpt_pretrain_step(cfg,
   FusedLAMB(lr, weight_decay=0.01, max_grad_norm=1.0))``, ten steps on
   one batch of 8 x 1024 tokens with the launch counts set to 0 just
   before and read just after (every kernel of the path must have
   launched: LayerNorm, flash attention, the sum of squares of the clip,
   the segment pass, LAMB stages 1 and 2); the loss must be finite and
   fall. Step time, tokens/s, peak memory, one profiled step with the
   optimizer's share. Then one ``make_train_step(opt, scaler=...,
   with_grad_norm=True)`` step on the real gradient (counts reset: the
   scaled sum of squares must launch; the norm must match the plain
   norm), one with an inf (skipped, state unchanged, scale halved), and
   one LAMB update through the kernels and their plain versions.
6. BERT-Large pretraining (``BertConfig.bert_large()``: vocab 30528,
   seq 512, hidden 1024, 24 layers, 16 heads, bf16 compute, fp32
   parameters, random weights from the seed) through
   ``PretrainStep(model, FusedLAMB(lr=1e-4, weight_decay=0.01,
   max_grad_norm=1.0, use_nvlamb=True), loss_fn=...)`` on one batch of 8
   x 512 with real lengths 512, 448, 384, 320, 512, 256, 480 and 200. At
   batch 2 on the initial weights: the kernel path's loss and every
   gradient against ``forward_plain`` (softmax backend) and the softmax
   backend's loss against the flash backend's. Then ten steps on the
   softmax backend and ten on the flash backend from the same weights,
   launch counts set to 0 just before and read just after each: the
   softmax run launches the masked forward and the backward 24 times a
   step, LayerNorm and the LAMB kernels, and no flash kernel; the flash
   run the flash kernels and no softmax kernel. Losses finite and
   falling; step time, tokens/s (padded and real), peak memory and one
   profiled step each with the softmax kernels' and the optimizer's
   share. Then ``FusedScaleMaskSoftmax`` without a mask, forward and
   backward, which no model path calls: the scaled forward's launches.
7. GPT-2 345M on ``attention_backend="softmax"`` with FusedAdam: at
   batch 2 the kernel path's loss and gradients against the plain path's
   and its loss against the flash backend's on the same weights; then
   three steps at 8 x 1024, the causal forward and the backward launched
   24 times a step and no flash kernel.
8. ResNet-50 ImageNet training (``ResNetConfig.resnet50()``: bottleneck
   blocks (3, 4, 6, 3), width 64, 1000 classes, fp32 parameters, random
   weights from the seed) on one synthetic batch of 128 x 224 x 224 x 3
   through ``PretrainStep(model, opt, loss_fn=...)``. First the fp32
   forward at batch 2 against the same model and weights on the CPU
   (cuDNN with TF32 off: ``main`` sets ``allow_tf32 = False``), within
   RESNET_FP32_TOL. Then four runs, each with the launch counts set to 0
   just before and read just after, and one profiled step (conv, BN,
   casts and optimizer shares): FusedSGD(lr 0.1, momentum 0.9, weight
   decay 1e-4) with bf16 compute, 10 steps; amp O2 (fp16 compute, fp32
   master, ``amp.initialize`` and the dynamic scaler of ``make_scaler``
   through ``make_train_step``), 10 steps, then one with an inf in the
   gradient, which must be skipped with master and momentum exactly as
   they were; FusedLARS and LARC(FusedSGD), 3 steps each. Losses finite,
   the first update lowering the loss (at lr 0.1 and momentum 0.9 the
   loss on one fixed batch then climbs again, as the reference's does),
   running statistics finite, ``fused_sgd`` once a step
   (``fused_lars`` once and ``sumsq`` twice on the LARS run). Step time
   (median of steps 3-10, 2-3 on the short runs), images/s, peak memory.
9. GPT-2 345M (phase 4's model, weights and batch of 8 x 1024) with
   (a) ``FusedNovoGrad(lr=1e-2, betas=(0.95, 0.98), weight_decay=1e-3)``
   and the contrib clip, the reference user's loop (``PretrainStep.
   backward``, ``clip_grad_norm_(step.grad, 1.0)`` on the flat gradient,
   ``step_flat``), ten steps: ``sumsq`` twice a step (the clip's norm and
   NovoGrad's per-leaf norms), ``multi_tensor_scale`` and
   ``fused_novograd`` once; the loss must fall; and (b)
   ``make_train_step(FusedAdagrad(lr=1e-3, weight_decay=0.01),
   scaler=LossScaler(), max_grad_norm=1.0)`` through ``PretrainStep``,
   three steps: ``sumsq_scaled`` and ``fused_adagrad`` once a step; the
   first update must lower the loss; then one step with an inf in the
   gradient, skipped with master and h bitwise unchanged and the scale
   halved. Launch counts are set to 0 just before each run and read
   just after. Each: step time, tokens/s, peak memory, one profiled step
   with the optimizer's share, one update through the kernels against
   their plain versions on the real gradient; then one gradient
   accumulation of two real gradients through ``multi_tensor_axpby``
   (counts reset: no model path calls it).
10. The slice's paths at full width: (a) GPT-2 345M (phase 4's model,
   weights and batch of 8 x 1024) with the contrib xentropy loss,
   ``softmax_cross_entropy(logits, labels.T, smoothing=0.1,
   padding_idx=0)`` summed and divided by the count of real labels (the
   labels' tails padded on rows of 1024, 1024, 900, 1024, 700, 1024,
   1024 and 512 real labels), through ``PretrainStep(model,
   FusedAdam(lr=1e-4, weight_decay=0.01), loss_fn=...)``: at batch 2 on
   the initial weights the loss and every gradient through the kernels
   against the plain versions, then ten steps with the launch counts set
   to 0 just before and read just after (``xentropy_fwd``,
   ``xentropy_bwd`` and Adam once a step; the loss must fall), step time
   beside phase 4's, tokens/s, peak memory, one profiled step with the
   xentropy kernels' share; (b) RoPE on q and k with a backward through
   both, at Llama-2-7B's sbhd (4096, 2, 32, 128), eight packed sequences
   of 8,192 tokens (thd) at its heads, and GPT-NeoX-20B's cached (2048,
   4, 64, 96) with 24 rotated channels: four launches a variant, outputs
   and gradients bitwise against the plain version.
11. Each phase's wall seconds, the ``kernels`` JSON line (all twenty-four
   kernels, each with its launches on its path), then the device line
   the caller reads.

Needs a CUDA device and ``nvcc`` (``$CUDA_HOME`` or
``/usr/local/cuda``); exits 1 without printing a result otherwise.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch import _build, amp
from apex_tpu_torch.contrib.clip_grad import clip_grad_norm_
from apex_tpu_torch.models import (
    BertConfig,
    BertModel,
    GPTConfig,
    GPTModel,
    PretrainStep,
    ResNet,
    ResNetConfig,
    bert_extended_attention_mask,
    bert_loss_fn,
    cross_entropy_logits,
    gpt_loss_fn,
    init_gpt_pretrain_params,
    make_gpt_pretrain_step,
)
from apex_tpu_torch.amp import LossScaler
from apex_tpu_torch.multi_tensor import (
    FlatSpace,
    fused_adam_update,
    fused_lamb_segmented_update,
    fused_unscale_l2norm,
)
from apex_tpu_torch.multi_tensor import engine
from apex_tpu_torch.multi_tensor import ops as mt_ops
from apex_tpu_torch.multi_tensor.segmented import SEGMENT_KERNEL
from apex_tpu_torch.models.gpt import KERNEL_OPS, PLAIN_OPS
from apex_tpu_torch.contrib.xentropy import softmax_cross_entropy
from apex_tpu_torch.ops import attention, layer_norm, rope, softmax, xentropy
from apex_tpu_torch.transformer.functional import (
    FusedScaleMaskSoftmax,
    fused_apply_rotary_pos_emb,
    fused_apply_rotary_pos_emb_cached,
    fused_apply_rotary_pos_emb_thd,
)
from apex_tpu_torch.optimizers import (
    FusedAdagrad,
    FusedAdam,
    FusedLAMB,
    FusedLARS,
    FusedNovoGrad,
    FusedSGD,
    make_train_step,
)
from apex_tpu_torch.parallel import LARC
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
# per-tile and per-subtile sums of squares, kernels against plain: fp32
# sums of up to 65,536 squares in another order
SUMSQ_REL_TOL = 1e-5
# the segment pass's p', relative to each element's step |p - p'| (plus
# one rounding of p'): its trust ratios come from per-slot sums taken in
# another order
SEG_P_REL_TOL = 1e-5
# the scaler step's global grad norm against a float64 norm of the same
# gradient
GRAD_NORM_REL_TOL = 1e-5
# one LAMB update, kernels against plain versions, trust ratios from sums
# in other orders (relative ~1e-7): with one clip factor, every element's
# |dp'| within this share of its step plus one rounding of p'. With each
# side's own clip factor (one bit apart, relative ~6e-8 in m', v'), m'
# and v' within this share of their largest |value|, and |dp'| within
# this share of its parameter's largest step plus one rounding: where
# u's two terms cancel, the bit moves an element's step by more than
# this share of itself
LAMB_PARAM_TOL = 1e-5
LAMB_LR = 1e-3
# the softmax forward kernels against their plain versions: one bf16 ulp
# of the value (2^-7 of the larger |y|; both round the same fp32 softmax
# once, its sums taken in other orders). The backward: one bf16 ulp of
# each row's largest |dx| (dot = sum(g * y) is summed in another order,
# and where g and dot nearly cancel that moves dx by a share of the row's
# scale rather than of the element)
SOFTMAX_FWD_TOL = 2.0 ** -7
SOFTMAX_BWD_TOL = 2.0 ** -7
BERT_STEPS = 10
GPT_SOFTMAX_STEPS = 3
# BERT-Large at batch 2, kernels against plain versions: its loss reads
# 144 MLM positions and 2 NSP samples (GPT's 2048 tokens), so the same
# one-ulp rounding differences move it ~4x more. On an H100 the
# LayerNorm kernel alone (held to its plain version since PR 1) moved
# the loss 2.0e-3 and the gradients up to 4.5% (median 2.9%) relative
# L2; the softmax kernel alone moved the loss 9.2e-5 and is also held to
# TRAIN_LOSS_TOL. These are 2.5x and 2.2x the LayerNorm kernel's reading
BERT_LOSS_TOL = 5e-3
BERT_GRAD_REL_TOL = 0.1
# two attention backends on the same weights at batch 2, bf16 through 24
# layers: the softmax backend rounds the scores and the probabilities to
# bf16, flash rounds P to bf16 inside its tiles
BACKEND_LOSS_TOL = 5e-3

# ResNet-50 training (phase 8): the reference bench's batch and size
# (bench.py:709-714) and its optimizer settings (bench.py:730)
RESNET_BATCH, RESNET_HW = 128, 224
RESNET_SGD = dict(lr=0.1, momentum=0.9, weight_decay=1e-4)
RESNET_STEPS, RESNET_LARS_STEPS = 10, 3
# the card's fp32 forward (cuDNN, TF32 off) against the CPU's on the same
# weights at batch 2, relative to the largest |logit| and per running
# statistic: fp32 sums in other orders (cuDNN may pick Winograd or FFT
# algorithms, whose fp32 error exceeds a direct sum's) move them ~1e-5;
# a window shifted by a padding or read through a wrong layout moves them
# by their own scale
RESNET_FP32_TOL = 1e-3
# a full LARS update, kernels against plain versions: the ratios come
# from sums of squares in other orders (relative ~1e-7). mom' within this
# share of its terms (|mu * mom| + |mom'|), p' within lr times that plus
# one ulp of the larger of |p| and |p'|
LARS_TOL = 1e-6
# GPT-2 345M with FusedNovoGrad and the clip, then FusedAdagrad under the
# dynamic loss scaler (phase 9): the reference user's settings
# (FusedNovoGrad's defaults: grad averaging, no bias correction)
NOVOGRAD_LR, NOVOGRAD_BETAS, NOVOGRAD_WD = 1e-2, (0.95, 0.98), 1e-3
NOVOGRAD_STEPS, ADAGRAD_STEPS = 10, 3
ADAGRAD_LR = 1e-3
CLIP_NORM = 1.0
# a full NovoGrad update, kernels against plain versions: the per-leaf
# norms are fp32 sums in other orders, the largest leaf (the embedding,
# 51.5 M elements) summing 25,152 subtile partials through atomics in no
# fixed order (an H100 read 3.2e-6 relative on v'), as SUMSQ_REL_TOL. v'
# within this share of itself, m' within this share of its terms (|b1 m|
# + |m'| + |wd p|) plus one ulp, p' within lr / bc1 times that plus one
# ulp of the larger of |p| and |p'|
NOVOGRAD_TOL = 1e-5

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


def _profiled(run, label: str, shares: dict):
    """One call of ``run`` under the profiler (device activity): returns
    its result and a dict of the wall, the device-busy ms and, for each
    entry of ``shares`` (name -> substrings of kernel names; a kernel
    counts in the first entry it matches), its device ms and share of
    the busy time."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    per_kernel = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                         for e in prof.key_averages()), reverse=True)
    busy = sum(t for t, _, _ in per_kernel)
    part = dict.fromkeys(shares, 0.0)       # each kernel in its first match
    matched = []
    for t, n, key in per_kernel:
        for k, keys in shares.items():
            if any(x in key for x in keys):
                part[k] += t
                matched.append({"share": k, "ms": t, "count": n,
                                "name": key[:90]})
                break
    if busy > 0:
        print(f"  profiled {label}: wall {wall * 1e3:.1f} ms, device busy "
              f"{busy:.1f} ms ({100 * busy / (wall * 1e3):.1f}%); "
              + ", ".join(f"{k} {v:.3f} ms ({100 * v / busy:.2f}%)"
                          for k, v in part.items()) + "; top:")
        for t, n, key in per_kernel[:10]:
            print(f"    {t:9.3f} ms {n:6d}x  {key[:90]}")
        print("    in the shares: " + "; ".join(
            f"{m['name'][:40]} {m['ms']:.3f} ms {m['count']}x"
            for m in matched[:8]))
    else:
        print(f"  profiled {label}: the profiler traced no device time "
              "(breakdown not measured)")
    return result, {"wall_ms": wall * 1e3, "device_busy_ms": busy,
                    **{f"{k}_ms": v for k, v in part.items()},
                    "matched": matched,
                    "top": [{"ms": t, "count": n, "name": key}
                            for t, n, key in per_kernel[:20]]}


def _train_loop(step, state, batch, steps: int):
    """``steps`` steps with the launch counts set to 0 just before and
    read just after: (state, losses, seconds per step, launches)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    losses, times = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, loss = step(state, *batch)
        losses.append(float(loss))           # synchronises
        times.append(time.perf_counter() - t0)
    return state, losses, times, _build.launch_counts()


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


def gpt_leaves(cfg: GPTConfig) -> dict:
    """GPT of ``cfg``'s parameters in module order, as shapes on the meta
    device (the flat layouts need only their order and sizes)."""
    h, f = cfg.hidden_size, cfg.ffn
    qkv = (cfg.num_heads + 2 * cfg.kv_heads) * cfg.head_dim
    layer = [(h,), (h,), (qkv, h), (qkv,), (h, h), (h,), (h,), (h,),
             (f, h), (f,), (h, f), (h,)]
    shapes = [(cfg.vocab_size, h), (cfg.max_seq_len, h)] \
        + layer * cfg.num_layers + [(h,), (h,)]
    return {f"{i:03d}": torch.empty(s_, device="meta")
            for i, s_ in enumerate(shapes)}


def gpt_flat_size(cfg: GPTConfig) -> int:
    """Elements of the optimizer's plain flat buffers for GPT of ``cfg``
    (every parameter padded to the flat space's alignment)."""
    return FlatSpace.create(gpt_leaves(cfg)).total


def _seeded(n, dev, seed, scale=1.0, positive=False):
    gen = torch.Generator(device=dev).manual_seed(seed)
    t = (torch.rand(n, generator=gen, device=dev) if positive
         else torch.randn(n, generator=gen, device=dev))
    return t.mul_(scale)


def sumsq_cases(dev) -> list:
    """#7 and #8 over a GPT-2 345M-sized flat gradient, per-tile partials
    against the plain version; an inf and a nan must set found_inf."""
    n = gpt_flat_size(GPTConfig.gpt2_345m())
    g = _seeded(n, dev, 2, 1e-2)
    scale = torch.tensor(1.0 / 1024, device=dev)
    rows = []
    for name, sc, ops in ((engine.SUMSQ_KERNEL, None, 2),
                          (engine.SUMSQ_SCALED_KERNEL, scale, 3)):
        got = engine.fused_sumsq_partials(g, scale=sc)
        want = engine.fused_sumsq_partials(g, scale=sc, plain=True)
        again = engine.fused_sumsq_partials(g, scale=sc)
        torch.cuda.synchronize()
        rel = float(((got - want).abs() / want.abs()).max())
        err = float((got - want).abs().max())
        deterministic = torch.equal(got, again)
        print(f"  {name} n={n} fp32 tiles of 65536: max_abs_err={err:.3e} "
              f"max_rel_err={rel:.3e} (tol {SUMSQ_REL_TOL}) "
              f"deterministic={deterministic}")
        check(rel <= SUMSQ_REL_TOL and deterministic,
              f"{name} kernel disagrees with its plain version")
        kernel = lambda sc=sc: engine.fused_sumsq_partials(  # noqa: E731
            g, scale=sc)
        ms, h_ms = device_ms(kernel), host_ms(kernel)
        plain_ms = device_ms(lambda sc=sc: engine.fused_sumsq_partials(
            g, scale=sc, plain=True), iters=5)
        lib_ms = device_ms(lambda: torch.linalg.vector_norm(g))
        b_ms, by = bound(nbytes(g, got), ops * n, PEAK_FP32_FLOPS)
        print(f"    ms={ms:.5f} host_ms={h_ms:.5f} plain_ms={plain_ms:.5f} "
              f"library_ms={lib_ms:.5f} (vector_norm) bound_ms={b_ms:.5f} "
              f"({by})")
        rows.append({"name": name, "route": "cuda",
                     "source": "apex_tpu_torch/csrc/sumsq.cu",
                     "replaces": "apex_tpu/multi_tensor/engine.py:"
                                 + ("519" if sc is None else "543"),
                     "max_abs_err": err, "max_rel_err": rel, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
                     "library_ms": lib_ms, "host_ms": h_ms,
                     "shape": f"n={n} fp32, 65536-element tiles"})
    found = []
    for bad in (float("inf"), float("nan")):
        b = g.clone()
        b[n // 3] = bad
        found.append(float(fused_unscale_l2norm(b)[1]))
        del b
    print(f"  fused_unscale_l2norm found_inf with an inf, a nan: {found}")
    check(found == [1.0, 1.0], "found_inf not set by an inf or a nan")
    return rows


def lamb_stage_cases(dev) -> list:
    """LAMB stage 1 (u, m', v' bitwise; partials) and stage 2 (p'
    bitwise) over GPT-2 345M's plain flat space, against their plain
    versions, out of place."""
    space = FlatSpace.create(gpt_leaves(GPTConfig.gpt2_345m()))
    n = space.total
    p = _seeded(n, dev, 3, 2e-2)
    m = _seeded(n, dev, 4, 1e-3)
    v = _seeded(n, dev, 5, 1e-6, positive=True)
    g = _seeded(n, dev, 6, 1e-2)
    inv = torch.tensor(1.75, device=dev)   # a clip factor on the device
    kw = dict(beta1=0.9, beta2=0.999, beta3=0.1, eps=1e-6,
              weight_decay=0.01, bias_correction1=0.271,
              bias_correction2=0.002997, adam_w_mode=True, inv_scale=inv,
              with_norm_partials=True, with_grad_partials=True,
              in_place=False)
    got, f = mt_ops.fused_lamb_compute_update_term(p, m, v, g, **kw)
    want, wf = mt_ops.fused_lamb_compute_update_term(p, m, v, g, plain=True,
                                                     **kw)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                  for a, b in zip(got[:3], want[:3]))
    err = max(float((a - b).abs().max()) for a, b in zip(got[:3], want[:3]))
    part_rel = max(float(((a.sum(-1) - b.sum(-1)).abs()
                          / b.sum(-1).abs().clamp_min(1e-30)).max())
                   for a, b in zip(got[3:], want[3:]))
    print(f"  {mt_ops.LAMB_STAGE1_KERNEL} n={n} fp32: u/m'/v' bitwise="
          f"{bitwise} max_abs_err={err:.3e}; p/u/g partials max_rel_err="
          f"{part_rel:.3e} (tol {SUMSQ_REL_TOL}); found={float(f)}")
    check(bitwise and part_rel <= SUMSQ_REL_TOL and float(f) == 0.0,
          "lamb_stage1 kernel disagrees with its plain version")
    del want
    s1 = lambda: mt_ops.fused_lamb_compute_update_term(  # noqa: E731
        p, m, v, g, **kw)
    rows = []
    ms, h_ms = device_ms(s1, iters=5, replays=3), host_ms(s1, iters=5)
    plain_ms = host_ms(lambda: mt_ops.fused_lamb_compute_update_term(
        p, m, v, g, plain=True, **kw), iters=2, warmup=1)
    # p, m, v, g read; u, m', v' written; three partials per subtile
    b_ms, by = bound(28 * n + 12 * (n // 2048), 22 * n, PEAK_FP32_FLOPS)
    print(f"    ms={ms:.5f} host_ms={h_ms:.5f} plain_ms={plain_ms:.5f} "
          f"library_ms=none bound_ms={b_ms:.5f} ({by})")
    rows.append({"name": mt_ops.LAMB_STAGE1_KERNEL, "route": "cuda",
                 "source": "apex_tpu_torch/csrc/fused_lamb.cu",
                 "replaces": "apex_tpu/multi_tensor/engine.py:243",
                 "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b_ms, "bound_by": by, "library_ms": None,
                 "host_ms": h_ms, "shape": f"n={n} fp32 (GPT-2 345M plain "
                                           "flat space), with p/u/g partials"})
    u = got[0]
    del got
    ratio = torch.rand(space.num_leaves, device=dev).add_(0.5)
    ids = space.device_subtile_leaf_ids(dev)
    s2 = lambda plain=False: mt_ops.lamb_apply(  # noqa: E731
        p, u, ratio, lr=1e-3, tile_ids=ids, in_place=False, plain=plain)
    a, b = s2(), s2(True)
    torch.cuda.synchronize()
    bitwise2 = torch.equal(a.view(torch.int32), b.view(torch.int32))
    err2 = float((a - b).abs().max())
    print(f"  {mt_ops.LAMB_STAGE2_KERNEL} n={n} fp32, {space.num_leaves} "
          f"per-leaf ratios on the device: p' bitwise={bitwise2} "
          f"max_abs_err={err2:.3e}")
    check(bitwise2, "lamb_stage2 kernel disagrees with its plain version")
    del a, b
    ms, h_ms = device_ms(s2, iters=5, replays=3), host_ms(s2, iters=5)
    plain_ms = host_ms(lambda: s2(True), iters=2, warmup=1)
    b_ms, by = bound(12 * n + 4 * (n // 2048), 3 * n, PEAK_FP32_FLOPS)
    print(f"    ms={ms:.5f} host_ms={h_ms:.5f} plain_ms={plain_ms:.5f} "
          f"library_ms=none bound_ms={b_ms:.5f} ({by})")
    rows.append({"name": mt_ops.LAMB_STAGE2_KERNEL, "route": "cuda",
                 "source": "apex_tpu_torch/csrc/fused_lamb.cu",
                 "replaces": "apex_tpu/multi_tensor/engine.py:243",
                 "max_abs_err": err2, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b_ms, "bound_by": by, "library_ms": None,
                 "host_ms": h_ms, "shape": f"n={n} fp32, per-leaf ratios"})
    return rows


def segment_layout(cfg: GPTConfig, seg_elems=None):
    """FusedLAMB's segmented layout for GPT of ``cfg`` (its own segment
    size, or ``seg_elems``), and its numbers: the segmented total against
    the plain one; the elements the segment pass sweeps, those in live
    slots and the parameters among them; the large leaves' elements."""
    leaves = gpt_leaves(cfg)
    space, meta = FusedLAMB(seg_elems=seg_elems).layout(leaves)
    plain = FlatSpace.create(leaves).total
    small = len(meta.small_segments) * meta.seg_elems
    large = sum(plen for _, _, plen in meta.large)
    large_ids = {l_ for l_, _, _ in meta.large}
    real_small = sum(space.sizes[i] for i in range(space.num_leaves)
                     if i not in large_ids)
    real_large = sum(space.sizes[i] for i in large_ids)
    live = int((meta.slot_ids >= 0).sum()) * 2048
    info = {"seg_elems": meta.seg_elems, "stash_p": meta.stash_p,
            "segmented_total": space.total, "plain_total": plain,
            "small_segments": len(meta.small_segments),
            "large_leaves": len(meta.large), "elements_small_segments": small,
            "elements_in_live_slots": live,
            "parameters_in_small_leaves": real_small,
            "elements_large_leaves": large,
            "parameters_in_large_leaves": real_large,
            "max_slots": meta.max_slots}
    print(f"  segmented layout: seg_elems={meta.seg_elems} "
          f"stash_p={meta.stash_p}, total {space.total} against the plain "
          f"{plain} (+{100 * (space.total / plain - 1):.3f}%); "
          f"{len(meta.small_segments)} small segments ({small} elements "
          f"swept, {live} in live slots, {real_small} parameters), "
          f"{len(meta.large)} large leaves ({large} elements for "
          f"{real_large} parameters)")
    return space, meta, info


def segment_cases(dev) -> dict:
    """The segment pass on GPT-2 345M's segmented layout at FusedLAMB's
    default seg_elems, stash_p on and off, with_grad_norm: m' and v'
    bitwise, p' (on every parameter of the small leaves) and the
    per-slot grad sums within tolerance; an inf in a small segment sets
    found_inf. Then ``FusedLAMB.step_flat`` on the segmented layout, on
    the layout at the reference rule's segment size and two-stage."""
    from apex_tpu_torch.multi_tensor.segmented import _small_segment_pass
    cfg = GPTConfig.gpt2_345m()
    space, meta, info = segment_layout(cfg)
    n = space.total
    p = _seeded(n, dev, 7, 2e-2)
    m = _seeded(n, dev, 8, 1e-3)
    v = _seeded(n, dev, 9, 1e-6, positive=True)
    g = _seeded(n, dev, 10, 1e-2)
    scal = (0.9, 0.999, 0.1, 1e-6, 0.01, 0.271, 0.002997, 1.0)
    inv = torch.tensor(1.75, device=dev)
    outs = [torch.empty_like(p) for _ in range(3)]
    ref = [torch.empty_like(p) for _ in range(3)]
    large_ids = {l_ for l_, _, _ in meta.large}
    live = torch.cat([torch.arange(off, off + size, device=dev)
                      for i, (off, size) in enumerate(zip(space.offsets,
                                                          space.sizes))
                      if i not in large_ids])
    real = info["parameters_in_small_leaves"]
    swept = info["elements_small_segments"]
    cases, worst = [], 0.0
    for stash in (True, False):
        for with_gn in (False, True):
            for o, r in zip(outs + ref, (p, m, v) * 2):
                o.copy_(r)
            kw = dict(meta=meta, scalars=scal, inv_scale=inv, lr=1e-3,
                      use_nvlamb=False, wd_is_zero=False, stash_p=stash,
                      with_grad_norm=with_gn)
            f, gg = _small_segment_pass(p, m, v, g, outs, **kw)
            wf, wgg = _small_segment_pass(p, m, v, g, ref, plain=True, **kw)
            torch.cuda.synchronize()
            bitwise = all(torch.equal(a.view(torch.int32),
                                      b.view(torch.int32))
                          for a, b in zip(outs[1:], ref[1:]))
            want, p_in, got = ref[0][live], p[live], outs[0][live]
            step = (p_in - want).abs()
            diff = (got - want).abs()
            ulp = 2.0 ** -23 * torch.maximum(got.abs(), want.abs())
            # beyond the stated share of each parameter's step, at most
            # one rounding of p' (an element whose step is below an ulp
            # of p' moves by an ulp when its ratio's last bit moves; the
            # ulp of the larger value, as the two may round into
            # neighbouring binades)
            p_excess = float((diff - SEG_P_REL_TOL * step - ulp).max())
            p_rel = float((diff / (step + 1e-30)).max())
            p_rel_ulp = float((diff / (step + ulp + 1e-30)).max())
            gg_rel = (float(((gg - wgg).abs() / wgg.abs().clamp_min(1e-30))
                            .max()) if with_gn else 0.0)
            worst = max(worst, float((outs[0] - ref[0]).abs().max()))
            print(f"  {SEGMENT_KERNEL} stash_p={stash} with_grad_norm="
                  f"{with_gn}: m'/v' bitwise={bitwise}; on the {real} "
                  f"parameters, p' max |diff| / |step|={p_rel:.3e}, / "
                  f"(|step| + ulp(p'))={p_rel_ulp:.3e}, max(|diff| - "
                  f"{SEG_P_REL_TOL}|step| - ulp(p'))={p_excess:.3e} (tol 0); "
                  f"grad sums max_rel={gg_rel:.3e} (tol {SUMSQ_REL_TOL}), "
                  f"found={float(f)}")
            check(bitwise and p_excess <= 0.0 and float(f) == 0.0
                  and gg_rel <= SUMSQ_REL_TOL,
                  "lamb_segment kernel disagrees with its plain version")
            run = lambda kw=kw: _small_segment_pass(  # noqa: E731
                p, m, v, g, outs, **kw)
            ms, h_ms = device_ms(run, iters=10, replays=3), host_ms(run)
            plain_ms = host_ms(lambda kw=kw: _small_segment_pass(
                p, m, v, g, ref, plain=True, **kw), iters=3, warmup=1)
            # the bytes the LAMB update needs: the small leaves' own
            # parameters, each read (p, m, v, g) and written (p', m', v')
            # once, p twice without the stash; not the padding swept
            b_ms, by = bound((28 if stash else 32) * real, 25 * real,
                             PEAK_FP32_FLOPS)
            print(f"    ms={ms:.5f} host_ms={h_ms:.5f} plain_ms="
                  f"{plain_ms:.5f} library_ms=none bound_ms={b_ms:.5f} "
                  f"({by}) over {real} parameters ({swept} elements swept)")
            cases.append({"stash_p": stash, "with_grad_norm": with_gn,
                          "ms": ms, "host_ms": h_ms, "plain_ms": plain_ms,
                          "bound_ms": b_ms, "bound_by": by,
                          "p_rel": p_rel, "p_rel_ulp": p_rel_ulp,
                          "p_excess": p_excess, "gg_rel": gg_rel})
    bad = g.clone()
    bad[meta.small_segments[0] * meta.seg_elems + 11] = float("inf")
    f, _ = _small_segment_pass(p, m, v, bad, outs, **kw)
    print(f"  {SEGMENT_KERNEL} with an inf in a small segment: found_inf="
          f"{float(f)}")
    check(float(f) == 1.0, "lamb_segment found_inf not set")
    del bad, outs, ref, live
    # FusedLAMB.step_flat in place: segmented (the default layout, and
    # the layout at the reference rule's segment size) and two-stage
    from apex_tpu_torch.optimizers import FlatOptState
    ref_space, ref_meta, ref_info = segment_layout(cfg, seg_elems=196608)
    layouts = {"segmented": (space, meta),
               "segmented_196608": (ref_space, ref_meta),
               "two_stage": (FlatSpace.create(gpt_leaves(cfg)), None)}
    times = {}
    for name, (sp, mt) in layouts.items():
        opt = FusedLAMB(lr=1e-3, weight_decay=0.01, max_grad_norm=1.0,
                        segmented=mt is not None)
        if sp.total > n:
            bufs = [_seeded(sp.total, dev, 11 + i) for i in range(4)]
            bufs[2].abs_().mul_(1e-6)
            bufs[3].mul_(1e-2)
        else:
            bufs = [b[:sp.total] for b in (p, m, v, g)]
        state = FlatOptState(space=sp, master=bufs[0],
                             slots={"m": bufs[1], "v": bufs[2]}, count=0,
                             found_inf=torch.zeros((), device=dev),
                             seg_meta=mt)
        times[name] = host_ms(lambda: opt.step_flat(state, bufs[3]),
                              iters=10)
        del state, bufs
    print(f"  FusedLAMB.step_flat with the clip, in place: segmented "
          f"{times['segmented']:.5f} ms ({n} elements), at seg_elems="
          f"196608 {times['segmented_196608']:.5f} ms ({ref_space.total}), "
          f"two-stage {times['two_stage']:.5f} ms (host clock over CUDA "
          f"events, 10 calls)")
    top = dict(cases[0])
    return {"name": SEGMENT_KERNEL, "route": "cuda",
            "source": "apex_tpu_torch/csrc/lamb_segment.cu",
            "replaces": "apex_tpu/multi_tensor/segmented.py:126",
            "max_abs_err": worst, "ms": top["ms"], "host_ms": top["host_ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": None,
            "cases": cases, "layout": info, "layout_196608": ref_info,
            "step_flat_ms": times,
            "shape": f"{len(meta.small_segments)} small segments of "
                     f"{meta.seg_elems} fp32 ({real} parameters; GPT-2 "
                     f"345M segmented layout)"}


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


# -- ResNet-50's flat buffers: the SGD and LARS kernels ------------------------


def resnet_space() -> FlatSpace:
    """ResNet-50's parameters in module order, in the optimizers' flat
    layout (built on the CPU: the layout needs only names and sizes)."""
    model = ResNet(ResNetConfig.resnet50(), device="cpu")
    return FlatSpace.create({k: torch.empty(p.shape, device="meta")
                             for k, p in model.named_parameters()})


def _bitwise(got, want) -> bool:
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got, want))


def sgd_case(dev, space: FlatSpace) -> dict:
    """The SGD kernel over ResNet-50's flat buffers, every flag bitwise
    against the plain version; an inf and a nan set found_inf, and the
    out-of-place step leaves p and mom as they were. Timed in place with
    the runs' settings (momentum 0.9, weight decay 1e-4)."""
    n = space.total
    p, mom = _seeded(n, dev, 11), _seeded(n, dev, 12, 1e-2)
    g = _seeded(n, dev, 13, 1e-2)
    cases = {"momentum": dict(momentum=0.9),
             "first_run": dict(momentum=0.9, first_run=True),
             "nesterov": dict(momentum=0.9, nesterov=True),
             "dampening_wd_after": dict(momentum=0.9, dampening=0.1,
                                        wd_after_momentum=True),
             "no_momentum": dict(momentum=0.0),
             "device_scale_and_flag": dict(
                 momentum=0.9, scale=torch.full((), 2.0 ** -16, device=dev),
                 first_run=torch.ones((), device=dev) > 0)}
    flags, err = {}, 0.0
    for case, extra in cases.items():
        kw = dict(lr=0.1, weight_decay=1e-4, **extra)
        want = mt_ops.fused_sgd_update(p.clone(), mom.clone(), g, plain=True,
                                       **kw)
        got = mt_ops.fused_sgd_update(p.clone(), mom.clone(), g, **kw)
        torch.cuda.synchronize()
        flags[case] = _bitwise(got[:2], want[:2])
        err = max(err, *(float((a - b).abs().max())
                         for a, b in zip(got[:2], want[:2])))
        del want, got
    bad = g.clone()
    bad[12345] = float("inf")
    bad[n - 7] = float("nan")
    before = (p.clone(), mom.clone())
    *_, found = mt_ops.fused_sgd_update(p, mom, bad, lr=0.1, momentum=0.9,
                                        in_place=False)
    untouched = torch.equal(p, before[0]) and torch.equal(mom, before[1])
    found = float(found)
    del bad, before
    print(f"  fused_sgd n={n} fp32 (ResNet-50): bitwise {flags}; "
          f"max_abs_err={err:.3e} found_inf={found} "
          f"state_untouched={untouched}")
    check(all(flags.values()), "fused_sgd kernel is not bitwise equal to "
          "its plain version")
    check(found == 1.0 and untouched, "fused_sgd found_inf / skip wrong")
    kw = dict(lr=0.1, momentum=0.9, weight_decay=1e-4)
    kernel = lambda: mt_ops.fused_sgd_update(p, mom, g, **kw)  # noqa: E731
    ms, h_ms = device_ms(kernel), host_ms(kernel)
    plain_ms = host_ms(lambda: mt_ops.fused_sgd_update(
        p, mom, g, plain=True, **kw), iters=3, warmup=1)
    # the library yardstick: torch's fused SGD over the same 161 tensors
    params = [torch.nn.Parameter(t.clone()) for t in
              space.unpack(p, "buffer").values()]
    for prm, gt in zip(params, space.unpack(g, "buffer").values()):
        prm.grad = gt.clone()
    lib = torch.optim.SGD(params, fused=True, **kw)
    lib_ms = host_ms(lib.step)
    del params, lib
    # per element: p, mom, g read, p and mom written; ~7 fp32 operations
    b_ms, by = bound(20 * n, 7 * n, PEAK_FP32_FLOPS)
    print(f"    ms={ms:.5f} host_ms={h_ms:.5f} plain_ms={plain_ms:.5f} "
          f"library_ms={lib_ms:.5f} (SGD fused, {space.num_leaves} tensors) "
          f"bound_ms={b_ms:.5f} ({by})")
    return {"name": mt_ops.SGD_KERNEL, "route": "cuda",
            "source": "apex_tpu_torch/csrc/fused_sgd.cu",
            "replaces": "apex_tpu/multi_tensor/engine.py:243",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
            "host_ms": h_ms, "bitwise": flags,
            "shape": f"n={n} fp32 (ResNet-50 flat buffers)"}


def lars_case(dev, space: FlatSpace) -> dict:
    """The LARS kernel over ResNet-50's flat buffers: bitwise against the
    plain version given the same ratios (host and device first-run flag);
    the full update (two sums of squares, the ratios, the sweep) within
    LARS_TOL of the plain update; found_inf on an inf."""
    n = space.total
    p, mom = _seeded(n, dev, 21), _seeded(n, dev, 22, 1e-2)
    g = _seeded(n, dev, 23, 1e-2)
    ids = space.device_subtile_leaf_ids(dev)
    tc = dict(trust_coefficient=0.02, weight_decay=1e-4, eps=1e-8,
              clip=True)
    ratio = mt_ops.lars_ratio(mt_ops.per_tensor_l2norm(p, space),
                              mt_ops.per_tensor_l2norm(g, space), **tc)
    flags = {}
    for first in (False, torch.ones((), device=dev) > 0):
        kw = dict(lr=0.1, momentum=0.9, weight_decay=1e-4, first_run=first,
                  tile_ids=ids)
        want = mt_ops.lars_apply(p.clone(), mom.clone(), g, ratio,
                                 plain=True, **kw)
        got = mt_ops.lars_apply(p.clone(), mom.clone(), g, ratio, **kw)
        torch.cuda.synchronize()
        flags["first_run" if isinstance(first, torch.Tensor)
              else "momentum"] = _bitwise(got[:2], want[:2])
        del want, got
    kw = dict(lr=0.1, momentum=0.9, **tc)
    want = mt_ops.fused_lars_update(p.clone(), mom.clone(), g, space,
                                    plain=True, **kw)
    got = mt_ops.fused_lars_update(p.clone(), mom.clone(), g, space, **kw)
    torch.cuda.synchronize()
    tm = want[1].abs() + (0.9 * mom).abs()
    m_excess = float(((got[1] - want[1]).abs() - LARS_TOL * tm).max())
    tp = torch.maximum(p.abs(), want[0].abs())
    ulp = torch.nextafter(tp, torch.full_like(tp, float("inf"))) - tp
    p_excess = float(((got[0] - want[0]).abs() - 0.1 * LARS_TOL * tm
                      - ulp).max())
    err = max(float((a - b).abs().max()) for a, b in zip(got[:2], want[:2]))
    del want, got, tm, tp, ulp
    bad = g.clone()
    bad[n // 3] = float("inf")
    found = float(mt_ops.fused_lars_update(p.clone(), mom.clone(), bad,
                                           space, in_place=False, **kw)[2])
    del bad
    print(f"  fused_lars n={n} fp32 (ResNet-50): given the ratios bitwise "
          f"{flags}; full update max_abs_err={err:.3e}, excess over the "
          f"tolerance ({LARS_TOL}): mom' {m_excess:.3e}, p' {p_excess:.3e} "
          f"(<= 0 passes); found_inf={found}")
    check(all(flags.values()), "fused_lars kernel is not bitwise equal to "
          "its plain version")
    check(m_excess <= 0 and p_excess <= 0, "the LARS update through the "
          "kernels disagrees with the plain update")
    check(found == 1.0, "fused_lars found_inf not set")
    kwa = dict(lr=0.1, momentum=0.9, weight_decay=1e-4, tile_ids=ids)
    kernel = lambda: mt_ops.lars_apply(p, mom, g, ratio, **kwa)  # noqa
    ms, h_ms = device_ms(kernel), host_ms(kernel)
    plain_ms = host_ms(lambda: mt_ops.lars_apply(p, mom, g, ratio,
                                                 plain=True, **kwa),
                       iters=3, warmup=1)
    full = lambda: mt_ops.fused_lars_update(p, mom, g, space, **kw)  # noqa
    full_ms = device_ms(full)
    full_plain_ms = host_ms(lambda: mt_ops.fused_lars_update(
        p, mom, g, space, plain=True, **kw), iters=3, warmup=1)
    b_ms, by = bound(20 * n, 5 * n, PEAK_FP32_FLOPS)
    fb_ms, _ = bound(28 * n, 9 * n, PEAK_FP32_FLOPS)
    print(f"    sweep: ms={ms:.5f} host_ms={h_ms:.5f} plain_ms={plain_ms:.5f} "
          f"bound_ms={b_ms:.5f} ({by}); whole update (norms, ratios, sweep): "
          f"ms={full_ms:.5f} plain_ms={full_plain_ms:.5f} bound_ms="
          f"{fb_ms:.5f}; no library call")
    return {"name": mt_ops.LARS_KERNEL, "route": "cuda",
            "source": "apex_tpu_torch/csrc/fused_sgd.cu",
            "replaces": "apex_tpu/multi_tensor/engine.py:243",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None,
            "host_ms": h_ms, "update_ms": full_ms,
            "update_plain_ms": full_plain_ms, "update_bound_ms": fb_ms,
            "excess": {"mom": m_excess, "p": p_excess}, "bitwise": flags,
            "shape": f"n={n} fp32 (ResNet-50 flat buffers)"}


# -- GPT-2 345M's flat buffers: the scale, axpby, Adagrad and NovoGrad kernels


def _same_bits(a, b) -> bool:
    view = torch.int16 if a.element_size() == 2 else torch.int32
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


def scale_case(dev) -> dict:
    """The scale kernel over a GPT-2 345M-sized flat gradient, bitwise
    against the plain version for fp32, bf16 and fp16 in and out, with a
    host and a device scale; an inf, a nan and an fp16 output that
    overflows set found_inf; the out-of-place call leaves x as it was.
    Timed in place on fp32 with a device factor (the clip's call) and out
    of place fp32 -> bf16."""
    n = gpt_flat_size(GPTConfig.gpt2_345m())
    x = _seeded(n, dev, 41, 1e-2)
    coef = torch.full((), 0.7, device=dev)
    cases = {"fp32_device_scale": (torch.float32, None, coef),
             "fp32_host_scale": (torch.float32, None, 0.7),
             "fp32_to_bf16": (torch.float32, torch.bfloat16, coef),
             "fp32_to_fp16": (torch.float32, torch.float16, 0.7),
             "bf16_to_fp32": (torch.bfloat16, torch.float32, coef),
             "fp16_to_bf16": (torch.float16, torch.bfloat16, 0.7)}
    flags, err = {}, 0.0
    for case, (in_dt, out_dt, sc) in cases.items():
        xin = x if in_dt == torch.float32 else x.to(in_dt)
        want = mt_ops.multi_tensor_scale(xin, sc, out_dtype=out_dt,
                                         plain=True)
        got = mt_ops.multi_tensor_scale(xin, sc, out_dtype=out_dt)
        torch.cuda.synchronize()
        flags[case] = (_same_bits(got[0], want[0])
                       and float(got[1]) == float(want[1]) == 0.0)
        err = max(err, float((got[0].float() - want[0].float()).abs().max()))
        del xin, want, got
    found = []
    for bad, out_dt in ((float("inf"), None), (float("nan"), None),
                        (1e5, torch.float16)):
        b = x.clone()
        b[n // 3] = bad
        found.append(float(mt_ops.multi_tensor_scale(b, 1.0,
                                                     out_dtype=out_dt)[1]))
        del b
    before = x.clone()
    mt_ops.multi_tensor_scale(x, coef)
    untouched = torch.equal(x, before)
    del before
    print(f"  multi_tensor_scale n={n}: bitwise {flags}; max_abs_err="
          f"{err:.3e}; found_inf with an inf, a nan, an fp16 overflow "
          f"{found}; out of place leaves x: {untouched}")
    check(all(flags.values()), "multi_tensor_scale kernel is not bitwise "
          "equal to its plain version")
    check(found == [1.0, 1.0, 1.0] and untouched,
          "multi_tensor_scale found_inf / out of place wrong")
    one = torch.ones((), device=dev)          # an unclipped step's factor
    kernel = lambda: mt_ops.multi_tensor_scale(  # noqa: E731
        x, one, in_place=True)
    ms, h_ms = device_ms(kernel), host_ms(kernel)
    bf16_ms = device_ms(lambda: mt_ops.multi_tensor_scale(
        x, one, out_dtype=torch.bfloat16))
    plain_ms = host_ms(lambda: mt_ops.multi_tensor_scale(
        x, one, in_place=True, plain=True), iters=3, warmup=1)
    y = torch.empty_like(x)
    lib_ms = device_ms(lambda: torch.mul(x, one, out=y))
    del y
    b_ms, by = bound(8 * n, n, PEAK_FP32_FLOPS)
    b16_ms, _ = bound(6 * n, n, PEAK_FP32_FLOPS)
    print(f"    fp32 in place: ms={ms:.5f} host_ms={h_ms:.5f} plain_ms="
          f"{plain_ms:.5f} library_ms={lib_ms:.5f} (torch.mul out=) "
          f"bound_ms={b_ms:.5f} ({by}); fp32 -> bf16 ms={bf16_ms:.5f} "
          f"bound_ms={b16_ms:.5f}")
    return {"name": mt_ops.SCALE_KERNEL, "route": "cuda",
            "source": "apex_tpu_torch/csrc/scale_axpby.cu",
            "replaces": "apex_tpu/multi_tensor/engine.py:243",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
            "host_ms": h_ms, "bf16_out_ms": bf16_ms,
            "bf16_out_bound_ms": b16_ms, "bitwise": flags,
            "shape": f"n={n} fp32 in place (GPT-2 345M flat gradient)"}


def axpby_case(dev) -> dict:
    """The axpby kernel over GPT-2 345M-sized flat buffers, bitwise
    against the plain version (host and device a, b; bf16 x; bf16 and
    fp16 out); found_inf over x, y or both as arg_to_check says; the
    inputs left as they were. Timed fp32, out of place."""
    n = gpt_flat_size(GPTConfig.gpt2_345m())
    x, y = _seeded(n, dev, 42, 1e-2), _seeded(n, dev, 43, 1e-2)
    half = torch.full((), 0.5, device=dev)
    cases = {"fp32_host": (torch.float32, None, 0.5, -1.5),
             "fp32_device": (torch.float32, None, half, half),
             "bf16_x": (torch.bfloat16, None, 0.5, 2.0),
             "bf16_out": (torch.float32, torch.bfloat16, 1.0, 1.0),
             "fp16_out": (torch.float32, torch.float16, 1.0, -1.0)}
    flags, err = {}, 0.0
    for case, (x_dt, out_dt, a, b) in cases.items():
        xin = x if x_dt == torch.float32 else x.to(x_dt)
        want = mt_ops.multi_tensor_axpby(xin, y, a, b, out_dtype=out_dt,
                                         plain=True)
        got = mt_ops.multi_tensor_axpby(xin, y, a, b, out_dtype=out_dt)
        torch.cuda.synchronize()
        flags[case] = (_same_bits(got[0], want[0])
                       and float(got[1]) == float(want[1]) == 0.0)
        err = max(err, float((got[0].float() - want[0].float()).abs().max()))
        del xin, want, got
    found = {}
    before = (x.clone(), y.clone())
    for arg, bad_x, expect in ((-1, True, 1.0), (-1, False, 1.0),
                               (0, True, 1.0), (0, False, 0.0),
                               (1, False, 1.0), (1, True, 0.0)):
        bx, by_ = (x.clone(), y) if bad_x else (x, y.clone())
        (bx if bad_x else by_)[n - 5] = float("nan" if arg else "inf")
        got = float(mt_ops.multi_tensor_axpby(bx, by_, 1.0, 1.0,
                                              arg_to_check=arg)[1])
        found[f"{arg}_{'x' if bad_x else 'y'}"] = got == expect
        del bx, by_
    untouched = torch.equal(x, before[0]) and torch.equal(y, before[1])
    del before
    print(f"  multi_tensor_axpby n={n}: bitwise {flags}; max_abs_err="
          f"{err:.3e}; found_inf as arg_to_check says {found}; inputs "
          f"untouched: {untouched}")
    check(all(flags.values()), "multi_tensor_axpby kernel is not bitwise "
          "equal to its plain version")
    check(all(found.values()) and untouched,
          "multi_tensor_axpby found_inf / out of place wrong")
    kernel = lambda: mt_ops.multi_tensor_axpby(x, y, 0.5, 0.5)  # noqa
    ms, h_ms = device_ms(kernel), host_ms(kernel)
    plain_ms = host_ms(lambda: mt_ops.multi_tensor_axpby(
        x, y, 0.5, 0.5, plain=True), iters=3, warmup=1)
    b_ms, by = bound(12 * n, 3 * n, PEAK_FP32_FLOPS)
    print(f"    ms={ms:.5f} host_ms={h_ms:.5f} plain_ms={plain_ms:.5f} "
          f"bound_ms={b_ms:.5f} ({by}); no library call")
    return {"name": mt_ops.AXPBY_KERNEL, "route": "cuda",
            "source": "apex_tpu_torch/csrc/scale_axpby.cu",
            "replaces": "apex_tpu/multi_tensor/engine.py:243",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None,
            "host_ms": h_ms, "bitwise": flags,
            "shape": f"n={n} fp32 x, y, out (GPT-2 345M flat buffers)"}


def _library_adagrad(space: FlatSpace, p, g):
    """``torch.optim.Adagrad`` over GPT-2 345M's tensors (a yardstick
    only): fused where this PyTorch takes it on the card, else foreach.
    Returns ``(ms, which)``."""
    params = [torch.nn.Parameter(t.clone()) for t in
              space.unpack(p, "buffer").values()]
    for prm, gt in zip(params, space.unpack(g, "buffer").values()):
        prm.grad = gt.clone()
    for kind in ("fused", "foreach"):
        try:
            lib = torch.optim.Adagrad(params, lr=ADAGRAD_LR,
                                      weight_decay=0.01, **{kind: True})
            lib.step()
            return host_ms(lib.step), f"Adagrad({kind}=True)"
        except (RuntimeError, ValueError, TypeError) as e:
            print(f"    torch.optim.Adagrad({kind}=True) refused: "
                  f"{str(e).splitlines()[0][:120]}")
    return None, "none"


def adagrad_case(dev) -> dict:
    """The Adagrad kernel over GPT-2 345M's flat buffers, bitwise against
    the plain version (weight decay, a host and a device grad_scale); an
    inf and a nan set found_inf and the out-of-place step leaves p and h
    as they were. Timed in place with the path's settings (a device
    scale: the loss scale times the clip factor)."""
    space = FlatSpace.create(gpt_leaves(GPTConfig.gpt2_345m()))
    n = space.total
    p, h = _seeded(n, dev, 51, 2e-2), _seeded(n, dev, 52, 1e2, positive=True)
    g = _seeded(n, dev, 53, 2.0 ** 10)
    dscale = torch.full((), 1.3 * 2.0 ** 16, device=dev)
    cases = {"lr_only": {}, "weight_decay": dict(weight_decay=0.01),
             "host_scale": dict(weight_decay=0.01, grad_scale=2.0 ** 16),
             "device_scale": dict(weight_decay=0.01, grad_scale=dscale)}
    flags, err = {}, 0.0
    for case, extra in cases.items():
        kw = dict(lr=ADAGRAD_LR, **extra)
        want = mt_ops.fused_adagrad_update(p.clone(), h.clone(), g,
                                           plain=True, **kw)
        got = mt_ops.fused_adagrad_update(p.clone(), h.clone(), g, **kw)
        torch.cuda.synchronize()
        flags[case] = _bitwise(got[:2], want[:2])
        err = max(err, *(float((a - b).abs().max())
                         for a, b in zip(got[:2], want[:2])))
        del want, got
    bad = g.clone()
    bad[12345] = float("inf")
    bad[n - 7] = float("nan")
    before = (p.clone(), h.clone())
    *_, found = mt_ops.fused_adagrad_update(p, h, bad, lr=ADAGRAD_LR,
                                            in_place=False)
    untouched = torch.equal(p, before[0]) and torch.equal(h, before[1])
    found = float(found)
    del bad, before
    print(f"  fused_adagrad n={n} fp32: bitwise {flags}; max_abs_err="
          f"{err:.3e} found_inf={found} state_untouched={untouched}")
    check(all(flags.values()), "fused_adagrad kernel is not bitwise equal "
          "to its plain version")
    check(found == 1.0 and untouched, "fused_adagrad found_inf / skip wrong")
    kw = dict(lr=ADAGRAD_LR, weight_decay=0.01, grad_scale=dscale)
    kernel = lambda: mt_ops.fused_adagrad_update(p, h, g, **kw)  # noqa
    ms, h_ms = device_ms(kernel), host_ms(kernel)
    plain_ms = host_ms(lambda: mt_ops.fused_adagrad_update(
        p, h, g, plain=True, **kw), iters=3, warmup=1)
    lib_ms, lib = _library_adagrad(space, p, g)
    # per element: p, h, g read, p and h written; ~7 fp32 operations
    b_ms, by = bound(20 * n, 7 * n, PEAK_FP32_FLOPS)
    print(f"    ms={ms:.5f} host_ms={h_ms:.5f} plain_ms={plain_ms:.5f} "
          f"library_ms={lib_ms} ({lib}, {space.num_leaves} tensors) "
          f"bound_ms={b_ms:.5f} ({by})")
    return {"name": mt_ops.ADAGRAD_KERNEL, "route": "cuda",
            "source": "apex_tpu_torch/csrc/adagrad_novograd.cu",
            "replaces": "apex_tpu/multi_tensor/engine.py:243",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
            "library": lib, "host_ms": h_ms, "bitwise": flags,
            "shape": f"n={n} fp32 (GPT-2 345M flat buffers)"}


def novograd_excess(p, m, got, want, *, lr_bc1, b1, wd) -> dict:
    """How far one NovoGrad update through the kernels (``got``: p', m',
    v') lies from the plain one (``want``), both from p and m: v''s
    largest relative difference, and the excess of |dm'| over
    NOVOGRAD_TOL of its terms (|b1 m| + |m'| + |wd p|) plus one ulp of
    m', and of |dp'| over lr / bc1 times that plus one ulp of the larger
    of |p| and |p'| (<= 0 passes)."""
    inf = torch.full((), float("inf"), device=p.device)
    tm = (b1 * m).abs() + want[1].abs() + (wd * p).abs()
    am = want[1].abs()
    bm = NOVOGRAD_TOL * tm + (torch.nextafter(am, inf) - am)
    m_excess = float(((got[1] - want[1]).abs() - bm).max())
    tp = torch.maximum(p.abs(), want[0].abs())
    p_excess = float(((got[0] - want[0]).abs() - lr_bc1 * bm
                      - (torch.nextafter(tp, inf) - tp)).max())
    v_rel = float(((got[2] - want[2]).abs() / want[2].abs()).max())
    return {"v_rel": v_rel, "m": m_excess, "p": p_excess,
            "ok": (v_rel <= NOVOGRAD_TOL and m_excess <= 0
                   and p_excess <= 0)}


def novograd_case(dev) -> dict:
    """The NovoGrad kernel over GPT-2 345M's flat space: bitwise against
    the plain version given the same denominators (with and without grad
    averaging and bias correction); the whole update (per-leaf norms on
    the sum-of-squares kernel) within NOVOGRAD_TOL of the plain one; an
    inf and a nan set found_inf and the out-of-place step leaves p, m
    and v as they were."""
    space = FlatSpace.create(gpt_leaves(GPTConfig.gpt2_345m()))
    n = space.total
    p, m = _seeded(n, dev, 61, 2e-2), _seeded(n, dev, 62, 1e-3)
    g = _seeded(n, dev, 63, 1e-2)
    v = _seeded(space.num_leaves, dev, 64, 10.0, positive=True)
    ids = space.device_subtile_leaf_ids(dev)
    b1, b2 = NOVOGRAD_BETAS
    _, denom = mt_ops.novograd_denominators(
        mt_ops.per_tensor_l2norm(g, space), v, beta2=b2, eps=1e-8, step=2,
        bias_correction=False)
    cases = {"grad_averaging": dict(beta3=1.0 - b1, bc1=1.0),
             "no_averaging": dict(beta3=1.0, bc1=1.0),
             "bias_correction": dict(beta3=1.0 - b1, bc1=1.0 - b1 ** 3)}
    flags = {}
    for case, extra in cases.items():
        kw = dict(lr=NOVOGRAD_LR, beta1=b1, weight_decay=NOVOGRAD_WD,
                  tile_ids=ids, **extra)
        want = mt_ops.novograd_apply(p.clone(), m.clone(), g, denom,
                                     plain=True, **kw)
        got = mt_ops.novograd_apply(p.clone(), m.clone(), g, denom, **kw)
        torch.cuda.synchronize()
        flags[case] = _bitwise(got[:2], want[:2])
        del want, got
    kw = dict(lr=NOVOGRAD_LR, beta1=b1, beta2=b2, weight_decay=NOVOGRAD_WD,
              step=2)
    outs = [mt_ops.fused_novograd_update(p.clone(), m.clone(), v.clone(), g,
                                         space, plain=plain, **kw)
            for plain in (False, True)]
    torch.cuda.synchronize()
    excess = novograd_excess(p, m, *outs, lr_bc1=NOVOGRAD_LR, b1=b1,
                             wd=NOVOGRAD_WD)
    err = max(float((a - b).abs().max()) for a, b in zip(*outs))
    del outs
    bad = g.clone()
    bad[12345] = float("inf")
    bad[n - 7] = float("nan")
    before = (p.clone(), m.clone(), v.clone())
    found = float(mt_ops.fused_novograd_update(p, m, v, bad, space,
                                               in_place=False, **kw)[3])
    untouched = all(torch.equal(a, b) for a, b in zip((p, m, v), before))
    del bad, before
    print(f"  fused_novograd n={n} fp32 ({space.num_leaves} leaves): given "
          f"the denominators bitwise {flags}; whole update max_abs_err="
          f"{err:.3e}, v' rel {excess['v_rel']:.3e}, excess over the "
          f"tolerance ({NOVOGRAD_TOL}): m' {excess['m']:.3e}, p' "
          f"{excess['p']:.3e} (<= 0 passes); found_inf={found} "
          f"state_untouched={untouched}")
    check(all(flags.values()), "fused_novograd kernel is not bitwise equal "
          "to its plain version")
    check(excess["ok"], "the NovoGrad update through the kernels disagrees "
          "with the plain update")
    check(found == 1.0 and untouched, "fused_novograd found_inf / skip wrong")
    kwa = dict(lr=NOVOGRAD_LR, beta1=b1, beta3=1.0 - b1,
               weight_decay=NOVOGRAD_WD, bc1=1.0, tile_ids=ids)
    kernel = lambda: mt_ops.novograd_apply(p, m, g, denom, **kwa)  # noqa
    ms, h_ms = device_ms(kernel), host_ms(kernel)
    plain_ms = host_ms(lambda: mt_ops.novograd_apply(
        p, m, g, denom, plain=True, **kwa), iters=3, warmup=1)
    full = lambda: mt_ops.fused_novograd_update(  # noqa: E731
        p, m, v, g, space, **kw)
    full_ms = device_ms(full)
    full_plain_ms = host_ms(lambda: mt_ops.fused_novograd_update(
        p, m, v, g, space, plain=True, **kw), iters=3, warmup=1)
    b_ms, by = bound(20 * n, 7 * n, PEAK_FP32_FLOPS)
    fb_ms, _ = bound(24 * n, 9 * n, PEAK_FP32_FLOPS)
    print(f"    sweep: ms={ms:.5f} host_ms={h_ms:.5f} plain_ms={plain_ms:.5f} "
          f"bound_ms={b_ms:.5f} ({by}); whole update (norms, denominators, "
          f"sweep): ms={full_ms:.5f} plain_ms={full_plain_ms:.5f} bound_ms="
          f"{fb_ms:.5f}; no library call")
    return {"name": mt_ops.NOVOGRAD_KERNEL, "route": "cuda",
            "source": "apex_tpu_torch/csrc/adagrad_novograd.cu",
            "replaces": "apex_tpu/multi_tensor/engine.py:243",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None,
            "host_ms": h_ms, "update_ms": full_ms,
            "update_plain_ms": full_plain_ms, "update_bound_ms": fb_ms,
            "excess": excess, "bitwise": flags,
            "shape": f"n={n} fp32, {space.num_leaves} leaves (GPT-2 345M "
                     "flat buffers)"}


# the BERT-Large batch of phase 6: real lengths of the eight sequences
# of 512 (the rest padding)
BERT_LENS = (512, 448, 384, 320, 512, 256, 480, 200)
# the attention scores each softmax path gives its kernels: BERT-Large's
# (b, heads, s, s) and GPT-2 345M's (b * heads, s, s)
BERT_SCORES = (8, 16, 512, 512)
GPT_SCORES = (8 * 16, 1024, 1024)


def bert_keep(dev, lens=BERT_LENS, s: int = 512) -> torch.Tensor:
    """(b, s) int32 keep-mask: 1 on each sequence's real prefix."""
    return (torch.arange(s)[None, :] < torch.tensor(lens)[:, None]).to(
        dev, torch.int32)


def _ulp_excess(got, want, tol) -> float:
    """Largest |got - want| beyond ``tol`` of the larger |value| (one
    bf16 ulp at tol 2^-7); <= 0 passes."""
    a, b = got.float(), want.float()
    return float(((a - b).abs() - tol * torch.maximum(a.abs(),
                                                      b.abs())).max())


def _library_ms(name, fn):
    """Ms per call of a PyTorch library call used as a yardstick only
    (CUDA events over back-to-back calls, outside a graph: one call at
    these shapes outlasts its launch), or None (with the reason printed)
    where that call does not take these inputs; the port never calls
    it."""
    try:
        return host_ms(fn)
    except RuntimeError as e:
        print(f"    library call for {name} not timed: "
              f"{str(e).splitlines()[0][:120]}")
        return None


def softmax_fwd_case(name, x, mask, mode, lib, bound_bytes) -> dict:
    """One forward kernel of ``csrc/softmax.cu`` against its plain version
    on the same inputs: within one bf16 ulp elementwise."""
    y = softmax._fwd_cuda(x, mask, 1.0, mode)
    want = softmax._fwd_torch(x, mask, 1.0, mode)
    torch.cuda.synchronize()
    err = float((y.float() - want.float()).abs().max())
    excess = _ulp_excess(y, want, SOFTMAX_FWD_TOL)
    check(bool(torch.isfinite(y).all()), f"{name}: non-finite output")
    print(f"  {name} {tuple(x.shape)} {str(x.dtype)[6:]}: max_abs_err="
          f"{err:.3e} max(|diff| - 2^-7 max(|y|, |y_plain|))={excess:.3e} "
          f"(tol 0)")
    check(excess <= 0.0, f"{name} kernel disagrees with its plain version")
    kernel = lambda: softmax._fwd_cuda(x, mask, 1.0, mode)  # noqa: E731
    ms, h_ms = device_ms(kernel), host_ms(kernel)
    plain_ms = device_ms(lambda: softmax._fwd_torch(x, mask, 1.0, mode),
                         iters=3, replays=2)
    lib_ms = _library_ms(name, lib) if lib is not None else None
    # per score: scale, fill, max, subtract, exp, sum, divide
    b_ms, by = bound(bound_bytes, 7 * x.numel(), PEAK_FP32_FLOPS)
    print(f"    ms={ms:.5f} host_ms={h_ms:.5f} plain_ms={plain_ms:.5f} "
          f"library_ms={lib_ms if lib_ms is None else round(lib_ms, 5)} "
          f"bound_ms={b_ms:.5f} ({by})")
    return {"max_abs_err": err, "ulp_excess": excess, "ms": ms,
            "host_ms": h_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": b_ms, "bound_by": by,
            "shape": f"{tuple(x.shape)} bf16"
                     + ("" if mask is None else
                        f", mask {tuple(mask.shape)} bool")}


def softmax_bwd_case(name, y, g) -> dict:
    """The shared backward against its plain version, relative to each
    row's largest |dx|."""
    dx = softmax._bwd_cuda(y, g, 1.0)
    want = softmax._bwd_torch(y, g, 1.0)
    torch.cuda.synchronize()
    diff = (dx.float() - want.float()).abs()
    row = want.float().abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    rel = float((diff / row).max())
    err = float(diff.max())
    check(bool(torch.isfinite(dx).all()), f"{name}: non-finite dx")
    print(f"  {softmax.BWD_KERNEL}[{name}] {tuple(y.shape)}: max_abs_err="
          f"{err:.3e} max |diff| / row max |dx| = {rel:.3e} (tol "
          f"{SOFTMAX_BWD_TOL})")
    check(rel <= SOFTMAX_BWD_TOL,
          f"{softmax.BWD_KERNEL}[{name}] kernel disagrees with its plain "
          "version")
    kernel = lambda: softmax._bwd_cuda(y, g, 1.0)  # noqa: E731
    ms, h_ms = device_ms(kernel), host_ms(kernel)
    plain_ms = device_ms(lambda: softmax._bwd_torch(y, g, 1.0), iters=3,
                         replays=2)
    lib_ms = _library_ms(softmax.BWD_KERNEL, lambda: (
        torch._softmax_backward_data(g, y, -1, y.dtype)))
    # y and g read, dx written; per element: product, sum, subtract, two
    # products
    b_ms, by = bound(nbytes(y, g, dx), 5 * y.numel(), PEAK_FP32_FLOPS)
    print(f"    ms={ms:.5f} host_ms={h_ms:.5f} plain_ms={plain_ms:.5f} "
          f"library_ms={lib_ms if lib_ms is None else round(lib_ms, 5)} "
          f"bound_ms={b_ms:.5f} ({by})")
    return {"case": name, "max_abs_err": err, "row_rel_err": rel, "ms": ms,
            "host_ms": h_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": b_ms, "bound_by": by,
            "shape": f"{tuple(y.shape)} bf16"}


def softmax_cases(gen, dev) -> list:
    """#10-#13 at their path shapes: BERT-Large's scores (8, 16, 512, 512)
    with its padded outer-product mask (mask batch 8, and broadcast from
    1) for the masked and the scaled forward, GPT-2 345M's (8 * 16,
    1024, 1024) for the causal one, and the backward at both."""
    rnd = lambda *shape: (3 * torch.randn(*shape, generator=gen)).to(  # noqa
        dev, torch.bfloat16)
    x = rnd(*BERT_SCORES)
    mask = bert_extended_attention_mask(bert_keep(dev))   # (b, 1, s, s)
    full = mask.expand(*BERT_SCORES).contiguous()         # for the library
    rows = {}
    masked = [softmax_fwd_case(softmax.MASKED_KERNEL, x, mask, "masked",
                               lambda: torch._masked_softmax(x, full, 3, 2),
                               nbytes(x, x, mask))]
    one = mask[7:8]                          # the 200-token sequence's
    masked.append(softmax_fwd_case(
        softmax.MASKED_KERNEL + "[mask batch 1]", x, one, "masked",
        lambda: torch._masked_softmax(x, one.expand(*BERT_SCORES), 3, 2),
        nbytes(x, x, one)))
    rows["masked"] = masked
    rows["scaled"] = [softmax_fwd_case(
        softmax.SCALED_KERNEL, x, None, "scaled",
        lambda: torch.softmax(x, -1), nbytes(x, x))]
    y_bert = softmax._fwd_cuda(x, mask, 1.0, "masked")
    g_bert = rnd(*BERT_SCORES).div_(3)
    del x, full
    a, sq, sk = GPT_SCORES
    xc = rnd(*GPT_SCORES)
    live = a * sq * (sq + 1) // 2            # the lower triangle (sq == sk)
    upper = torch.triu(torch.ones(sq, sk, dtype=torch.bool, device=dev), 1)
    rows["causal"] = [softmax_fwd_case(
        softmax.CAUSAL_KERNEL, xc, None, "causal",
        lambda: torch._masked_softmax(xc.view(a // 16, 16, sq, sk), upper,
                                      3, 0),
        2 * live + nbytes(xc))]
    y_gpt = softmax._fwd_cuda(xc, None, 1.0, "causal")
    del xc
    g_gpt = rnd(*GPT_SCORES).div_(3)
    rows["bwd"] = [softmax_bwd_case("bert", y_bert, g_bert),
                   softmax_bwd_case("gpt", y_gpt, g_gpt)]
    del y_bert, g_bert, y_gpt, g_gpt
    out = []
    for key, name, line in (("scaled", softmax.SCALED_KERNEL, 48),
                            ("causal", softmax.CAUSAL_KERNEL, 52),
                            ("masked", softmax.MASKED_KERNEL, 62),
                            ("bwd", softmax.BWD_KERNEL, 71)):
        cases = rows[key]
        top = {k_: v_ for k_, v_ in cases[0].items() if k_ != "case"}
        out.append({"name": name, "route": "cuda",
                    "source": "apex_tpu_torch/csrc/softmax.cu",
                    "replaces": f"apex_tpu/ops/softmax.py:{line}", **top,
                    "max_abs_err": max(c["max_abs_err"] for c in cases),
                    "cases": cases})
    return out


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
    state, losses, times, launches = _train_loop(step, state, (x, y),
                                                 TRAIN_STEPS)
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
    (state, _), prof = _profiled(
        lambda: step(state, x, y), "step",
        {"optimizer": OPT_KERNEL_KEYS + ("adam_kernel",)})
    state, split = split_step(step, state, x, y)

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
            "split": split, "profile": prof}


def update_excess(st, got, want) -> dict:
    """How far one LAMB update through the kernels (``got``) lies from
    the plain one (``want``), both from state ``st``: per parameter, the
    worst excess of |dp'| over ``LAMB_PARAM_TOL`` of each element's own
    step, and over that share of the parameter's largest step, plus one
    rounding of p' (the ulp of the larger value: the two may round into
    neighbouring binades); m' and v' bitwise, and their largest
    difference relative to each buffer's largest value."""
    element, param = (-np.inf, ""), (-np.inf, "")
    old = st.space.unpack(st.master, "buffer")
    new_w = st.space.unpack(want[0], "buffer")
    for name, a in st.space.unpack(got[0], "buffer").items():
        step = (old[name] - new_w[name]).abs()
        diff = (a - new_w[name]).abs() - 2.0 ** -23 * torch.maximum(
            a.abs(), new_w[name].abs())
        element = max(element, (float((diff - LAMB_PARAM_TOL * step).max()),
                                name))
        param = max(param, (float(diff.max() - LAMB_PARAM_TOL * step.max()),
                            name))
    return {"element": element, "param": param,
            "mv_bitwise": all(torch.equal(a.view(torch.int32),
                                          b.view(torch.int32))
                              for a, b in zip(got[1:3], want[1:3])),
            "mv_rel": max(float((a - b).abs().max() / b.abs().max())
                          for a, b in zip(got[1:3], want[1:3]))}


def split_step(step, state, x, y, reps: int = 3):
    """Host-clock milliseconds of a training step's two parts, with a
    synchronise after each: the forward and backward, then the
    optimizer's ``step_flat`` (medians of ``reps`` steps). Set against
    the unsynchronised step's median, they show whether a step's idle
    device time sits in the model's part or the optimizer's."""
    fb, opt = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step._grad.zero_()
        gpt_loss_fn(step.model(x), y).backward()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, state = step.opt.step_flat(state, step._grad)
        torch.cuda.synchronize()
        fb.append(t1 - t0)
        opt.append(time.perf_counter() - t1)
    fb_ms, opt_ms = float(np.median(fb)) * 1e3, float(np.median(opt)) * 1e3
    print(f"  split step (synchronised, median of {reps}): forward+backward "
          f"{fb_ms:.2f} ms, optimizer {opt_ms:.3f} ms")
    return state, {"forward_backward_ms": fb_ms, "optimizer_ms": opt_ms}


OPT_KERNEL_KEYS = ("sumsq_kernel", "stage1_kernel", "stage2_kernel",
                   "segment_kernel")


def train_lamb(seed: int, dev, card: str) -> dict:
    """GPT-2 345M with FusedLAMB and its global-norm clip: ten steps on
    one batch through ``make_gpt_pretrain_step``; one scaler step with
    ``with_grad_norm`` on the real flat gradient; one with an inf in it;
    one LAMB update through the kernels and through their plain
    versions."""
    cfg = GPTConfig.gpt2_345m()           # bf16 compute, fp32 parameters
    t0 = time.perf_counter()
    model = init_gpt_pretrain_params(
        cfg, torch.Generator().manual_seed(seed), device=dev)
    opt = FusedLAMB(lr=LAMB_LR, weight_decay=0.01, max_grad_norm=1.0)
    step, state = make_gpt_pretrain_step(cfg, opt)(model)
    meta = state.seg_meta
    check(meta is not None, "FusedLAMB did not lay the master out in "
          "segments")
    rng = np.random.RandomState(seed)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size,
                                       (TRAIN_BATCH, cfg.max_seq_len + 1)),
                           device=dev).long()
    x, y = toks[:, :-1], toks[:, 1:]
    print(f"  GPT-2 345M with FusedLAMB(lr={LAMB_LR}, weight_decay=0.01, "
          f"max_grad_norm=1.0): flat buffers of {state.master.numel()} fp32 "
          f"(seg_elems={meta.seg_elems}, stash_p={meta.stash_p}, "
          f"{len(meta.small_segments)} small segments, {len(meta.large)} "
          f"large leaves), set-up {time.perf_counter() - t0:.1f} s")
    state, losses, times, launches = _train_loop(step, state, (x, y),
                                                 TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated()
    step_s = float(np.median(times[2:]))
    tokens = TRAIN_BATCH * cfg.max_seq_len
    print(f"  losses {[round(v_, 4) for v_ in losses]}")
    print(f"  launches over {TRAIN_STEPS} steps {launches}")
    print(f"  training (LAMB): step_ms median of the last {TRAIN_STEPS - 2} "
          f"{step_s * 1e3:.2f} (first {times[0] * 1e3:.1f}), tokens_per_s="
          f"{tokens / step_s:.0f}, peak memory {peak / 2**30:.2f} GiB "
          f"on {card}")
    check(all(np.isfinite(losses)), "non-finite training loss (LAMB)")
    check(losses[-1] < losses[0], "the LAMB training loss did not fall")
    path = (layer_norm.KERNEL, layer_norm.BWD_KERNEL, attention.KERNEL,
            attention.BWD_DQ_KERNEL, attention.BWD_DKV_KERNEL,
            engine.SUMSQ_KERNEL, mt_ops.LAMB_STAGE1_KERNEL,
            mt_ops.LAMB_STAGE2_KERNEL, SEGMENT_KERNEL)
    for kernel in path:
        check(launches.get(kernel, 0) > 0,
              f"kernel {kernel} never launched on the LAMB training path")

    (state, _), prof = _profiled(lambda: step(state, x, y), "LAMB step",
                                 {"optimizer": OPT_KERNEL_KEYS})
    state, split = split_step(step, state, x, y)
    # the optimizer step alone, on the last gradient (host clock over
    # CUDA events: it includes the per-leaf Python loop)
    grad = step._grad
    opt_step_ms = host_ms(lambda: opt.step_flat(state, grad), iters=5,
                          warmup=1)
    print(f"  FusedLAMB.step_flat on the model's state: {opt_step_ms:.3f} ms")

    # make_train_step with the scaler and with_grad_norm, on the real
    # flat gradient scaled by the loss scale, as a scaled loss gives it
    tstep = make_train_step(opt, scaler=LossScaler(), with_grad_norm=True)
    ss = tstep.scaler.init()
    scaled = grad * ss.loss_scale
    master, m_slot, count = (state.master.clone(), state.slots["m"].clone(),
                             state.count)
    want_norm = float(torch.linalg.vector_norm(grad.double()))
    _build.reset_launch_counts()
    state2, ss2, aux = tstep(state, scaled, ss)
    torch.cuda.synchronize()
    scaler_launches = _build.launch_counts()
    gnorm = float(aux.grad_norm)
    pt = aux.grad_norm_per_tensor
    pt_total = float(torch.sqrt((pt.double() ** 2).sum()))
    print(f"  make_train_step(scaler, with_grad_norm): grad_norm {gnorm:.6f} "
          f"against the plain norm {want_norm:.6f} (rel tol "
          f"{GRAD_NORM_REL_TOL}); found_inf {float(aux.found_inf)}; launches "
          f"{scaler_launches}")
    check(scaler_launches.get(engine.SUMSQ_SCALED_KERNEL, 0) > 0,
          "sumsq_scaled never launched on the scaler path")
    check(abs(gnorm - want_norm) <= GRAD_NORM_REL_TOL * want_norm
          and abs(pt_total - want_norm) <= GRAD_NORM_REL_TOL * want_norm
          and float(aux.found_inf) == 0.0 and state2.count == count + 1,
          "scaler step's grad_norm disagrees with the plain path")
    model_state = state2
    # an inf in the gradient: skipped, nothing moves, the scale backs off
    bad = scaled.clone()
    bad[12345] = float("inf")
    before = (state2.master.clone(), state2.slots["m"].clone(),
              state2.slots["v"].clone(), state2.count)
    state3, ss3, aux3 = tstep(state2, bad, ss2)
    torch.cuda.synchronize()
    skipped = (float(aux3.found_inf) == 1.0
               and torch.equal(state3.master, before[0])
               and torch.equal(state3.slots["m"], before[1])
               and torch.equal(state3.slots["v"], before[2])
               and state3.count == before[3]
               and ss3.loss_scale == ss2.loss_scale / 2)
    print(f"  scaler step with an inf: found_inf {float(aux3.found_inf)}, "
          f"state unchanged and scale {ss2.loss_scale} -> {ss3.loss_scale}: "
          f"{skipped}")
    check(skipped, "the overflowing LAMB step was not skipped")
    del bad, scaled, before, state3, master, m_slot

    # one LAMB update from the same state and gradient, kernels against
    # plain versions, every parameter's master: first with the clip's
    # norm handed to both (one clip factor: m' and v' bitwise, p' apart
    # only by ratios summed in other orders), then with each side
    # computing its own norm (clip factors one bit apart)
    st = model_state
    kw = dict(lr=LAMB_LR, weight_decay=0.01, max_grad_norm=1.0,
              step=st.count + 1)
    gnorm_k, _ = mt_ops.multi_tensor_l2norm(grad)
    upd = {}
    for case, extra in (("same_norm", dict(global_grad_norm=gnorm_k)),
                        ("own_norm", {})):
        outs = []
        for plain in (False, True):
            copies = [t.clone() for t in (st.master, st.slots["m"],
                                          st.slots["v"])]
            outs.append(fused_lamb_segmented_update(
                *copies, grad, st.space, meta, plain=plain, **kw, **extra))
        got, want = outs
        torch.cuda.synchronize()
        upd[case] = update_excess(st, got, want)
        del outs, got, want, copies
    same, own = upd["same_norm"], upd["own_norm"]
    print(f"  one LAMB update, kernels vs plain, the clip's norm handed to "
          f"both: m'/v' bitwise={same['mv_bitwise']}; worst parameter "
          f"max(|dp'| - {LAMB_PARAM_TOL}|step| - ulp(p')) "
          f"{same['element'][0]:.3e} in {same['element'][1]} (tol 0)")
    print(f"  one LAMB update, kernels vs plain, each side's own norm: m'/v' "
          f"max rel {own['mv_rel']:.3e} (tol {LAMB_PARAM_TOL}); worst "
          f"parameter max(|dp'| - {LAMB_PARAM_TOL} max|step| - ulp(p')) "
          f"{own['param'][0]:.3e} in {own['param'][1]} (tol 0); per "
          f"element, max(|dp'| - {LAMB_PARAM_TOL}|step| - ulp(p')) "
          f"{own['element'][0]:.3e} in {own['element'][1]}")
    check(same["mv_bitwise"] and same["element"][0] <= 0.0
          and own["mv_rel"] <= LAMB_PARAM_TOL and own["param"][0] <= 0.0,
          "LAMB update: kernel path disagrees with the plain path")
    return {"launches": launches, "steps": TRAIN_STEPS, "losses": losses,
            "step_ms": step_s * 1e3, "step_ms_all": [t * 1e3 for t in times],
            "tokens_per_s": tokens / step_s, "peak_gib": peak / 2**30,
            "opt_step_ms": opt_step_ms, "split": split,
            "scaler_launches": scaler_launches,
            "grad_norm": [gnorm, want_norm, pt_total],
            "update_excess": upd, "profile": prof}


# -- phases 6 and 7: BERT-Large and GPT-2 345M on the softmax backend ----------


def bert_batch(seed: int, dev, vocab: int):
    """One BERT-Large batch of 8 x 512 from the seed: tokens (0 on the
    padding), the keep-mask of BERT_LENS, tokentypes 0 on the first half
    of each real span and 1 after it, random MLM labels, a loss mask on
    15% of the real tokens, NSP labels."""
    rng = np.random.RandomState(seed)
    b, s = len(BERT_LENS), 512
    lens = np.asarray(BERT_LENS)[:, None]
    pos = np.arange(s)[None, :]
    keep = pos < lens
    tokens = np.where(keep, rng.randint(0, vocab, (b, s)), 0)
    tt = keep & (pos >= lens // 2)
    labels = rng.randint(0, vocab, (b, s))
    loss_mask = keep & (rng.rand(b, s) < 0.15)
    nsp = rng.randint(0, 2, b)
    return tuple(torch.as_tensor(a).to(dev, dt) for a, dt in (
        (tokens, torch.long), (keep, torch.int32), (tt, torch.long),
        (labels, torch.long), (loss_mask, torch.float32),
        (nsp, torch.long)))


def bert_loss(model, tokens, keep, tt, labels, loss_mask, nsp):
    """The reference's BERT-Large step loss (``bench.py`` :852-862)."""
    return bert_loss_fn(*model(tokens, keep, tt), labels, loss_mask, nsp)


def _bert_grads(step, fwd, batch):
    """The loss and the flat gradient of one BERT forward through
    ``fwd`` (the model's kernel path or its ``forward_plain``)."""
    tokens, keep, tt, labels, loss_mask, nsp = batch
    step._grad.zero_()
    loss = bert_loss_fn(*fwd(tokens, keep, tt), labels, loss_mask, nsp)
    loss.backward()
    torch.cuda.synchronize()
    return float(loss.detach()), step._grad.clone()


# the kernel path, each kernel family alone, and the plain path: where a
# gap between kernels and plain versions at batch 2 comes from
OP_MIXES = {"kernels": KERNEL_OPS,
            "layer_norm_kernel_only": PLAIN_OPS._replace(
                layer_norm=KERNEL_OPS.layer_norm),
            "softmax_kernel_only": PLAIN_OPS._replace(
                softmax=KERNEL_OPS.softmax)}


def op_mixes(grads_of, space) -> dict:
    """``grads_of(ops) -> (loss, flat grad)`` through each of OP_MIXES
    and through the plain versions: each mix's loss gap to the plain
    path and its gradients' relative L2 errors per parameter (the worst,
    and the median over parameters)."""
    loss_p, gp = grads_of(PLAIN_OPS)
    plain = space.unpack(gp, "buffer")
    out = {"plain_loss": loss_p}
    for name, ops in OP_MIXES.items():
        loss, g = grads_of(ops)
        errs = sorted(
            (float((a - plain[n]).norm() / plain[n].norm().clamp_min(1e-30)),
             n) for n, a in space.unpack(g, "buffer").items())
        del g
        out[name] = {"loss": loss, "loss_gap": abs(loss - loss_p),
                     "worst": errs[-3:][::-1],
                     "median": errs[len(errs) // 2][0]}
        print(f"  batch 2, {name} vs plain: loss {loss:.5f} vs {loss_p:.5f} "
              f"(|diff| {abs(loss - loss_p):.3e}); gradient relative L2 "
              f"error median {out[name]['median']:.3e}, worst "
              + ", ".join(f"{e:.3e} ({n})" for e, n in out[name]["worst"]))
    return out


SOFTMAX_KERNEL_KEYS = ("softmax_fwd", "softmax_bwd")
FLASH_KERNELS = (attention.KERNEL, attention.BWD_DQ_KERNEL,
                 attention.BWD_DKV_KERNEL)
SOFTMAX_KERNELS = (softmax.SCALED_KERNEL, softmax.CAUSAL_KERNEL,
                   softmax.MASKED_KERNEL, softmax.BWD_KERNEL)
LAMB_KERNELS = (engine.SUMSQ_KERNEL, mt_ops.LAMB_STAGE1_KERNEL,
                mt_ops.LAMB_STAGE2_KERNEL, SEGMENT_KERNEL)


def train_bert(seed: int, dev, card: str) -> dict:
    """BERT-Large pretraining with FusedLAMB (NVLAMB) on one batch of 8 x
    512: at batch 2 on the initial weights, the kernel path's loss and
    gradients against the plain path's (softmax backend) and the two
    backends' losses against each other; then ten steps on each backend
    from the same weights."""
    batch = bert_batch(seed, dev, 30528)
    b2 = tuple(t[:2] for t in batch)
    padded, real = len(BERT_LENS) * 512, sum(BERT_LENS)
    out, b2_loss = {}, {}
    for backend in ("softmax", "flash"):
        cfg = BertConfig.bert_large(attention_backend=backend)
        t0 = time.perf_counter()
        model = BertModel(cfg, device=dev,
                          generator=torch.Generator().manual_seed(seed))
        opt = FusedLAMB(lr=1e-4, weight_decay=0.01, max_grad_norm=1.0,
                        use_nvlamb=True)
        step = PretrainStep(model, opt, loss_fn=bert_loss)
        state = step.init()
        print(f"  BERT-Large ({backend} backend): "
              f"{sum(p.numel() for p in model.parameters())} parameters, "
              f"flat buffers of {state.master.numel()} fp32, batch 8 x 512 "
              f"({real} real tokens), set-up "
              f"{time.perf_counter() - t0:.1f} s")
        if backend == "softmax":
            mix = op_mixes(lambda ops: _bert_grads(
                step, lambda *a: model._forward(*a, ops), b2), state.space)
            b2_loss[backend] = mix["kernels"]["loss"]
        else:
            mix = None
            b2_loss[backend], g = _bert_grads(step, model, b2)
            del g
        res = {"batch2_loss": b2_loss[backend], "batch2_mixes": mix}
        state, losses, times, launches = _train_loop(step, state, batch,
                                                     BERT_STEPS)
        peak = torch.cuda.max_memory_allocated()
        step_s = float(np.median(times[2:]))
        print(f"  losses {[round(v_, 4) for v_ in losses]}")
        print(f"  launches over {BERT_STEPS} steps {launches}")
        print(f"  BERT-Large {backend}: step_ms median of the last "
              f"{BERT_STEPS - 2} {step_s * 1e3:.2f} (first "
              f"{times[0] * 1e3:.1f}), tokens_per_s {padded / step_s:.0f} "
              f"padded, {real / step_s:.0f} real; peak memory "
              f"{peak / 2**30:.2f} GiB on {card}")
        check(all(np.isfinite(losses)), f"BERT ({backend}): non-finite loss")
        check(losses[-1] < losses[0],
              f"BERT ({backend}): the loss did not fall")
        path = (layer_norm.KERNEL, layer_norm.BWD_KERNEL) + LAMB_KERNELS
        if backend == "softmax":
            for k in (softmax.MASKED_KERNEL, softmax.BWD_KERNEL):
                check(launches.get(k, 0) == cfg.num_layers * BERT_STEPS,
                      f"{k} launched {launches.get(k, 0)} times, not "
                      f"{cfg.num_layers} a step")
            absent = FLASH_KERNELS
        else:
            path += FLASH_KERNELS
            absent = SOFTMAX_KERNELS
        for k in path:
            check(launches.get(k, 0) > 0,
                  f"kernel {k} never launched on the BERT {backend} path")
        for k in absent:
            check(launches.get(k, 0) == 0,
                  f"kernel {k} launched on the BERT {backend} path")
        # the step's result is dropped here: it holds the optimizer state,
        # which the next backend's run must not find still allocated
        prof = _profiled(lambda: step(state, *batch), f"BERT {backend} step",
                         {"softmax": SOFTMAX_KERNEL_KEYS,
                          "optimizer": OPT_KERNEL_KEYS})[1]
        res.update(launches=launches, steps=BERT_STEPS, losses=losses,
                   step_ms=step_s * 1e3, step_ms_all=[t * 1e3 for t in times],
                   tokens_per_s_padded=padded / step_s,
                   tokens_per_s_real=real / step_s, peak_gib=peak / 2**30,
                   profile=prof)
        out[backend] = res
        del model, step, state, opt
        torch.cuda.empty_cache()
    gap = abs(b2_loss["softmax"] - b2_loss["flash"])
    print(f"  batch 2, softmax vs flash backend on the same weights: loss "
          f"{b2_loss['softmax']:.5f} vs {b2_loss['flash']:.5f}, |diff| "
          f"{gap:.3e} (tol {BACKEND_LOSS_TOL})")
    check(gap <= BACKEND_LOSS_TOL, "BERT backends disagree")
    # checked after both runs, so that a gap still leaves their numbers
    mix = out["softmax"]["batch2_mixes"]
    check(mix["kernels"]["loss_gap"] <= BERT_LOSS_TOL,
          "BERT loss: kernel path disagrees with the plain path")
    check(mix["kernels"]["worst"][0][0] <= BERT_GRAD_REL_TOL,
          "BERT gradients: kernel path disagrees with the plain path")
    check(mix["softmax_kernel_only"]["loss_gap"] <= TRAIN_LOSS_TOL,
          "BERT loss: the softmax kernel alone moves it beyond the GPT "
          "tolerance")
    # the dispatcher's mask-free branch (#10), forward and backward, at
    # the BERT scores' shape, with the counts set to 0 just before
    gen = torch.Generator().manual_seed(seed)
    scores = torch.randn(8, 16, 512, 512, generator=gen).to(
        dev, torch.bfloat16).requires_grad_()
    _build.reset_launch_counts()
    FusedScaleMaskSoftmax(input_in_bf16=True)(scores).float().sum().backward()
    torch.cuda.synchronize()
    out["dispatcher_launches"] = _build.launch_counts()
    print(f"  FusedScaleMaskSoftmax(mask=None) forward and backward: "
          f"launches {out['dispatcher_launches']}")
    check(out["dispatcher_launches"].get(softmax.SCALED_KERNEL, 0) == 1
          and out["dispatcher_launches"].get(softmax.BWD_KERNEL, 0) == 1,
          "the dispatcher's mask-free branch did not run its kernels")
    out["backend_loss_gap"] = gap
    return out


def train_gpt_softmax(seed: int, dev, card: str) -> dict:
    """GPT-2 345M on the softmax attention backend with FusedAdam: at
    batch 2 on the initial weights, the kernel path's loss and gradients
    against the plain path's and the loss against the flash backend's;
    then GPT_SOFTMAX_STEPS steps on one batch of 8 x 1024."""
    cfg = GPTConfig.gpt2_345m(attention_backend="softmax")
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
    print(f"  GPT-2 345M (softmax backend), set-up "
          f"{time.perf_counter() - t0:.1f} s")
    x2, y2 = x[:2], y[:2]
    mix = op_mixes(lambda ops: _grads(
        step, model, lambda t: model._forward(t, None, None, None, False,
                                              ops), x2, y2), state.space)
    loss_k = mix["kernels"]["loss"]
    flash = init_gpt_pretrain_params(
        GPTConfig.gpt2_345m(), torch.Generator().manual_seed(seed),
        device=dev)
    with torch.no_grad():
        loss_f = float(gpt_loss_fn(flash(x2), y2))
    del flash
    print(f"  batch 2, flash backend's loss on the same weights {loss_f:.5f} "
          f"(|diff| {abs(loss_k - loss_f):.3e}, tol {BACKEND_LOSS_TOL})")
    state, losses, times, launches = _train_loop(step, state, (x, y),
                                                 GPT_SOFTMAX_STEPS)
    peak = torch.cuda.max_memory_allocated()
    step_s = float(np.median(times[1:]))
    print(f"  losses {[round(v_, 4) for v_ in losses]}; launches over "
          f"{GPT_SOFTMAX_STEPS} steps {launches}")
    print(f"  GPT-2 345M softmax backend: step_ms median of the last "
          f"{GPT_SOFTMAX_STEPS - 1} {step_s * 1e3:.2f} (first "
          f"{times[0] * 1e3:.1f}), tokens_per_s "
          f"{TRAIN_BATCH * cfg.max_seq_len / step_s:.0f}, peak memory "
          f"{peak / 2**30:.2f} GiB on {card}")
    check(all(np.isfinite(losses)), "GPT softmax: non-finite loss")
    check(mix["kernels"]["loss_gap"] <= TRAIN_LOSS_TOL,
          "GPT softmax loss: kernel path disagrees with the plain path")
    check(mix["kernels"]["worst"][0][0] <= TRAIN_GRAD_REL_TOL,
          "GPT softmax gradients: kernel path disagrees with the plain path")
    check(abs(loss_k - loss_f) <= BACKEND_LOSS_TOL,
          "GPT softmax and flash backends disagree")
    for k in (softmax.CAUSAL_KERNEL, softmax.BWD_KERNEL):
        check(launches.get(k, 0) == cfg.num_layers * GPT_SOFTMAX_STEPS,
              f"{k} launched {launches.get(k, 0)} times, not "
              f"{cfg.num_layers} a step")
    for k in FLASH_KERNELS:
        check(launches.get(k, 0) == 0,
              f"kernel {k} launched on the GPT softmax path")
    return {"launches": launches, "steps": GPT_SOFTMAX_STEPS,
            "losses": losses, "step_ms": step_s * 1e3,
            "step_ms_all": [t * 1e3 for t in times],
            "tokens_per_s": TRAIN_BATCH * cfg.max_seq_len / step_s,
            "peak_gib": peak / 2**30, "batch2_mixes": mix,
            "batch2_flash_loss": loss_f}


# -- phase 8: ResNet-50 ImageNet training --------------------------------------

RESNET_SHARES = {
    "optimizer": ("sgd_kernel", "lars_kernel", "sumsq_kernel"),
    "conv": ("xmma", "conv", "Conv", "cudnn", "implicit", "cutlass",
             "gemm", "wgrad", "dgrad", "fprop", "nchw", "nhwc"),
    "casts": ("direct_copy", "copy_kernel"),
    "bn_reductions": ("reduce_kernel",),
    "bn_elementwise": ("elementwise",),
}


def resnet_loss(model, x, y):
    return cross_entropy_logits(model(x), y)


def _stats_finite(model) -> bool:
    return all(bool(torch.isfinite(b).all()) for b in model.buffers())


def resnet_fp32_check(seed: int, dev, x) -> dict:
    """The card's fp32 forward (train mode: batch statistics, running
    statistics updated) against the same model and weights on the CPU,
    at batch 2. cuDNN runs without TF32 (main sets allow_tf32 False)."""
    cfg = ResNetConfig.resnet50(dtype=torch.float32)
    gpu = ResNet(cfg, device=dev, generator=torch.Generator().manual_seed(seed))
    cpu = ResNet(cfg, device="cpu",
                 generator=torch.Generator().manual_seed(seed))
    x2 = x[:2]
    with torch.no_grad():
        got = gpu(x2).cpu()
        want = cpu(x2.cpu())
    logit = float((got - want).abs().max() / want.abs().max())
    own = cpu.state_dict()
    stats = max(float((b.cpu() - own[k]).abs().max() / own[k].abs().max())
                for k, b in gpu.named_buffers())
    print(f"  fp32 forward at batch 2, card (cuDNN, allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}) vs CPU on the same weights: "
          f"logits {logit:.3e}, running statistics {stats:.3e} of their "
          f"largest |value| (tol {RESNET_FP32_TOL})")
    check(logit <= RESNET_FP32_TOL and stats <= RESNET_FP32_TOL,
          "ResNet-50 fp32 forward: the card disagrees with the CPU")
    return {"logit_rel_err": logit, "stats_rel_err": stats}


def _resnet_run(label, model, step, state, x, y, steps, card):
    """``steps`` steps of ``step`` (``state, loss = step(state, x, y)``)
    with the launch counts set to 0 just before and read just after, then
    one profiled step: the run's numbers."""
    state, losses, times, launches = _train_loop(step, state, (x, y), steps)
    peak = torch.cuda.max_memory_allocated()
    step_s = float(np.median(times[2:] if steps > 3 else times[1:]))
    print(f"  {label}: losses {[round(v_, 4) for v_ in losses]}")
    print(f"    launches over {steps} steps {launches}")
    print(f"    step_ms median of steps {3 if steps > 3 else 2}-{steps} "
          f"{step_s * 1e3:.2f} (first {times[0] * 1e3:.1f}), images_per_s "
          f"{RESNET_BATCH / step_s:.1f}, peak memory {peak / 2**30:.2f} GiB "
          f"on {card}")
    check(all(np.isfinite(losses)), f"ResNet-50 {label}: non-finite loss")
    # at the reference bench's lr 0.1 and momentum 0.9 on one fixed batch
    # the loss falls for two steps and then climbs: the reference's own
    # trajectory does the same (a CPU run at full depth, reduced batch)
    check(losses[1] < losses[0], f"ResNet-50 {label}: the first update "
          "did not lower the loss")
    check(_stats_finite(model), f"ResNet-50 {label}: non-finite BatchNorm "
          "running statistics")
    (state, _), prof = _profiled(lambda: step(state, x, y),
                                 f"ResNet-50 {label} step", RESNET_SHARES)
    return state, {"launches": launches, "steps": steps, "losses": losses,
                   "step_ms": step_s * 1e3,
                   "step_ms_all": [t * 1e3 for t in times],
                   "images_per_s": RESNET_BATCH / step_s,
                   "peak_gib": peak / 2**30, "profile": prof}


def train_resnet(seed: int, dev, card: str) -> dict:
    """ResNet-50 at 128 x 224^2 on one synthetic batch: the fp32 forward
    against the CPU at batch 2; FusedSGD with bf16 compute (10 steps);
    amp O2 (fp16 compute, fp32 master, the dynamic loss scaler; 10 steps
    and one with an inf in the gradient, skipped); FusedLARS and
    LARC(FusedSGD) (3 steps each)."""
    rng = np.random.RandomState(seed)
    x = torch.as_tensor(rng.randn(RESNET_BATCH, RESNET_HW, RESNET_HW, 3)
                        .astype(np.float32), device=dev)
    y = torch.as_tensor(rng.randint(0, 1000, RESNET_BATCH), device=dev)
    out = {"fp32_check": resnet_fp32_check(seed, dev, x)}

    def build(cfg):
        return ResNet(cfg, device=dev,
                      generator=torch.Generator().manual_seed(seed))

    # FusedSGD, bf16 compute (the reference bench's headline)
    t0 = time.perf_counter()
    model = build(ResNetConfig.resnet50())
    opt = FusedSGD(**RESNET_SGD)
    step = PretrainStep(model, opt, loss_fn=resnet_loss)
    state = step.init()
    print(f"  ResNet-50: {sum(p.numel() for p in model.parameters())} "
          f"parameters in {state.space.num_leaves} tensors, flat buffers of "
          f"{state.master.numel()} fp32, batch {RESNET_BATCH} x {RESNET_HW}^2"
          f", set-up {time.perf_counter() - t0:.1f} s")
    state, run = _resnet_run("FusedSGD bf16", model, step, state, x, y,
                             RESNET_STEPS, card)
    check(run["launches"].get(mt_ops.SGD_KERNEL, 0) == RESNET_STEPS
          and run["launches"].get(mt_ops.LARS_KERNEL, 0) == 0,
          "fused_sgd not launched once a step on the SGD run")
    out["sgd_bf16"] = run
    del model, step, state, opt
    torch.cuda.empty_cache()

    # amp O2: fp16 compute, fp32 master, the dynamic loss scaler
    model = build(ResNetConfig.resnet50(dtype=torch.float16))
    opt = FusedSGD(**RESNET_SGD)
    _, state, amp_state = amp.initialize(dict(model.named_parameters()), opt,
                                         opt_level="O2")
    check(amp_state.properties.cast_model_type == model.config.dtype,
          "O2's cast type is not the model's compute dtype")
    scaler = amp.make_scaler(amp_state.properties)
    step = PretrainStep(model, opt, loss_fn=resnet_loss,
                        train_step=make_train_step(opt, scaler=scaler))
    box = {"ss": amp_state.scalers[0], "skipped": 0}

    def o2_step(st, xb, yb):
        st, box["ss"], loss = step(st, xb, yb, scaler_state=box["ss"])
        box["skipped"] += int(box["ss"].found_inf > 0)
        return st, loss

    state, run = _resnet_run("amp O2 fp16", model, o2_step, state, x, y,
                             RESNET_STEPS, card)
    check(run["launches"].get(mt_ops.SGD_KERNEL, 0) == RESNET_STEPS,
          "fused_sgd not launched once a step on the O2 run")
    # an inf in the gradient: skipped, master and momentum exactly as
    # they were, the scale halved
    ss = box["ss"]
    step.backward(state, x, y, scaler_state=ss)
    step.grad[12345] = float("inf")
    before = (state.master.clone(), state.slots["momentum"].clone(),
              state.count)
    state2, ss2, aux = step.train_step(state, step.grad, ss)
    torch.cuda.synchronize()
    skipped = (float(aux.found_inf) == 1.0
               and torch.equal(state2.master, before[0])
               and torch.equal(state2.slots["momentum"], before[1])
               and state2.count == before[2]
               and ss2.loss_scale == ss.loss_scale / 2)
    print(f"    injected inf: found_inf {float(aux.found_inf)}, master and "
          f"momentum unchanged, count {state2.count}, scale "
          f"{ss.loss_scale} -> {ss2.loss_scale}: {skipped}; skipped in the "
          f"{RESNET_STEPS} steps before it: {box['skipped']}")
    check(skipped, "the O2 step with an inf was not skipped")
    run.update(final_loss_scale=ss2.loss_scale,
               skipped_steps=box["skipped"] + 1, count=state2.count)
    out["o2_fp16"] = run
    del model, step, state, state2, opt, before
    torch.cuda.empty_cache()

    # the large-batch optimizers: FusedLARS, LARC around FusedSGD
    for key, opt in (("lars", FusedLARS(**RESNET_SGD)),
                     ("larc", LARC(FusedSGD(**RESNET_SGD)))):
        model = build(ResNetConfig.resnet50())
        step = PretrainStep(model, opt, loss_fn=resnet_loss)
        state, run = _resnet_run(type(opt).__name__ + " bf16", model, step,
                                 step.init(), x, y, RESNET_LARS_STEPS, card)
        n = RESNET_LARS_STEPS
        want = ({mt_ops.LARS_KERNEL: n, engine.SUMSQ_KERNEL: 2 * n,
                 mt_ops.SGD_KERNEL: 0} if key == "lars" else
                {mt_ops.SGD_KERNEL: n, mt_ops.LARS_KERNEL: 0})
        check(all(run["launches"].get(k, 0) == v for k, v in want.items()),
              f"ResNet-50 {key}: launches {run['launches']}, expected {want}")
        out[key] = run
        del model, step, state, opt
        torch.cuda.empty_cache()
    return out


# -- phase 9: GPT-2 345M with FusedNovoGrad + clip, FusedAdagrad + scaler ----

NOVOGRAD_KEYS = ("sumsq_kernel", "scale_kernel", "novograd_kernel")
ADAGRAD_KEYS = ("sumsq_kernel", "adagrad_kernel")
GPT_PATH = (layer_norm.KERNEL, layer_norm.BWD_KERNEL, attention.KERNEL,
            attention.BWD_DQ_KERNEL, attention.BWD_DKV_KERNEL)


def _gpt_batch(seed: int, dev, cfg: GPTConfig):
    """Phase 4's batch of TRAIN_BATCH x 1024 tokens from the seed."""
    rng = np.random.RandomState(seed)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size,
                                       (TRAIN_BATCH, cfg.max_seq_len + 1)),
                           device=dev).long()
    return toks[:, :-1], toks[:, 1:]


def _run_summary(label, losses, times, launches, peak, card, cfg) -> dict:
    step_s = float(np.median(times[2:]))
    tokens = TRAIN_BATCH * cfg.max_seq_len
    print(f"  {label}: losses {[round(v_, 4) for v_ in losses]}")
    print(f"  {label}: launches over {len(losses)} steps {launches}")
    print(f"  {label}: step_ms median of steps 3-{len(losses)} "
          f"{step_s * 1e3:.2f} (first {times[0] * 1e3:.1f}), tokens_per_s="
          f"{tokens / step_s:.0f}, peak memory {peak / 2**30:.2f} GiB on "
          f"{card}")
    check(all(np.isfinite(losses)), f"non-finite training loss ({label})")
    return {"launches": launches, "steps": len(losses), "losses": losses,
            "step_ms": step_s * 1e3, "step_ms_all": [t * 1e3 for t in times],
            "tokens_per_s": tokens / step_s, "peak_gib": peak / 2**30}


def _check_launches(label, launches, per_step, steps) -> None:
    """Each kernel of ``per_step`` launched exactly that many times a
    step, and the GPT model's kernels at least once."""
    for kernel, k in per_step.items():
        check(launches.get(kernel, 0) == k * steps,
              f"{label}: {kernel} launched {launches.get(kernel, 0)} times "
              f"in {steps} steps, not {k} a step")
    for kernel in GPT_PATH:
        check(launches.get(kernel, 0) > 0,
              f"{label}: kernel {kernel} never launched")


def train_novograd(seed: int, dev, card: str) -> dict:
    """GPT-2 345M with FusedNovoGrad and the contrib clip, the reference
    user's loop: ``PretrainStep.backward``, ``clip_grad_norm_`` on the
    flat gradient, ``FusedNovoGrad.step_flat``; ten steps with the launch
    counts set to 0 just before and read just after, one profiled step,
    then one update through the kernels and through their plain versions
    on the real (clipped) gradient."""
    cfg = GPTConfig.gpt2_345m()           # bf16 compute, fp32 parameters
    t0 = time.perf_counter()
    model = init_gpt_pretrain_params(
        cfg, torch.Generator().manual_seed(seed), device=dev)
    opt = FusedNovoGrad(lr=NOVOGRAD_LR, betas=NOVOGRAD_BETAS,
                        weight_decay=NOVOGRAD_WD)
    step = PretrainStep(model, opt)
    state = step.init()
    x, y = _gpt_batch(seed, dev, cfg)
    print(f"  GPT-2 345M with FusedNovoGrad(lr={NOVOGRAD_LR}, betas="
          f"{NOVOGRAD_BETAS}, weight_decay={NOVOGRAD_WD}) and "
          f"clip_grad_norm_(max_norm={CLIP_NORM}): flat buffers of "
          f"{state.master.numel()} fp32, v of {state.slots['v'].numel()} "
          f"leaves, set-up {time.perf_counter() - t0:.1f} s")
    norms = []

    def novo_step(state, x, y):
        loss = step.backward(state, x, y)
        _, norm = clip_grad_norm_(step.grad, max_norm=CLIP_NORM)
        norms.append(norm)
        _, state = opt.step_flat(state, step.grad)
        return state, loss

    state, losses, times, launches = _train_loop(novo_step, state, (x, y),
                                                 NOVOGRAD_STEPS)
    out = _run_summary("NovoGrad", losses, times, launches,
                       torch.cuda.max_memory_allocated(), card, cfg)
    out["grad_norms"] = [float(t) for t in norms]
    print(f"  NovoGrad: global grad norms before the clip "
          f"{[round(v_, 3) for v_ in out['grad_norms']]}")
    check(losses[-1] < losses[0], "the NovoGrad training loss did not fall")
    _check_launches("NovoGrad", launches,
                    {engine.SUMSQ_KERNEL: 2, mt_ops.SCALE_KERNEL: 1,
                     mt_ops.NOVOGRAD_KERNEL: 1}, NOVOGRAD_STEPS)
    (state, _), out["profile"] = _profiled(
        lambda: novo_step(state, x, y), "NovoGrad step",
        {"optimizer": NOVOGRAD_KEYS})
    # the step's three parts, each synchronised (host clock, median of 3)
    parts = {"forward_backward": [], "clip": [], "novograd": []}
    for _ in range(3):
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        step.backward(state, x, y)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        clip_grad_norm_(step.grad, CLIP_NORM)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        _, state = opt.step_flat(state, step.grad)
        torch.cuda.synchronize()
        t.append(time.perf_counter())
        for k, a, b in zip(parts, t, t[1:]):
            parts[k].append(b - a)
    out["split_ms"] = {k: float(np.median(v)) * 1e3 for k, v in parts.items()}
    print("  NovoGrad step's parts (synchronised, median of 3): " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in out["split_ms"].items()))
    # one update from the trained state on the last clipped gradient,
    # kernels against plain versions
    kw = dict(lr=NOVOGRAD_LR, beta1=NOVOGRAD_BETAS[0],
              beta2=NOVOGRAD_BETAS[1], weight_decay=NOVOGRAD_WD,
              step=state.count + 1)
    p, m, v = state.master, state.slots["m"], state.slots["v"]
    outs = [mt_ops.fused_novograd_update(p.clone(), m.clone(), v.clone(),
                                         step.grad, state.space, plain=plain,
                                         **kw)
            for plain in (False, True)]
    torch.cuda.synchronize()
    out["update_excess"] = novograd_excess(
        p, m, *outs, lr_bc1=NOVOGRAD_LR, b1=NOVOGRAD_BETAS[0],
        wd=NOVOGRAD_WD)
    del outs
    e = out["update_excess"]
    print(f"  one NovoGrad update on the real gradient, kernels vs plain: "
          f"v' rel {e['v_rel']:.3e} (tol {NOVOGRAD_TOL}); excess m' "
          f"{e['m']:.3e}, p' {e['p']:.3e} (<= 0 passes)")
    check(e["ok"], "NovoGrad update on the real gradient: kernel path "
          "disagrees with the plain path")
    return out


def train_adagrad(seed: int, dev, card: str) -> dict:
    """GPT-2 345M with FusedAdagrad through ``make_train_step(opt,
    scaler=LossScaler(), max_grad_norm=1.0)`` (the skip path, out of
    place): three steps with the launch counts set to 0 just before and
    read just after, one profiled step, one step with an inf injected
    into the gradient (skipped: master and h bitwise as they were, the
    scale halved), one update through the kernel and its plain version
    on the real gradient, and one gradient accumulation of two real
    gradients through ``multi_tensor_axpby`` (counts reset: no model
    path calls it)."""
    cfg = GPTConfig.gpt2_345m()
    t0 = time.perf_counter()
    model = init_gpt_pretrain_params(
        cfg, torch.Generator().manual_seed(seed), device=dev)
    opt = FusedAdagrad(lr=ADAGRAD_LR, weight_decay=0.01)
    tstep = make_train_step(opt, scaler=LossScaler(), max_grad_norm=CLIP_NORM)
    step = PretrainStep(model, opt, train_step=tstep)
    state = step.init()
    x, y = _gpt_batch(seed, dev, cfg)
    print(f"  GPT-2 345M with make_train_step(FusedAdagrad(lr={ADAGRAD_LR}, "
          f"weight_decay=0.01), scaler=LossScaler(), max_grad_norm="
          f"{CLIP_NORM}): set-up {time.perf_counter() - t0:.1f} s")
    sc = {"ss": tstep.scaler.init()}

    def ada_step(state, x, y):
        state, sc["ss"], loss = step(state, x, y, scaler_state=sc["ss"])
        return state, loss

    state, losses, times, launches = _train_loop(ada_step, state, (x, y),
                                                 ADAGRAD_STEPS)
    out = _run_summary("Adagrad", losses, times, launches,
                       torch.cuda.max_memory_allocated(), card, cfg)
    ss = sc["ss"]
    out["loss_scale"] = ss.loss_scale
    check(losses[1] < losses[0], "the first Adagrad update did not lower "
          "the loss")
    check(state.count == ADAGRAD_STEPS, f"{ADAGRAD_STEPS - state.count} "
          "Adagrad steps skipped without an overflow")
    _check_launches("Adagrad", launches,
                    {engine.SUMSQ_SCALED_KERNEL: 1, mt_ops.ADAGRAD_KERNEL: 1},
                    ADAGRAD_STEPS)
    (state, _), out["profile"] = _profiled(
        lambda: ada_step(state, x, y), "Adagrad step",
        {"optimizer": ADAGRAD_KEYS})
    ss = sc["ss"]
    # an inf in the gradient: skipped, nothing moves, the scale backs off
    step.backward(state, x, y, scaler_state=ss)
    first_grad = step.grad.clone()
    step.grad[12345] = float("inf")
    master, h, count = state.master.clone(), state.slots["h"].clone(), \
        state.count
    state2, ss2, aux = tstep(state, step.grad, ss)
    torch.cuda.synchronize()
    skipped = (float(aux.found_inf) == 1.0
               and torch.equal(state2.master, master)
               and torch.equal(state2.slots["h"], h)
               and state2.count == count
               and ss2.loss_scale == ss.loss_scale / 2)
    print(f"  Adagrad step with an inf: found_inf {float(aux.found_inf)}, "
          f"master and h unchanged, scale {ss.loss_scale} -> "
          f"{ss2.loss_scale}: {skipped}")
    check(skipped, "the overflowing Adagrad step was not skipped")
    out["overflow_skipped"] = skipped
    del master, h
    # one update on the real (scaled) gradient with the train step's
    # device grad_scale (loss scale times the clip factor), kernel vs plain
    norm, _ = mt_ops.fused_unscale_l2norm(first_grad)
    ls = mt_ops._dev_f32(ss.loss_scale, dev)
    clip = torch.maximum(norm / ls / mt_ops._dev_f32(CLIP_NORM, dev),
                         torch.ones((), device=dev))
    kw = dict(lr=ADAGRAD_LR, weight_decay=0.01, grad_scale=ls * clip)
    outs = [mt_ops.fused_adagrad_update(state.master.clone(),
                                        state.slots["h"].clone(), first_grad,
                                        plain=plain, **kw)
            for plain in (False, True)]
    torch.cuda.synchronize()
    out["update_bitwise"] = _bitwise(outs[0][:2], outs[1][:2])
    print(f"  one Adagrad update on the real gradient (grad_scale "
          f"{float(kw['grad_scale']):.1f}), kernel vs plain: bitwise "
          f"{out['update_bitwise']}")
    check(out["update_bitwise"], "Adagrad update on the real gradient: "
          "kernel disagrees with the plain version")
    del outs
    # gradient accumulation: this step's gradient plus the next one's
    step.backward(state, x, y, scaler_state=ss)
    _build.reset_launch_counts()
    acc, found = mt_ops.multi_tensor_axpby(first_grad, step.grad, 1.0, 1.0)
    torch.cuda.synchronize()
    out["axpby_launches"] = _build.launch_counts()
    want = mt_ops.multi_tensor_axpby(first_grad, step.grad, 1.0, 1.0,
                                     plain=True)[0]
    acc_ok = float(found) == 0.0 and _same_bits(acc, want)
    print(f"  gradient accumulation (multi_tensor_axpby of two real "
          f"gradients): found_inf {float(found)}, bitwise to plain "
          f"{acc_ok}; launches {out['axpby_launches']}")
    check(acc_ok and out["axpby_launches"].get(mt_ops.AXPBY_KERNEL) == 1,
          "gradient accumulation through multi_tensor_axpby failed")
    return out


# -- cross entropy and RoPE: the kernels and their paths (phases 2 and 10) ----

# GPT-2 345M's LM loss through contrib xentropy, the reference user's swap
# (MLPerf): label smoothing 0.1, the labels' tails padded with
# XENT_PAD on rows of these real lengths
XENT_SMOOTHING = 0.1
XENT_PAD = 0
XENT_LENS = (1024, 1024, 900, 1024, 700, 1024, 1024, 512)
# the forward's loss and lse, kernel against plain version: fp32
# logsumexp and mean over 50,304 logits summed in another order (an online
# max and rescaled sum per thread, combined across the block), within
# this share of max(1, |value|)
XENT_FWD_TOL = 1e-5
# RoPE at public widths: Llama-2-7B's attention (sbhd, rot = d = 128),
# GPT-NeoX-20B's (64 heads of 96, rotary_pct 0.25: rot 24, 72 channels
# passed through), and eight sequences of 8,192 tokens packed (thd) at
# Llama-2-7B's heads
LLAMA_SBHD = (4096, 2, 32, 128)
NEOX_SBHD = (2048, 4, 64, 96)
NEOX_ROT = 24
THD_LENS = (2048, 512, 1024, 1536, 256, 768, 1280, 768)
THD_HEADS = (32, 128)


def xent_labels(y: torch.Tensor) -> torch.Tensor:
    """(b, s) labels with row i's tail past XENT_LENS[i] set to
    XENT_PAD."""
    real = (torch.arange(y.shape[1], device=y.device)[None, :]
            < torch.tensor(XENT_LENS, device=y.device)[:, None])
    return torch.where(real, y, XENT_PAD)


def xent_loss(model, tokens, labels):
    """The reference user's composed loss: contrib xentropy over (s, b)
    logits, summed, divided by the count of real labels."""
    losses = softmax_cross_entropy(model(tokens.long()), labels.T,
                                   smoothing=XENT_SMOOTHING,
                                   padding_idx=XENT_PAD)
    return losses.sum() / (labels != XENT_PAD).sum()


def xent_loss_plain(model, tokens, labels):
    """:func:`xent_loss` through the plain versions: the model's
    ``forward_plain`` and xentropy's plain forward and backward."""
    logits = model.forward_plain(tokens.long())
    k = logits.shape[-1]
    lab = labels.T
    losses = xentropy._XentropyFn.apply(
        logits.reshape(-1, k), lab.reshape(-1).to(torch.int32),
        XENT_SMOOTHING, False).reshape(lab.shape)
    losses = torch.where(lab == XENT_PAD, 0.0, losses)
    return losses.sum() / (labels != XENT_PAD).sum()


def _ulps(got, want) -> int:
    view = torch.int16 if got.element_size() == 2 else torch.int32
    return int((got.view(view).to(torch.int64)
                - want.view(view).to(torch.int64)).abs().max())


def xentropy_cases(dev) -> list:
    """#14 and #15 at GPT-2 345M's (8 x 1024, 50304) logits, fp32 (its
    fp32 LM head) and bf16, smoothing 0 and 0.1, with padded label rows
    (g = 0 there, as the contrib loss gives): loss and lse within
    XENT_FWD_TOL, dx bitwise given the same lse, padding rows exactly 0.
    The library yardstick: ``F.cross_entropy(..., reduction="none",
    label_smoothing=s, ignore_index=pad)`` forward and its backward (the
    same smoothing: lse - (1 - s) x[y] - s mean(x))."""
    cfg = GPTConfig.gpt2_345m()
    seq, k = cfg.max_seq_len, cfg.vocab_size
    rows = TRAIN_BATCH * seq
    cgen = torch.Generator(device=dev).manual_seed(7)
    y = torch.randint(1, k, (seq, TRAIN_BATCH), generator=cgen, device=dev)
    y = xent_labels(y.T).T.reshape(-1).to(torch.int32)   # (s, b) order
    real = y != XENT_PAD
    g = torch.where(real, 1.0 / float(real.sum()), 0.0)
    fwd, bwd = [], []
    for dtype in (torch.float32, torch.bfloat16):
        x = (2 * torch.randn(rows, k, generator=cgen, device=dev)).to(dtype)
        for s in (XENT_SMOOTHING, 0.0):
            loss, lse = xentropy._fwd_cuda(x, y, s)
            want_loss, want_lse = xentropy._fwd_torch(x, y, s)
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max()) for a, b in
                      ((loss, want_loss), (lse, want_lse)))
            rel = max(float(((a - b).abs() / b.abs().clamp_min(1.0)).max())
                      for a, b in ((loss, want_loss), (lse, want_lse)))
            name = f"{str(dtype)[6:]} s={s}"
            print(f"  {xentropy.FWD_KERNEL}[{name}] ({rows}, {k}): "
                  f"max_abs_err={err:.3e} rel={rel:.3e} (tol {XENT_FWD_TOL})")
            check(bool(torch.isfinite(loss).all()), "non-finite loss")
            check(rel <= XENT_FWD_TOL, f"{xentropy.FWD_KERNEL}[{name}] "
                  "disagrees with its plain version")
            dx = xentropy._bwd_cuda(x, y, want_lse, g, s)
            want_dx = xentropy._bwd_torch(x, y, want_lse, g, s)
            torch.cuda.synchronize()
            ulps = _ulps(dx, want_dx)
            pad_zero = bool((dx[~real] == 0).all())
            derr = float((dx.float() - want_dx.float()).abs().max())
            print(f"  {xentropy.BWD_KERNEL}[{name}]: bitwise {ulps == 0} "
                  f"(max {ulps} ulps, max_abs_err={derr:.3e}), padding rows "
                  f"exactly 0: {pad_zero}")
            check(ulps == 0, f"{xentropy.BWD_KERNEL}[{name}] is not bitwise "
                  "equal to its plain version given the same lse")
            check(pad_zero, f"{xentropy.BWD_KERNEL}[{name}]: padding rows "
                  "not 0")
            del dx, want_dx, want_loss, loss
            case_f = {"case": name, "max_abs_err": err, "rel_err": rel,
                      "shape": f"({rows}, {k}) {str(dtype)[6:]}"}
            case_b = {"case": name, "max_abs_err": derr, "ulps": ulps,
                      "shape": case_f["shape"]}
            if s == XENT_SMOOTHING:
                f_k = lambda: xentropy._fwd_cuda(x, y, s)  # noqa: E731
                b_k = lambda: xentropy._bwd_cuda(  # noqa: E731
                    x, y, want_lse, g, s)
                case_f["ms"] = device_ms(f_k)
                case_b["ms"] = device_ms(b_k)
                case_f["plain_ms"] = device_ms(
                    lambda: xentropy._fwd_torch(x, y, s), iters=3,
                    replays=2)
                case_b["plain_ms"] = device_ms(
                    lambda: xentropy._bwd_torch(x, y, want_lse, g, s),
                    iters=3, replays=2)
                yl = y.long()
                lib = lambda: F.cross_entropy(  # noqa: E731
                    x, yl, reduction="none", label_smoothing=s,
                    ignore_index=XENT_PAD)
                case_f["library_ms"] = _library_ms(xentropy.FWD_KERNEL, lib)
                xl = x.detach().requires_grad_()
                with torch.enable_grad():    # phase 2 runs under no_grad
                    out = F.cross_entropy(xl, yl, reduction="none",
                                          label_smoothing=s,
                                          ignore_index=XENT_PAD)
                case_b["library_ms"] = _library_ms(
                    xentropy.BWD_KERNEL, lambda: torch.autograd.grad(
                        out, xl, g, retain_graph=True))
                del xl, out
                # forward: logits and labels read, loss and lse written;
                # per logit a max, a subtract, an exp and two sums.
                # backward: logits, labels, lse and g read, dx written;
                # per logit a subtract, an exp, a select, two subtracts
                # and a product
                case_f["bound_ms"], case_f["bound_by"] = bound(
                    nbytes(x, y) + 2 * 4 * rows, 5 * x.numel(),
                    PEAK_FP32_FLOPS)
                case_b["bound_ms"], case_b["bound_by"] = bound(
                    nbytes(x, y, want_lse, g, x), 6 * x.numel(),
                    PEAK_FP32_FLOPS)
                for c in (case_f, case_b):
                    lm = c["library_ms"]
                    print(f"    [{c['case']}] ms={c['ms']:.5f} plain_ms="
                          f"{c['plain_ms']:.5f} library_ms="
                          f"{lm if lm is None else round(lm, 5)} "
                          f"bound_ms={c['bound_ms']:.5f} ({c['bound_by']})")
            fwd.append(case_f)
            bwd.append(case_b)
            del lse, want_lse
        del x
        torch.cuda.empty_cache()
    out = []
    for name, line, cases in ((xentropy.FWD_KERNEL, 32, fwd),
                              (xentropy.BWD_KERNEL, 47, bwd)):
        top = {k_: v_ for k_, v_ in cases[0].items() if k_ != "case"}
        out.append({"name": name, "route": "cuda",
                    "source": "apex_tpu_torch/csrc/xentropy.cu",
                    "replaces": f"apex_tpu/ops/xentropy.py:{line}", **top,
                    "max_abs_err": max(c["max_abs_err"] for c in cases),
                    "cases": cases})
    return out


def rope_freqs(s: int, rot: int, dev) -> torch.Tensor:
    """(s, 1, 1, rot) angles as Megatron builds them: position times
    1 / 10000^(2i / rot), the half duplicated."""
    inv = 1.0 / (10000 ** (torch.arange(0, rot, 2, device=dev).float()
                           / rot))
    ang = torch.outer(torch.arange(s, device=dev).float(), inv)
    return torch.cat([ang, ang], dim=-1)[:, None, None, :]


def _thd_cu(dev) -> torch.Tensor:
    return torch.tensor(np.concatenate([[0], np.cumsum(THD_LENS)]),
                        dtype=torch.int32, device=dev)


def rope_case(name, t, cos, sin, cu) -> dict:
    """The RoPE kernel forward and backward (-sin flag) against the plain
    version on the same tables: bitwise."""
    if cu is None:
        c, s_ = cos, sin
    else:       # the plain version's per-token tables
        pos = rope._thd_positions(cu, t.shape[0], cos.shape[0])
        c, s_ = cos[pos][:, None], sin[pos][:, None]
    got = rope._rope_cuda(t, cos, sin, cu)
    back = rope._rope_cuda(t, cos, sin, cu, negate=True)
    want = rope._apply_torch(t, c, s_)
    want_back = rope._apply_torch(t, c, -s_)
    torch.cuda.synchronize()
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in ((got, want), (back, want_back)))
    ok = _same_bits(got, want) and _same_bits(back, want_back)
    print(f"  rope[{name}] {tuple(t.shape)} {str(t.dtype)[6:]} rot "
          f"{cos.shape[-1]}: forward and -sin backward bitwise {ok} "
          f"(max_abs_err={err:.3e})")
    check(ok, f"rope[{name}] kernel is not bitwise equal to its plain "
          "version")
    del got, back, want, want_back
    kernel = lambda: rope._rope_cuda(t, cos, sin, cu)  # noqa: E731
    ms = device_ms(kernel)
    plain_ms = device_ms(lambda: rope._apply_torch(t, c, s_), iters=3,
                         replays=2)
    # t read and written once, the tables read once; three fp32
    # operations per rotated channel
    rot = cos.shape[-1]
    b_ms, by = bound(2 * nbytes(t) + nbytes(cos, sin),
                     3 * t.numel() // t.shape[-1] * rot, PEAK_FP32_FLOPS)
    print(f"    ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms=None "
          f"(no single PyTorch call) bound_ms={b_ms:.5f} ({by})")
    return {"case": name, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": b_ms,
            "bound_by": by,
            "shape": f"{tuple(t.shape)} {str(t.dtype)[6:]}, rot {rot}"}


def rope_cases(dev) -> dict:
    """#16 at its public widths: Llama-2-7B's sbhd in bf16 (the headline)
    and fp32, GPT-NeoX-20B's cached (rot 24 of 96), and the packed thd
    layout at Llama-2-7B's heads."""
    cgen = torch.Generator(device=dev).manual_seed(16)
    rnd = lambda shape, dt: torch.randn(  # noqa: E731
        shape, generator=cgen, device=dev).to(dt)
    cases = []
    f = rope_freqs(LLAMA_SBHD[0], LLAMA_SBHD[3], dev)
    cos, sin = torch.cos(f), torch.sin(f)
    for dt in (torch.bfloat16, torch.float32):
        cases.append(rope_case(f"llama2_7b_sbhd_{str(dt)[6:]}",
                               rnd(LLAMA_SBHD, dt), cos, sin, None))
        torch.cuda.empty_cache()
    f = rope_freqs(NEOX_SBHD[0], NEOX_ROT, dev)
    cases.append(rope_case("neox20b_cached", rnd(NEOX_SBHD, torch.bfloat16),
                           torch.cos(f), torch.sin(f), None))
    tab = rope_freqs(max(THD_LENS), THD_HEADS[1], dev)[:, 0, 0]
    cases.append(rope_case("llama2_7b_thd",
                           rnd((sum(THD_LENS), *THD_HEADS), torch.bfloat16),
                           torch.cos(tab), torch.sin(tab), _thd_cu(dev)))
    top = {k_: v_ for k_, v_ in cases[0].items() if k_ != "case"}
    return {"name": rope.KERNEL, "route": "cuda",
            "source": "apex_tpu_torch/csrc/rope.cu",
            "replaces": "apex_tpu/ops/rope.py:58", **top,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "cases": cases}


def _xent_grads(step, fwd_loss, x, y):
    """The loss and the flat gradient of ``fwd_loss`` at one batch."""
    step._grad.zero_()
    loss = fwd_loss(step.model, x, y)
    loss.backward()
    torch.cuda.synchronize()
    return float(loss.detach()), step._grad.clone()


def train_xentropy(seed: int, dev, card: str) -> dict:
    """GPT-2 345M (phase 4's model, weights and batch) with the contrib
    xentropy loss through ``PretrainStep(model, FusedAdam(lr=1e-4,
    weight_decay=0.01), loss_fn=xent_loss)``: at batch 2 on the initial
    weights the loss and every gradient through the kernels against the
    plain versions; then ten steps with the launch counts set to 0 just
    before and read just after (each xentropy kernel and Adam once a
    step), one profiled step."""
    cfg = GPTConfig.gpt2_345m()
    t0 = time.perf_counter()
    model = init_gpt_pretrain_params(
        cfg, torch.Generator().manual_seed(seed), device=dev)
    step = PretrainStep(model, FusedAdam(lr=1e-4, weight_decay=0.01),
                        loss_fn=xent_loss)
    state = step.init()
    x, y = _gpt_batch(seed, dev, cfg)
    y = xent_labels(y)
    real = int((y != XENT_PAD).sum())
    print(f"  GPT-2 345M with softmax_cross_entropy(smoothing="
          f"{XENT_SMOOTHING}, padding_idx={XENT_PAD}) and FusedAdam(lr=1e-4, "
          f"weight_decay=0.01): {real} real labels of "
          f"{y.numel()}, set-up {time.perf_counter() - t0:.1f} s")
    # kernels against plain versions at batch 2 on the initial weights
    x2, y2 = x[2:4], y[2:4]            # rows of 900 and 1024 real labels
    loss_k, gk = _xent_grads(step, xent_loss, x2, y2)
    loss_p, gp = _xent_grads(step, xent_loss_plain, x2, y2)
    worst = (0.0, "")
    plain = state.space.unpack(gp, "buffer")
    for name, a in state.space.unpack(gk, "buffer").items():
        e = plain[name]
        rel = float((a - e).norm() / e.norm().clamp_min(1e-30))
        worst = max(worst, (rel, name))
    del gk, gp, plain
    print(f"  batch 2, kernels vs plain: loss {loss_k:.5f} vs {loss_p:.5f} "
          f"(tol {TRAIN_LOSS_TOL}); worst gradient relative L2 error "
          f"{worst[0]:.3e} in {worst[1]} (tol {TRAIN_GRAD_REL_TOL})")
    check(abs(loss_k - loss_p) <= TRAIN_LOSS_TOL,
          "xentropy training loss: kernel path disagrees with the plain path")
    check(worst[0] <= TRAIN_GRAD_REL_TOL,
          "xentropy gradients: kernel path disagrees with the plain path")

    state, losses, times, launches = _train_loop(step, state, (x, y),
                                                 TRAIN_STEPS)
    out = _run_summary("xentropy", losses, times, launches,
                       torch.cuda.max_memory_allocated(), card, cfg)
    check(losses[-1] < losses[0], "the xentropy training loss did not fall")
    _check_launches("xentropy", launches,
                    {xentropy.FWD_KERNEL: 1, xentropy.BWD_KERNEL: 1,
                     mt_ops.ADAM_KERNEL: 1}, TRAIN_STEPS)
    (state, _), out["profile"] = _profiled(
        lambda: step(state, x, y), "xentropy step",
        {"xentropy": ("xentropy",), "optimizer": ("adam_kernel",)})
    out.update(real_labels=real, batch2_loss=[loss_k, loss_p],
               batch2_grad_rel_err={"max": worst[0], "param": worst[1]})
    return out


def rope_path(seed: int, dev, card: str) -> dict:
    """RoPE as a model applies it: q and k through
    ``fused_apply_rotary_pos_emb`` at Llama-2-7B's sbhd shape, through
    ``_thd`` with eight packed sequences, and through ``_cached`` at
    GPT-NeoX-20B's, each with a backward through both (two forward and
    two backward launches a variant); launch counts set to 0 just before
    and read just after. Outputs and gradients bitwise against the plain
    version on the same tables."""
    cgen = torch.Generator(device=dev).manual_seed(seed + 16)
    rnd = lambda shape: torch.randn(  # noqa: E731
        shape, generator=cgen, device=dev).to(torch.bfloat16)
    f_llama = rope_freqs(LLAMA_SBHD[0], LLAMA_SBHD[3], dev)
    f_thd = rope_freqs(max(THD_LENS), THD_HEADS[1], dev)
    f_neox = rope_freqs(NEOX_SBHD[0], NEOX_ROT, dev)
    cu = _thd_cu(dev)
    thd = (sum(THD_LENS), *THD_HEADS)
    pos = rope._thd_positions(cu, thd[0], f_thd.shape[0])
    variants = {
        # name: (shape, apply, the plain version's cos and sin)
        "sbhd": (LLAMA_SBHD, lambda t: fused_apply_rotary_pos_emb(t, f_llama),
                 torch.cos(f_llama), torch.sin(f_llama)),
        "thd": (thd, lambda t: fused_apply_rotary_pos_emb_thd(t, cu, f_thd),
                torch.cos(f_thd[:, 0, 0])[pos][:, None],
                torch.sin(f_thd[:, 0, 0])[pos][:, None]),
        "cached": (NEOX_SBHD, lambda t: fused_apply_rotary_pos_emb_cached(
            t, torch.cos(f_neox), torch.sin(f_neox)),
            torch.cos(f_neox), torch.sin(f_neox)),
    }
    inputs = {k: [rnd(v[0]).requires_grad_() for _ in range(2)] + [
        rnd(v[0]) for _ in range(2)] for k, v in variants.items()}
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    outs, times = {}, {}
    for name, (_, apply, _, _) in variants.items():
        q, k, gq, gk = inputs[name]
        t0 = time.perf_counter()
        qr, kr = apply(q), apply(k)
        torch.autograd.backward([qr, kr], [gq, gk])
        torch.cuda.synchronize()
        times[name] = (time.perf_counter() - t0) * 1e3
        outs[name] = (qr.detach(), kr.detach())
    launches = _build.launch_counts()
    ok = {}
    for name, (_, _, c, s) in variants.items():
        q, k, gq, gk = inputs[name]
        qr, kr = outs[name]
        ok[name] = (_same_bits(qr, rope._apply_torch(q.detach(), c, s))
                    and _same_bits(kr, rope._apply_torch(k.detach(), c, s))
                    and _same_bits(q.grad, rope._apply_torch(gq, c, -s))
                    and _same_bits(k.grad, rope._apply_torch(gk, c, -s)))
    print(f"  RoPE path (q and k, forward and backward): launches "
          f"{launches}; wall ms (first call each, synchronised) "
          + ", ".join(f"{k} {v:.2f}" for k, v in times.items())
          + f"; bitwise against plain {ok} on {card}")
    check(launches.get(rope.KERNEL, 0) == 4 * len(variants),
          f"rope launched {launches.get(rope.KERNEL, 0)} times, not "
          f"{4 * len(variants)}")
    check(all(ok.values()), "RoPE path: outputs or gradients differ from "
          "the plain version")
    return {"launches": launches, "steps": 1, "wall_ms": times,
            "bitwise": ok}


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

    walls = {}

    def phase(label, fn):
        print(label)
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.empty_cache()
        walls[label] = time.perf_counter() - t0
        print(f"  ({label}: {walls[label]:.1f} s wall)")
        return result

    def environment():
        card = card_line()
        print(card)
        print(f"  torch {torch.__version__} cuda {torch.version.cuda} device "
              f"{torch.cuda.get_device_name(0)} "
              f"x{torch.cuda.device_count()}")
        secs = _build.build_all()
        print(f"  built {', '.join(_build.SOURCES)} in {secs:.1f} s")
        for src in _build.SOURCES:
            for line in _build.build_log(src).splitlines():
                if "registers" in line or "spill" in line:
                    print(f"    {src}: {line.strip()}")
        return card, secs

    def kernel_cases():
        gen = torch.Generator().manual_seed(args.seed)
        with torch.no_grad():
            # the serving path's rows (prefill of 8 x 512), then the
            # training path's (8 x 1024); the headline is the serving one's
            ln = layer_norm_case(gen, dev, 8 * 512)
            ln["cases"] = [layer_norm_case(gen, dev, TRAIN_BATCH * 1024)]
            rows = [ln, flash_cases(gen, dev), layer_norm_bwd_case(gen, dev),
                    *flash_bwd_cases(gen, dev), adam_case(dev)]
            torch.cuda.empty_cache()
            rows += sumsq_cases(dev)
            torch.cuda.empty_cache()
            rows += lamb_stage_cases(dev)
            torch.cuda.empty_cache()
            rows.append(segment_cases(dev))
            torch.cuda.empty_cache()
            rows += softmax_cases(gen, dev)
            torch.cuda.empty_cache()
            space = resnet_space()
            rows += [sgd_case(dev, space), lars_case(dev, space)]
            torch.cuda.empty_cache()
            for case in (scale_case, axpby_case, adagrad_case,
                         novograd_case):
                rows.append(case(dev))
                torch.cuda.empty_cache()
            rows += xentropy_cases(dev)
            torch.cuda.empty_cache()
            rows.append(rope_cases(dev))
            torch.cuda.empty_cache()
        return rows

    card, secs = phase("phase 1: environment", environment)
    kernels = phase("phase 2: kernels against their plain versions",
                    kernel_cases)
    srv = phase("phase 3: serving GPT-2 345M",
                lambda: serve(args.seed, dev, card))
    trn = phase("phase 4: training GPT-2 345M",
                lambda: train(args.seed, dev, card))
    lamb = phase("phase 5: training GPT-2 345M with FusedLAMB",
                 lambda: train_lamb(args.seed, dev, card))
    bert = phase("phase 6: BERT-Large pretraining with FusedLAMB (NVLAMB)",
                 lambda: train_bert(args.seed, dev, card))
    gsm = phase("phase 7: GPT-2 345M on the softmax attention backend",
                lambda: train_gpt_softmax(args.seed, dev, card))
    rn = phase("phase 8: ResNet-50 ImageNet training (FusedSGD, amp O2, "
               "FusedLARS, LARC)", lambda: train_resnet(args.seed, dev, card))
    novo = phase("phase 9a: training GPT-2 345M with FusedNovoGrad and the "
                 "clip", lambda: train_novograd(args.seed, dev, card))
    ada = phase("phase 9b: training GPT-2 345M with FusedAdagrad under the "
                "loss scaler", lambda: train_adagrad(args.seed, dev, card))
    xent = phase("phase 10a: training GPT-2 345M with contrib xentropy "
                 "(label smoothing, padded labels)",
                 lambda: train_xentropy(args.seed, dev, card))
    print(f"  xentropy step {xent['step_ms']:.2f} ms against phase 4's "
          f"gpt_loss_fn step {trn['step_ms']:.2f} ms in this call (for "
          "comparison only)")
    rp = phase("phase 10b: RoPE at Llama-2-7B and GPT-NeoX-20B widths",
               lambda: rope_path(args.seed, dev, card))
    # where each kernel's launches are read: the path that runs it (the
    # forward kernels run on every GPT path: their launches are the
    # serving run's; the scaled sum of squares runs on the scaler step;
    # the mask-free softmax on the dispatcher's own run, as no model
    # path calls it)
    paths = {
        layer_norm.KERNEL: ("serving", srv["launches"], srv["steps"]),
        attention.KERNEL: ("serving", srv["launches"], srv["steps"]),
        engine.SUMSQ_SCALED_KERNEL: ("training_lamb_scaler_step",
                                     lamb["scaler_launches"], 1),
        softmax.SCALED_KERNEL: ("dispatcher_mask_none",
                                bert["dispatcher_launches"], 1),
        softmax.CAUSAL_KERNEL: ("training_gpt_softmax", gsm["launches"],
                                gsm["steps"]),
        softmax.MASKED_KERNEL: ("training_bert_softmax",
                                bert["softmax"]["launches"],
                                bert["softmax"]["steps"]),
        softmax.BWD_KERNEL: ("training_bert_softmax",
                             bert["softmax"]["launches"],
                             bert["softmax"]["steps"]),
        mt_ops.SGD_KERNEL: ("training_resnet_sgd",
                            rn["sgd_bf16"]["launches"],
                            rn["sgd_bf16"]["steps"]),
        mt_ops.LARS_KERNEL: ("training_resnet_lars", rn["lars"]["launches"],
                             rn["lars"]["steps"]),
        mt_ops.SCALE_KERNEL: ("training_novograd", novo["launches"],
                              novo["steps"]),
        mt_ops.NOVOGRAD_KERNEL: ("training_novograd", novo["launches"],
                                 novo["steps"]),
        mt_ops.ADAGRAD_KERNEL: ("training_adagrad", ada["launches"],
                                ada["steps"]),
        mt_ops.AXPBY_KERNEL: ("grad_accumulation_axpby",
                              ada["axpby_launches"], 1),
        xentropy.FWD_KERNEL: ("training_xentropy", xent["launches"],
                              xent["steps"]),
        xentropy.BWD_KERNEL: ("training_xentropy", xent["launches"],
                              xent["steps"]),
        rope.KERNEL: ("rope_path", rp["launches"], rp["steps"]),
    }
    for k in kernels:
        name = k["name"]
        if name in paths:
            path, launches, steps = paths[name]
        elif name in (layer_norm.BWD_KERNEL, attention.BWD_DQ_KERNEL,
                      attention.BWD_DKV_KERNEL, mt_ops.ADAM_KERNEL):
            path, launches, steps = "training", trn["launches"], trn["steps"]
        else:
            path, launches, steps = ("training_lamb", lamb["launches"],
                                     lamb["steps"])
        k["path"] = path
        k["launches"] = launches.get(name, 0)
        k["launches_per_step"] = k["launches"] / max(steps, 1)
        for key, run in (("training", trn), ("training_lamb", lamb),
                         ("bert_softmax", bert["softmax"]),
                         ("bert_flash", bert["flash"]),
                         ("gpt_softmax", gsm),
                         ("resnet_sgd", rn["sgd_bf16"]),
                         ("resnet_o2", rn["o2_fp16"]),
                         ("resnet_lars", rn["lars"]),
                         ("resnet_larc", rn["larc"]),
                         ("novograd", novo), ("adagrad", ada),
                         ("xentropy", xent)):
            k[f"launches_{key}"] = run["launches"].get(name, 0)
        check(k["launches"] > 0, f"{name}: no launch on its path")

    check(len(kernels) == 24, f"{len(kernels)} kernels in the line, not 24")
    print("phase 11: kernels")
    print("  phase wall seconds: " + ", ".join(
        f"{label.split(':')[0]} {t:.1f}" for label, t in walls.items()))
    line = {"kernels": kernels}
    print(json.dumps(line))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "build_s": secs, "phase_wall_s": walls,
                       "serving": srv, "training": trn,
                       "training_lamb": lamb, "bert": bert,
                       "gpt_softmax": gsm, "resnet": rn,
                       "training_novograd": novo, "training_adagrad": ada,
                       "training_xentropy": xent, "rope_path": rp,
                       **line}, f,
                      indent=1)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
