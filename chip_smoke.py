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
   serving shapes (the flash forward, on wgmma and TMA, also run a
   second time on the same inputs, output and lse bitwise equal);
   the LayerNorm backward, the flash dq and dk/dv and
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
11. Dropout and sampled decoding: (a) the flash forward, dq and dk/dv
   kernels with dropout 0.1 against the plain forward and backward with
   the same mask, at GPT-2 345M's training shape (b 8, h 16, s 1024, d
   64, causal) and BERT-Large's (b 8, h 16, s 512, d 64, the keep-mask of
   phase 6's lengths as segment ids), within the flash tolerances; pad
   queries and keys put in segments of their own give rows of exactly 0
   (out, dq, dk, dv; lse NEG_INF); the forward kernel's mask, read off
   its output (q = 0, V the identity over 64 keys), bitwise the plain
   mask over 8.4 M pairs, its kept share within 0.001 of 0.9. Then
   ``dropout.cu`` at (1024, 8, 1024) and (8, 16, 512, 512) bf16, output
   and gradient bitwise. Times by CUDA-graph replay beside their
   bounds; library yardsticks SDPA with ``dropout_p`` and
   ``F.dropout`` (another generator: comparison only). (b) GPT-2 345M
   with attention and hidden dropout 0.1 (Megatron's defaults), phase
   4's model, weights and batch, FusedAdam, ten steps each with its own
   key: the launch counts set to 0 just before and read just after (24
   flash forwards, 24 dq, 24 dk/dv, 48 dropout forwards and 48 backwards
   a step), losses finite and falling, the step time beside phase 4's;
   at batch 2 on one key the loss and gradients through the kernels
   against the plain versions (phase 4's tolerances). (c) BERT-Large
   with both dropouts 0.1 (Google's ``bert_config.json``) and NVLAMB,
   ten steps on each backend (flash: the kernel drops; softmax: the
   probabilities through ``dropout.cu``, 72 dropout launches a step),
   batch 2 against the plain path (the loss within BERT_DROPOUT_LOSS_TOL,
   the gradients within phase 6's 10%), and in both (b) and (c) the
   dropout kernel alone (every other op plain) bitwise the plain path,
   loss and gradients. (d) Phase 3's
   eight requests with lanes 1, 3, 5 and 7 sampled at temperature 0.8,
   top-k 50, top-p 0.95 and their own seeds: the greedy lanes give phase
   3's tokens, a second run replays every stream token for token, the
   sampler on the host draws the card's token from the card's logits at
   every dispatch; TPOT and tokens/s beside phase 3's.
12. Master-free bf16 training with stochastic rounding (SR): (a) each
   SR kernel against its plain version on the card: the SR cast
   (``csrc/stochastic_round.cu``) at GPT-2 345M's buffer, bitwise, an
   eighth of 2^24 copies of 1 + 2^-10 rounded up (within 0.1%), a
   fixed seed replayed bitwise; the Adam, Adagrad and NovoGrad SR
   kernels and LAMB's stage 1 over a bf16 p and stage 2 with SR (over
   the whole buffer and over the large leaves' segments, a key per
   leaf) at GPT-2 345M's buffers, SGD and LARS (and LARS's ||p|| over a
   bf16 p) at ResNet-50's: p' and the slots bitwise, an inf setting
   found_inf with the state left as it was; the segment pass with SR
   over BERT-Large's segmented layout, p stash on and off, u fp32 and
   bf16: m', v' bitwise, p' within one bf16 ulp. Each beside the same
   kernel over an fp32 master, its plain version and its bound. (b)
   BERT-Large (bf16 parameters) with phase 6's FusedLAMB (NVLAMB) over a
   bf16 master with SR, ten steps on phase 6's batch beside phase 6's
   step in this call: exact launches a step of the SR segment and stage
   kernels, losses finite and falling, step time, tokens/s, peak
   memory, one profiled step; batch 2 against the plain path (phase 6's
   tolerances) and one update on the real gradient (m', v' bitwise, p'
   within one ulp). (c) GPT-2 345M with phase 4's FusedAdam over a bf16
   master, ten steps beside phase 4's, batch 2 and one update (bitwise)
   against the plain versions, then a step under the loss scaler with an
   inf: skipped bitwise, the count not advanced, the next step's p' the
   one the skipped step would have written.
13. The flash kernels' bias, global positions and lse cotangent. (a)
   Forward, dq and dk/dv against their plain versions: a bias of each
   broadcast class ((1, 1, sq, sk), (b, 1, 1, sk), (b, h, sq, sk)) in
   fp32 and bf16 at the multi-head attention stack's shape (120 x 16
   heads x 64 x 64), a key-padding bias with dropout 0.1 (the keep mask
   read off an output, bitwise the plain mask), zig-zag positions and the
   lse cotangent at a chunk's shape (16 heads, 2048 x 2048 of 8192
   tokens), the lse cotangent alone, and dbias by recompute (PyTorch)
   against autograd through the plain forward; SDPA with a float
   ``attn_mask`` as the library yardstick. (b) The reference's
   multi-head attention perf test at its defaults: three 18-layer stacks
   (self attention with a bool future mask, self attention and
   encoder-decoder attention with an additive key-padding mask of real
   lengths 32-64), 120 x 64 tokens, hidden 1024, 16 heads, dropout 0.1,
   biases and norm-add, bf16: forward + backward ms per layer with
   ``impl="fast"`` (the flash kernels) against ``"default"`` (the plain
   attention), exactly 18 launches a pass of each flash and LayerNorm
   kernel, and at 8 sequences the output and every gradient within
   MHA_OUT_REL_TOL / MHA_GRAD_REL_TOL of the plain path. (c) Causal
   attention over 8192 tokens (b 1, 16 heads, d 64, bf16) in 4 zig-zag
   shards on one card, the ring's serial schedule (``_chunk_attn`` in 2 x
   2 sub-tiles, ``_merge``, then ``_chunk_grads`` against the global lse
   and delta, one launch of each kernel per live sub-tile), and the same
   combine differentiated by autograd through out and lse: the forward
   and dq, dk, dv against the unchunked kernel within ZZ_OUT_REL_TOL and
   ZZ_GRAD_REL_TOL, the kernel tiles the position bounds skipped, and the
   time against the unchunked call.
14. The fp32 and fp16 kernels, any head width, strided RoPE tables,
   fixed-order leaf sums and the probes. (a) The flash forward, dq and
   dk/dv kernels in fp32 and fp16 against their plain versions at GPT-2
   345M's training shape (b 8, h 16, s 1024, d 64, causal), the serving
   prefill and decode shapes, once with a key-padding bias at the
   multi-head attention shape, once with the positions of a past 1024-token
   zig-zag sub-tile and once with dropout 0.1 (FLASH32_REL_TOL and
   FLASH16_REL_TOL); head_dim 96 in bf16; LayerNorm forward and backward
   in fp16 at (8192, 1024); the four softmax kernels in fp16 at rows
   10-13's shapes; RoPE at Llama-2-7B's sbhd with a table per batch row
   (bitwise); the leaf-sum kernel at GPT-2 345M's 292 leaves (bitwise, two
   runs bitwise). Each with its device ms, bound, plain ms and the library
   call at the same dtype. (b) GPT-2 345M at the example's dtype, fp32
   (flash, FusedAdam, 8 x 1024, FP32_STEPS steps; ``allow_tf32`` False,
   PyTorch's default): every fp32 flash kernel and the backward's split
   pass exactly 24 times a step, losses finite and falling, step time,
   tokens/s, peak memory, a profiled step and the backward's share of it;
   batch 2 against the plain path. (c) GPT-2 345M at
   ``dtype=float16`` under the dynamic loss scaler, FP16_STEPS steps on
   each attention backend (the fp16 flash kernels, or the fp16 causal
   softmax and its backward, 24 a step; LayerNorm fp16 49), the scale and
   the skipped steps, batch 2 against the plain path; and
   ``FusedScaleMaskSoftmax`` in fp16 with a mask and without (the masked
   and scaled forwards, which no fp16 model path calls). (d) Phase 13b's
   three multi-head attention stacks at their fp32 default and at fp16,
   ``impl="fast"`` against ``"default"``, exact launches. (e) The kprobe
   ladder at 64 M fp32 (``apex_tpu_torch/tools/kprobe.py``: every kernel
   rung bitwise its plain version, the found flag 0 and then 1 on an
   injected inf, each rung's GB/s against 3.35 TB/s) and the launch probe
   (``apex_tpu_torch/tools/launch_probe.py``: every case inside sm_90's
   limits PASSes, every case outside FAILs). (f) The bf16 and fp16 flash
   forward and backward (``csrc/flash_fwd_sm90.cuh``,
   ``csrc/flash_bwd_sm90.cuh``: wgmma, TMA) at the training shape (h 16, s
   1024, causal) in bf16 and fp16, bf16 with dropout 0.1, the serving
   decode (b 8, sq 1, sk 1025, the context's segment ids) and prefill (b 4,
   s 512), the multi-head attention shape with its key-padding bias, and
   head_dim 96, 128, 256 and 60 (padded to 64 for TMA, the padding's own
   device time beside it) in both; and the fp32 backward
   (``csrc/flash_bwd32_sm90.cuh``: wgmma, TMA, exact three-part products)
   at the training shape with and without dropout, the MHA shape, prefill,
   decode and head_dim 32, 60, 96 and 128, its split pass timed apart and
   held bitwise against its plain version at the training shape: each
   against its plain versions, each kernel's device ms beside its bound
   (fp32 at 989 / 6 TFLOP/s) and SDPA's forward and backward by device
   time (fp32 with TF32 off). Every flash check on the way (phases 2,
   11a, 13a, 14a and f) also runs the kernels a second time on the same
   inputs and holds the two results bitwise equal, and SDPA's backward,
   the library yardstick of dq and dk/dv, is timed as device time (its
   forward and backward captured in a CUDA graph, less the forward
   alone) with its host reading beside it.
15. Each phase's wall seconds, the ``kernels`` JSON line (all fifty-seven
   kernels and variants, each with its launches on its path), then the
   device line the caller reads.

Needs a CUDA device and ``nvcc`` (``$CUDA_HOME`` or
``/usr/local/cuda``); exits 1 without printing a result otherwise.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from apex_tpu_torch import _build, amp
from apex_tpu_torch import random as jrandom
from apex_tpu_torch.contrib.clip_grad import clip_grad_norm_
from apex_tpu_torch.contrib.multihead_attn import (
    EncdecMultiheadAttn,
    SelfMultiheadAttn,
)
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
from apex_tpu_torch.multi_tensor import engine, segmented
from apex_tpu_torch.multi_tensor import ops as mt_ops
from apex_tpu_torch.multi_tensor.segmented import SEGMENT_KERNEL
from apex_tpu_torch.models.gpt import KERNEL_OPS, PLAIN_OPS
from apex_tpu_torch.contrib.xentropy import softmax_cross_entropy
from apex_tpu_torch.ops import attention, layer_norm, rope, softmax, xentropy
from apex_tpu_torch.ops import dropout as dropout_op
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
from apex_tpu_torch.transformer import context_parallel
from apex_tpu_torch.tools import kprobe, launch_probe
from apex_tpu_torch.serving import (
    ContinuousBatcher,
    DecodeStep,
    KVCache,
    Request,
    select_token,
    serve_loop,
)

# NVIDIA H100 SXM data sheet, dense, at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_TENSOR_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
# an exact fp32 product on the tensor cores: six bf16 products (three
# bf16 parts a value, the pairs whose parts reach 2^-16 of the leading
# one), so the card's least time for an fp32 flash kernel's operations is
# at 989 / 6 TFLOP/s, whatever the design (the fp32 FMA rate, 67 TFLOP/s,
# is a design's choice, not the card's floor)
PEAK_FP32_EXACT_FLOPS = PEAK_BF16_TENSOR_FLOPS / 6

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
# sums of the subtile partials are taken in one fixed order on both sides
# (the leaf_sum kernel and its plain version, bitwise; before, atomics
# added the embedding's 25,152 partials in any order and an H100 read
# 3.2e-6 relative on v'); the partials themselves are fp32 sums of 2,048
# squares in another order (~1e-7 relative). v' within this share of
# itself, m' within this share of its terms (|b1 m| + |m'| + |wd p|) plus
# one ulp, p' within lr / bc1 times that plus one ulp of the larger of |p|
# and |p'|
NOVOGRAD_TOL = 1e-6

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


# the integer kernels' (dropout, the SR kernels') least time: threefry's
# hash is integer work, bounded by what the card's pipes can run of it, at
# the card's maximum SM clock (`nvidia-smi --query-gpu=clocks.max.sm`) over
# 132 SMs. Instructions an element of each kernel's main loop (nvcc 12.8,
# sm_90a; four elements a thread a pass), counted from its SASS by
# `python apex_tpu_torch/tools/sass_count.py dropout --kernel
# dropout_kernel --elements 4` (and `stochastic_round --kernel
# sr_cast_kernel`), by class: "alu" only the ALU pipe runs (LOP3, SHF,
# the compares, PRMT), "add" the ALU or the FMA pipe runs (integer adds
# and moves: IADD3, LEA, MOV and IMAD.IADD, IMAD.MOV), "imad" only the
# FMA pipe (multiplies), "fp32" FFMA/FADD/FMUL, "all" every instruction
MAX_SM_HZ = 1980e6
SMS = 132
DROPOUT_SASS = {"all": 96.75, "alu": 44.5, "add": 32.5, "imad": 2.0,
                "fp32": 6.0}    # dropout_kernel<bf16>
SR_SASS = {"all": 81.75, "alu": 47.5, "add": 31.0, "imad": 1.25,
           "fp32": 0.0}         # sr_cast_kernel


def int_bound(nbytes_: float, per_element: dict, n: int,
              fp32_ops: float = 0.0):
    """The least time of ``n`` elements of a kernel whose instructions an
    element are ``per_element`` (DROPOUT_SASS, SR_SASS), plus ``fp32_ops``
    fp32 operations in all (one issue slot each), moving ``nbytes_``: the
    largest of the bytes over 3.35 TB/s and, a clock an SM, the ALU-only
    instructions over the ALU pipe's 64 lanes, all integer instructions
    over the 128 lanes of the ALU and FMA pipes together, the multiplies
    over the FMA pipe's 64 integer lanes, the fp32 operations over its 128
    and all instructions over the 4 x 32 issue slots. Returns (ms, "bytes"
    or "operations", the bytes or the limit that bounds it)."""
    pe = per_element
    fp32 = pe["fp32"] + fp32_ops / max(n, 1)
    clocks = {"alu": pe["alu"] / 64,
              "integer": (pe["alu"] + pe["add"] + pe["imad"]) / 128,
              "imad": pe["imad"] / 64, "fp32": fp32 / 128,
              "issue": (pe["all"] + fp32 - pe["fp32"]) / 128}
    limit, per_element_clocks = max(clocks.items(), key=lambda kv: kv[1])
    t_ops = n * per_element_clocks / (SMS * MAX_SM_HZ) * 1e3
    t_bytes = nbytes_ / PEAK_BYTES_PER_S * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes", "bytes"
    return t_ops, "operations", limit


# a cold reading: the calls of the graph rotate over copies of the inputs
# until the first input alone passes this many bytes (four of the card's
# 50 MB L2), so that no call finds its inputs in L2
COLD_BYTES = 200e6


def cold_ms(fn, *ins) -> float:
    """Device ms of ``fn(*ins)`` with cold inputs: ``device_ms`` over calls
    that rotate over copies of ``ins``."""
    copies = max(2, -(-int(COLD_BYTES) // nbytes(ins[0])))
    sets = [tuple(t.clone() for t in ins) for _ in range(copies)]
    turn = [0]

    def call():
        turn[0] += 1
        return fn(*sets[turn[0] % copies])
    ms = device_ms(call, iters=2 * copies)
    del sets
    torch.cuda.empty_cache()
    return ms


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


# a profiled GPT step's LayerNorm kernels (forward, backward and the
# backward's sum of dw and db) and PyTorch's reductions, apart
LN_PROFILE_SHARES = {"layer_norm": ("ln_",),
                     "reductions": ("reduce_kernel",)}


def _ln_profile(prof: dict, label: str) -> None:
    """Adds to ``prof`` (``_profiled``'s) the launches of each LayerNorm
    kernel and of PyTorch's reductions, and prints them: no reduction
    follows the backward for dw and db."""
    ln = {}
    for m in prof["matched"]:
        if m["share"] == "layer_norm":
            kname = m["name"][m["name"].index("ln_"):].split("<")[0]
            kname = kname.split("(")[0]
            ln[kname] = ln.get(kname, 0) + m["count"]
    prof["layer_norm_launches"] = ln
    prof["reduction_launches"] = sum(m["count"] for m in prof["matched"]
                                     if m["share"] == "reductions")
    if prof["device_busy_ms"] > 0:
        print(f"  LayerNorm in {label}: {prof['layer_norm_ms']:.3f} ms; "
              f"launches {ln}; PyTorch reductions "
              f"{prof['reduction_launches']} launches, "
              f"{prof['reductions_ms']:.3f} ms")


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
    check_repeat(f"layer_norm_fwd rows={rows}", kernel, (y, mean, rstd))
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
    check_repeat(f"flash_fwd[{name}]", lambda: attention.flash_attention(
        q, k, v, return_lse=True, **kw), (out, lse))
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


def layer_norm_bwd_case(gen: torch.Generator, dev, rows: int,
                        dtype=torch.bfloat16) -> dict:
    """#3 at (rows, 1024) in ``dtype`` against its plain version (dx as
    the forward's output, dw and db within LN_PARAM_TOL), a repeated call
    bitwise; device (graph replay and cold), host, plain and
    ``native_layer_norm_backward`` ms and the bound. The kernel's time
    includes its second kernel, which sums dw and db."""
    h = 1024
    x = torch.randn(rows, h, generator=gen).mul_(2).add_(0.5).to(dev, dtype)
    g = torch.randn(rows, h, generator=gen).to(dev, dtype)
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
    dt = str(dtype)[6:]
    print(f"  layer_norm_bwd rows={rows} h={h} {dt}: max_abs_err={err:.3e} "
          f"max(|diff| - 2^-7|dx|)={excess:.3e} (tol {LN_ABS_TOL}) "
          f"dw/db rel_err={p_err:.3e} (tol {LN_PARAM_TOL})")
    check(excess <= LN_ABS_TOL and p_err <= LN_PARAM_TOL,
          "layer_norm_bwd kernel disagrees with its plain version")

    def kernel(x_=x, g_=g, m_=mean, r_=rstd):
        return layer_norm._bwd_cuda(x_, w, m_, r_, g_, False)
    check_repeat(f"layer_norm_bwd rows={rows} {dt}", kernel, (dx, dw, db))
    ms, h_ms = device_ms(kernel), host_ms(kernel)
    c_ms = cold_ms(kernel, x, g, mean, rstd)
    plain_ms = device_ms(
        lambda: layer_norm._bwd_torch(x, w, mean, rstd, g, False), iters=5)
    # the library's LayerNorm backward on weights in x's dtype, from its
    # own forward's statistics
    wl, bl = w.to(x.dtype), b.to(x.dtype)
    _, lmean, lrstd = torch.native_layer_norm(x, (h,), wl, bl, 1e-5)
    lib_ms = device_ms(lambda: torch.ops.aten.native_layer_norm_backward(
        g, x, (h,), lmean, lrstd, wl, bl, [True, True, True]))
    # per element: x-hat, w*g, two row sums, dw/db sums, dx
    b_ms, by = bound(nbytes(x, g, w, mean, rstd, dx, dw, db), 13 * rows * h,
                     PEAK_FP32_FLOPS)
    print(f"    ms={ms:.5f} cold_ms={c_ms:.5f} host_ms={h_ms:.5f} "
          f"plain_ms={plain_ms:.5f} library_ms={lib_ms:.5f} "
          f"bound_ms={b_ms:.5f} ({by})")
    return {"max_abs_err": err, "ms": ms, "cold_ms": c_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": lib_ms, "host_ms": h_ms,
            "shape": f"rows={rows} h={h} {dt} x, fp32 w"}


def layer_norm_bwd_cases(gen: torch.Generator, dev) -> dict:
    """#3 at GPT-2 345M's training rows in bf16 (the headline) and fp32
    (the example's own dtype), and at BERT-Large's 8 x 512 rows in bf16."""
    cases = [layer_norm_bwd_case(gen, dev, TRAIN_BATCH * 1024),
             layer_norm_bwd_case(gen, dev, 8 * 512),
             layer_norm_bwd_case(gen, dev, TRAIN_BATCH * 1024,
                                 torch.float32)]
    return {"name": layer_norm.BWD_KERNEL, "route": "cuda",
            "source": "apex_tpu_torch/csrc/layer_norm.cu",
            "replaces": "apex_tpu/ops/layer_norm.py:67", **cases[0],
            "max_abs_err": cases[0]["max_abs_err"], "cases": cases}


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
    check_repeat(f"flash_bwd[{name}]", lambda: attention._flash_bwd_cuda(
        *args), got)
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
    sdpa_kw = (dict(is_causal=True, enable_gqa=hk != h) if sq == sk else
               dict(enable_gqa=hk != h, attn_mask=_allowed(
                   b, sq, sk, True, None, dev)[:, None]))
    lib_ms, lib_host = sdpa_bwd_ms(f"SDPA backward {name}", q, k, v, do,
                                   **sdpa_kw)
    print(f"    SDPA backward: device ms (CUDA graph) {_ms(lib_ms)}, host ms "
          f"(CUDA events, back-to-back calls) {_ms(lib_host)}")
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
              f"{plain_ms:.5f} SDPA backward library_ms={_ms(lib_ms)}")
        rows.append({"case": name, "ms": ms, "host_ms": h_ms,
                     "bound_ms": b_ms, "bound_by": by, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "library_host_ms": lib_host,
                     "errors": errs,
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
            for plain in (False, True, False)]
    torch.cuda.synchronize()
    excess = novograd_excess(p, m, *outs[:2], lr_bc1=NOVOGRAD_LR, b1=b1,
                             wd=NOVOGRAD_WD)
    err = max(float((a - b).abs().max()) for a, b in zip(*outs[:2]))
    # the per-leaf sums in their fixed order: two runs give the same bits
    replay = _bitwise(outs[0][:3], outs[2][:3])
    sums = mt_ops.per_tensor_l2norm(g, space)
    sums_plain = mt_ops.per_tensor_l2norm(g, space, plain=True)
    leaf_bits = _bitwise([engine.leaf_sums(
        engine.fused_sumsq_partials(g, engine.PER_TENSOR_TILE_ROWS),
        space)], [engine.leaf_sums(engine.fused_sumsq_partials(
            g, engine.PER_TENSOR_TILE_ROWS), space, plain=True)])
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
          f"{excess['p']:.3e} (<= 0 passes); two runs bitwise {replay}; "
          f"per-leaf sums kernel vs plain bitwise {leaf_bits} (norms "
          f"max rel {float(((sums - sums_plain) / sums_plain).abs().max()):.3e}"
          f"); found_inf={found} state_untouched={untouched}")
    check(replay and leaf_bits, "the NovoGrad per-leaf sums are not in a "
          "fixed order")
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
            "excess": excess, "bitwise": flags, "replay_bitwise": replay,
            "leaf_sums_bitwise": leaf_bits,
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


def sdpa_bwd_ms(name, q, k, v, do, **sdpa_kw):
    """SDPA's backward (``torch.autograd.grad`` of
    ``F.scaled_dot_product_attention(q, k, v, **sdpa_kw)``) as device time
    and as host time: ``(device_ms, host_ms)``. Device time as the kernels'
    is taken, by CUDA graph replay: the forward and the backward captured
    together, less the forward alone (the backward alone cannot be
    captured: autograd launches it on the stream its forward ran on). Host
    time by CUDA events over back-to-back backward calls."""
    ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))

    def forward():
        with torch.enable_grad():
            return F.scaled_dot_product_attention(ql, kl, vl, **sdpa_kw)

    def forward_backward():
        return torch.autograd.grad(forward(), (ql, kl, vl), do)

    dev_ms = device_ms(forward_backward, iters=10) - device_ms(forward,
                                                                iters=10)
    lo = forward()
    host = _library_ms(name, lambda: torch.autograd.grad(
        lo, (ql, kl, vl), do, retain_graph=True))
    del lo
    torch.cuda.empty_cache()     # the graphs' private pools
    return dev_ms, host


def _ms(x) -> str:
    return "not measured" if x is None else f"{x:.5f}"


def check_repeat(name, fn, got) -> None:
    """The flash and LayerNorm kernels write each output element once,
    with no atomics: a second call on the same inputs must be bitwise
    equal (the forward's output and lse or statistics, the backward's
    gradients)."""
    again = fn()
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)
              if a is not None),
          f"{name}: a repeated call is not bitwise equal")


def softmax_fwd_case(name, x, mask, mode, lib, bound_bytes) -> dict:
    """One forward kernel of ``csrc/softmax.cu`` against its plain version
    on the same inputs: within one ulp of x's dtype elementwise (bf16
    SOFTMAX_FWD_TOL, fp16 FP16_ULP)."""
    fp16 = x.dtype == torch.float16
    tol = FP16_ULP if fp16 else SOFTMAX_FWD_TOL
    # fp16's subnormals (below 2^-14) are 2^-24 apart: one of them is an
    # ulp there, however small the value
    floor = FP16_SUBNORMAL_ULP if fp16 else 0.0
    y = softmax._fwd_cuda(x, mask, 1.0, mode)
    want = softmax._fwd_torch(x, mask, 1.0, mode)
    torch.cuda.synchronize()
    err = float((y.float() - want.float()).abs().max())
    excess = _ulp_excess(y, want, tol)
    check(bool(torch.isfinite(y).all()), f"{name}: non-finite output")
    print(f"  {name} {tuple(x.shape)} {str(x.dtype)[6:]}: max_abs_err="
          f"{err:.3e} max(|diff| - {tol} max(|y|, |y_plain|))={excess:.3e} "
          f"(tol {floor})")
    check(excess <= floor, f"{name} kernel disagrees with its plain version")
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
            "shape": f"{tuple(x.shape)} {str(x.dtype)[6:]}"
                     + ("" if mask is None else
                        f", mask {tuple(mask.shape)} bool")}


def softmax_bwd_case(name, y, g) -> dict:
    """The shared backward against its plain version, relative to each
    row's largest |dx| (bf16 SOFTMAX_BWD_TOL, fp16 FP16_ROW_TOL)."""
    tol = FP16_ROW_TOL if y.dtype == torch.float16 else SOFTMAX_BWD_TOL
    kname = softmax.kernel_name(softmax.BWD_KERNEL, y.dtype)
    dx = softmax._bwd_cuda(y, g, 1.0)
    want = softmax._bwd_torch(y, g, 1.0)
    torch.cuda.synchronize()
    diff = (dx.float() - want.float()).abs()
    row = want.float().abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    rel = float((diff / row).max())
    err = float(diff.max())
    check(bool(torch.isfinite(dx).all()), f"{name}: non-finite dx")
    print(f"  {kname}[{name}] {tuple(y.shape)}: max_abs_err="
          f"{err:.3e} max |diff| / row max |dx| = {rel:.3e} (tol {tol})")
    check(rel <= tol,
          f"{kname}[{name}] kernel disagrees with its plain version")
    kernel = lambda: softmax._bwd_cuda(y, g, 1.0)  # noqa: E731
    ms, h_ms = device_ms(kernel), host_ms(kernel)
    plain_ms = device_ms(lambda: softmax._bwd_torch(y, g, 1.0), iters=3,
                         replays=2)
    lib_ms = _library_ms(kname, lambda: (
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
            "shape": f"{tuple(y.shape)} {str(y.dtype)[6:]}"}


def softmax_cases(gen, dev, dtype=torch.bfloat16) -> list:
    """#10-#13 at their path shapes: BERT-Large's scores (8, 16, 512, 512)
    with its padded outer-product mask (mask batch 8, and broadcast from
    1) for the masked and the scaled forward, GPT-2 345M's (8 * 16,
    1024, 1024) for the causal one, and the backward at both."""
    rnd = lambda *shape: (3 * torch.randn(*shape, generator=gen)).to(  # noqa
        dev, dtype)
    kn = lambda base: softmax.kernel_name(base, dtype)  # noqa: E731
    x = rnd(*BERT_SCORES)
    mask = bert_extended_attention_mask(bert_keep(dev))   # (b, 1, s, s)
    full = mask.expand(*BERT_SCORES).contiguous()         # for the library
    rows = {}
    masked = [softmax_fwd_case(kn(softmax.MASKED_KERNEL), x, mask, "masked",
                               lambda: torch._masked_softmax(x, full, 3, 2),
                               nbytes(x, x, mask))]
    one = mask[7:8]                          # the 200-token sequence's
    masked.append(softmax_fwd_case(
        kn(softmax.MASKED_KERNEL) + "[mask batch 1]", x, one, "masked",
        lambda: torch._masked_softmax(x, one.expand(*BERT_SCORES), 3, 2),
        nbytes(x, x, one)))
    rows["masked"] = masked
    rows["scaled"] = [softmax_fwd_case(
        kn(softmax.SCALED_KERNEL), x, None, "scaled",
        lambda: torch.softmax(x, -1), nbytes(x, x))]
    y_bert = softmax._fwd_cuda(x, mask, 1.0, "masked")
    g_bert = rnd(*BERT_SCORES).div_(3)
    del x, full
    a, sq, sk = GPT_SCORES
    xc = rnd(*GPT_SCORES)
    live = a * sq * (sq + 1) // 2            # the lower triangle (sq == sk)
    upper = torch.triu(torch.ones(sq, sk, dtype=torch.bool, device=dev), 1)
    rows["causal"] = [softmax_fwd_case(
        kn(softmax.CAUSAL_KERNEL), xc, None, "causal",
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
        out.append({"name": kn(name), "route": "cuda",
                    "source": "apex_tpu_torch/csrc/softmax.cu",
                    "replaces": f"apex_tpu/ops/softmax.py:{line}", **top,
                    "max_abs_err": max(c["max_abs_err"] for c in cases),
                    "cases": cases})
    return out


# -- phase 4: training at full width --------------------------------------------


def _grads(step, model, fwd, x, y, loss_scale=1.0):
    """The loss and the flat gradient of one forward through ``fwd``
    (of the loss times ``loss_scale``, divided by it again)."""
    step._grad.zero_()
    loss = gpt_loss_fn(fwd(x), y)
    (loss.float() * loss_scale).backward()
    torch.cuda.synchronize()
    return float(loss.detach()), step._grad.clone() / loss_scale


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
    for kernel in _flash_names(torch.float32) + (attention.SPLIT_KERNEL,):
        check(launches.get(kernel, 0) == 0,
              f"the bf16 training path launched {kernel}")

    # where the time goes: one more step under the profiler
    (state, _), prof = _profiled(
        lambda: step(state, x, y), "step",
        {"optimizer": OPT_KERNEL_KEYS + ("adam_kernel",),
         "flash_bwd": ("flash_bwd_dq", "flash_bwd_dkv"),
         "flash_fwd": ("flash_fwd",), **LN_PROFILE_SHARES})
    _ln_profile(prof, "the bf16 step")
    if prof["device_busy_ms"] > 0:
        print(f"  the flash forward in the profiled step: "
              f"{prof['flash_fwd_ms']:.3f} ms of {prof['device_busy_ms']:.1f} "
              f"ms of device time "
              f"({100 * prof['flash_fwd_ms'] / prof['device_busy_ms']:.2f}%)")
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

NOVOGRAD_KEYS = ("sumsq_kernel", "scale_kernel", "novograd_kernel",
                 "leaf_sum_kernel")
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
                     mt_ops.NOVOGRAD_KERNEL: 1, engine.LEAF_SUM_KERNEL: 1},
                    NOVOGRAD_STEPS)
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
            "tokens": {r.id: r.tokens for r in results},
            "mean_tpot_ms": tpot * 1e3, "wall_s": wall,
            "ttft_ms": ttfts.tolist(), "tpot_ms": tpots.tolist(),
            "logit_max_abs_diff": diffs,
            "profile": {"wall_ms": p_wall * 1e3, "device_busy_ms": busy_ms,
                        "top": [{"ms": t, "count": n, "name": key}
                                for t, n, key in per_kernel[:20]]}}


# -- phases 2 and 12: dropout and sampled decoding ------------------------------

# Megatron's GPT-2 345M (--attention-dropout 0.1 --hidden-dropout 0.1) and
# Google's BERT-Large bert_config.json (attention_probs_dropout_prob and
# hidden_dropout_prob 0.1)
DROP_RATE = 0.1
DROPOUT_STEPS = 10
# the kept share of the flash mask over 8.4 M (query, key) pairs: its
# standard deviation there is 1.0e-4, so 0.001 is ten of them
KEPT_TOL = 0.001
DROPOUT_SHAPES = {"hidden": (1024, 8, 1024), "probs": (8, 16, 512, 512)}
# BERT-Large with dropout at batch 2, kernels against plain versions: the
# dropout kernel alone is bitwise its plain version (loss and gradients
# exactly equal, checked as such), so the gap is the LayerNorm and
# softmax kernels' one-ulp roundings carried through 24 layers into a
# loss of 144 MLM positions. Over five keys on an H100 the whole kernel
# path's gap ranged 2.4e-4 to 5.1e-3 (without dropout, phase 6: 1.9e-3),
# the unluckiest key at phase 6's BERT_LOSS_TOL; twice that is held
BERT_DROPOUT_LOSS_TOL = 1e-2
GAP_KEYS = ((0, 1), (5, 7), (123, 456), (2024, 7))
# the flash cases with dropout: GPT-2 345M's training (b, h, s, d), causal,
# and BERT-Large's (h, s, d) over the batch of BERT_LENS
FLASH_DROPOUT_GPT = (TRAIN_BATCH, 16, 1024, 64)
FLASH_DROPOUT_BERT = (16, 512, 64)
SAMPLED = dict(temperature=0.8, top_k=50, top_p=0.95)
DROPOUT_KEY = (0x2545F491, 0x9E3779B9)


def _dropout_key(seed: int, i: int) -> torch.Tensor:
    """The key of training step ``i``: ``fold_in(PRNGKey(seed), i)``."""
    return jrandom.fold_in(jrandom.PRNGKey(seed), i)


def _rel_errs(got, want) -> dict:
    return {n: float((g.float() - w.float()).abs().max())
            / max(float(w.float().abs().max()), 1e-6)
            for n, g, w in zip(("dq", "dk", "dv"), got, want)}


def flash_option_case(name, q, k, v, do, *, causal, live_pairs, seg=None,
                      bias=None, q_pos=None, k_pos=None, glse=None,
                      rate=0.0, sdpa=None, shape=""):
    """The three flash kernels with the options of one case (segment ids,
    dropout, a bias, positions, an lse cotangent) against their plain
    versions on the same inputs: (fwd row, dq row, dk/dv row), each with
    its times, bound and SDPA yardstick (``sdpa``: its keyword arguments
    carrying the same mask, or None where no library call computes the
    function)."""
    scale = q.shape[-1] ** -0.5
    seed = attention.dropout_seed(DROPOUT_KEY) if rate > 0.0 else None
    kw = dict(bias=bias, q_pos=q_pos, k_pos=k_pos)
    fwd_args = (q, k, v, seg, seg, scale, causal, None, rate, seed)
    out, lse = attention._flash_cuda(*fwd_args, **kw)
    pout, plse = attention._attention_torch(
        q, k, v, bias, seg, seg, scale, causal, None, rate, seed,
        return_lse=True, q_pos=q_pos, k_pos=k_pos)
    delta = (out.float() * do.float()).sum(-1)
    args = (q, k, v, lse, do, delta, seg, seg, scale, causal, None, rate,
            seed)
    bkw = dict(kw, glse=glse)
    got = attention._flash_bwd_cuda(*args, **bkw)
    want = attention._flash_bwd_torch(*args, **bkw)
    torch.cuda.synchronize()
    check_repeat(f"flash_fwd {name}", lambda: attention._flash_cuda(
        *fwd_args, **kw), (out, lse))
    check_repeat(f"flash {name}", lambda: attention._flash_bwd_cuda(
        *args, **bkw), got)
    diff = (out.float() - pout.float()).abs()
    # fully masked rows are 0 on both sides: any floor keeps them at 0
    row_scale = pout.float().abs().amax(dim=-1, keepdim=True).clamp_min(1e-6)
    rel = float((diff / row_scale).max())
    lse_err = float((lse - plse).abs().max())
    errs = _rel_errs(got, want)
    print(f"  flash {name} {shape}: out row_rel_err {rel:.3e} (tol "
          f"{FLASH_OUT_REL_TOL}) lse_err {lse_err:.3e} (tol {FLASH_LSE_TOL})"
          "; " + " ".join(f"{n} rel {e:.3e}" for n, e in errs.items())
          + f" (tol {FLASH_BWD_REL_TOL})")
    check(bool(torch.isfinite(out).all()), f"flash {name}: non-finite")
    check(rel <= FLASH_OUT_REL_TOL and lse_err <= FLASH_LSE_TOL,
          f"flash {name}: forward kernel disagrees with plain")
    check(all(e <= FLASH_BWD_REL_TOL for e in errs.values()),
          f"flash {name}: backward kernels disagree with plain")
    extra_bytes = nbytes(bias, q_pos, k_pos) + 2 * nbytes(seg)
    fwd_ms = device_ms(lambda: attention._flash_cuda(*fwd_args, **kw))
    fwd_plain = device_ms(lambda: attention._attention_torch(
        q, k, v, bias, seg, seg, scale, causal, None, rate, seed,
        return_lse=True, q_pos=q_pos, k_pos=k_pos), iters=3, replays=2)
    bwd_plain = device_ms(lambda: attention._flash_bwd_torch(*args, **bkw),
                          iters=3, replays=2)
    lib_fwd = lib_bwd = None
    if sdpa is not None:
        sdpa = dict(sdpa, dropout_p=rate)
        lib_fwd = _library_ms(f"SDPA {name}", lambda: (
            F.scaled_dot_product_attention(q, k, v, **sdpa)))
        lib_bwd, _ = sdpa_bwd_ms(f"SDPA {name} backward", q, k, v, do,
                                 **sdpa)
    b_ms, by = bound(nbytes(q, k, v, out, lse) + extra_bytes,
                     4 * q.shape[-1] * live_pairs, PEAK_BF16_TENSOR_FLOPS)
    print(f"    flash_fwd: ms={fwd_ms:.5f} plain_ms={fwd_plain:.5f} "
          f"library_ms={lib_fwd} bound_ms={b_ms:.5f} ({by})")
    rows = [{"case": name, "ms": fwd_ms, "plain_ms": fwd_plain,
             "library_ms": lib_fwd, "bound_ms": b_ms, "bound_by": by,
             "row_rel_err": rel, "lse_err": lse_err,
             "max_abs_err": float(diff.max()), "shape": shape}]
    for kname, n_products, outs in (
            (attention.BWD_DQ_KERNEL, 3, got[:1]),
            (attention.BWD_DKV_KERNEL, 4, got[1:])):
        ms = device_ms(lambda kname=kname: attention._flash_bwd_cuda(
            *args, kernels=(kname,), **bkw))
        kb_ms, kby = bound(nbytes(q, k, v, do, lse, delta, glse, *outs)
                           + extra_bytes, 2 * q.shape[-1] * n_products
                           * live_pairs, PEAK_BF16_TENSOR_FLOPS)
        print(f"    {kname}: ms={ms:.5f} bound_ms={kb_ms:.5f} ({kby}); both "
              f"kernels' plain_ms={bwd_plain:.5f}, SDPA backward "
              f"library_ms={lib_bwd}")
        rows.append({"case": name, "ms": ms, "plain_ms": bwd_plain,
                     "library_ms": lib_bwd, "bound_ms": kb_ms,
                     "bound_by": kby, "errors": errs,
                     "max_abs_err": max(float((g_.float() - w_.float())
                                              .abs().max())
                                        for g_, w_ in zip(got, want)),
                     "shape": shape})
    return rows


def flash_dropout_case(name, gen, dev, b, h, sq, d, causal, keep=None):
    """The three flash kernels with dropout against the plain forward and
    backward with the same mask, at one training shape: (fwd case, dq
    case, dk/dv case); with segment ids, the masked rows exactly 0."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dev, torch.bfloat16)
    q, k, v, do = (rnd(b, h, sq, d) for _ in range(4))
    seg = keep                       # BERT: the keep-mask as segment ids
    live = _allowed(b, sq, sq, causal, None, dev)
    mask = None
    if keep is not None:
        mask = keep[:, :, None] == keep[:, None, :]
        live = live & mask
    rows = flash_option_case(
        f"dropout_{name}", q, k, v, do, causal=causal, seg=seg,
        rate=DROP_RATE, live_pairs=int(live.sum()) * h,
        sdpa=(dict(is_causal=causal) if mask is None
              else dict(attn_mask=mask[:, None])),
        shape=f"b={b} h={h} s={sq} d={d} causal={causal} "
              f"segments={keep is not None} dropout {DROP_RATE}")
    zeros = None
    if keep is not None:
        # pad queries in a segment no key has, pad keys in one no query
        # has: those rows of out and dq and of dk and dv are exactly 0
        scale, seed = d ** -0.5, attention.dropout_seed(DROPOUT_KEY)
        q_seg = torch.where(keep > 0, 1, 2).to(torch.int32)
        zo, zl = attention._flash_cuda(q, k, v, q_seg, keep, scale, causal,
                                       None, DROP_RATE, seed)
        zd = (zo.float() * do.float()).sum(-1)
        zq, zk, zv = attention._flash_bwd_cuda(
            q, k, v, zl, do, zd, q_seg, keep, scale, causal, None,
            DROP_RATE, seed)
        torch.cuda.synchronize()
        pad = (keep == 0)[:, None, :, None]
        zeros = {"out": int((zo * pad).count_nonzero()),
                 "lse": int(((zl != attention.NEG_INF)
                             & (keep == 0)[:, None]).sum()),
                 "dq": int((zq * pad).count_nonzero()),
                 "dk": int((zk * pad).count_nonzero()),
                 "dv": int((zv * pad).count_nonzero())}
        print(f"    masked rows (pad queries and keys in their own "
              f"segments): nonzero entries {zeros}")
        check(not any(zeros.values()), f"flash dropout[{name}]: a masked "
              "row is not exactly 0")
    rows[0]["masked_rows"] = zeros
    return rows


def flash_dropout_mask_probe(dev, b, h, sq) -> dict:
    """The forward kernel's keep mask read off its output: q = 0 makes the
    probabilities uniform and V the identity over 64 keys puts key j's
    dropped weight in column j. Held bitwise to the plain mask; its kept
    share within KEPT_TOL of 1 - rate."""
    sk = 64
    q = torch.zeros(b, h, sq, sk, dtype=torch.bfloat16, device=dev)
    k = torch.zeros(b, h, sk, sk, dtype=torch.bfloat16, device=dev)
    v = torch.eye(sk, device=dev).to(torch.bfloat16).expand(
        b, h, sk, sk).contiguous()
    seed = attention.dropout_seed(DROPOUT_KEY)
    out, _ = attention._flash_cuda(q, k, v, None, None, 1.0, False, None,
                                   DROP_RATE, seed)
    bh = torch.arange(b * h, device=dev).reshape(b, h, 1, 1)
    keep = attention._dropout_keep(
        seed, bh, torch.arange(sq, device=dev).reshape(sq, 1),
        torch.arange(sk, device=dev).reshape(1, sk), DROP_RATE)
    same = bool(torch.equal(out != 0, keep))
    kept = float((out != 0).float().mean())
    print(f"  flash dropout mask probe over {b * h * sq * sk} (query, key) "
          f"pairs: bitwise the plain mask {same}; kept share {kept:.5f} "
          f"(1 - rate {1 - DROP_RATE}, tol {KEPT_TOL})")
    check(same, "the flash kernel's dropout mask is not the plain mask")
    check(abs(kept - (1 - DROP_RATE)) <= KEPT_TOL,
          "the flash dropout mask keeps the wrong share")
    return {"pairs": b * h * sq * sk, "kept": kept, "bitwise": same}


def flash_dropout_cases(gen, dev) -> dict:
    b, h, s, d = FLASH_DROPOUT_GPT
    gpt = flash_dropout_case("gpt_train", gen, dev, b, h, s, d, True)
    bh, bs, bd = FLASH_DROPOUT_BERT
    bert = flash_dropout_case("bert_train", gen, dev, len(BERT_LENS), bh, bs,
                              bd, False, keep=bert_keep(dev, BERT_LENS, bs))
    return {"fwd": [gpt[0], bert[0]], "dq": [gpt[1], bert[1]],
            "dkv": [gpt[2], bert[2]],
            "probe": flash_dropout_mask_probe(dev, b, h, s)}


def dropout_case(name, gen, dev, shape) -> dict:
    """dropout.cu against its plain version: the output and the gradient
    bitwise, on one key."""
    x = torch.randn(*shape, generator=gen).to(dev, torch.bfloat16)
    g = torch.randn(*shape, generator=gen).to(dev, torch.bfloat16)
    key = DROPOUT_KEY
    got = dropout_op._dropout_cuda(x, key, DROP_RATE)
    want = dropout_op._dropout_torch(x, key, DROP_RATE)
    xg = x.clone().requires_grad_()
    with torch.enable_grad():
        dropout_op.dropout(xg, DROP_RATE, key).backward(g)
    gwant = dropout_op._dropout_torch(g, key, DROP_RATE)
    torch.cuda.synchronize()
    same = _same_bits(got, want)
    gsame = _same_bits(xg.grad, gwant)
    kept = float((got != 0).float().mean())
    print(f"  dropout[{name}] {tuple(shape)} bf16 rate {DROP_RATE}: output "
          f"bitwise {same}, gradient bitwise {gsame}, kept share {kept:.5f}")
    check(same and gsame, f"dropout[{name}]: kernel disagrees with plain")
    kernel = lambda: dropout_op._dropout_cuda(x, key, DROP_RATE)  # noqa: E731
    ms, h_ms = device_ms(kernel), host_ms(kernel)
    plain_ms = device_ms(lambda: dropout_op._dropout_torch(x, key, DROP_RATE),
                         iters=3, replays=2)
    lib_ms = _library_ms("F.dropout", lambda: F.dropout(x, DROP_RATE))
    # the integer work of threefry2x32's 20 rounds of add, rotate and xor,
    # the key injections, the index, the uniform float, the compare, the
    # division and the select
    b_ms, by, pipe = int_bound(nbytes(x, got), DROPOUT_SASS, x.numel())
    print(f"    ms={ms:.5f} host_ms={h_ms:.5f} plain_ms={plain_ms:.5f} "
          f"library_ms={lib_ms} (F.dropout) bound_ms={b_ms:.5f} ({by}: "
          f"{pipe})")
    return {"case": name, "ms": ms, "host_ms": h_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": by,
            "bound_pipe": pipe,
            "max_abs_err": float((got.float() - want.float()).abs().max()),
            "kept": kept, "shape": f"{tuple(shape)} bf16"}


def dropout_cases(gen, dev) -> dict:
    cases = [dropout_case(n, gen, dev, s) for n, s in DROPOUT_SHAPES.items()]
    # the headline is the hidden dropout's: GPT's path launches it most
    top = {k_: v_ for k_, v_ in cases[0].items() if k_ != "case"}
    return {"name": "dropout", "route": "cuda",
            "source": "apex_tpu_torch/csrc/dropout.cu",
            "replaces": "none: Flax nn.Dropout (XLA threefry and select, "
                        "no pallas_call), not the port of a TPU kernel",
            **top, "max_abs_err": max(c["max_abs_err"] for c in cases),
            "cases": cases}


DROPOUT_COUNTERS = (dropout_op.FWD_KERNEL, dropout_op.BWD_KERNEL)
# every op plain but dropout: the dropout kernel's own effect on a step
DROPOUT_ONLY = PLAIN_OPS._replace(dropout=KERNEL_OPS.dropout)


def _dropout_loop(step, state, batch, steps: int, seed: int):
    """``steps`` steps, step i with its own dropout key, the launch
    counts set to 0 just before and read just after."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    losses, times = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        state, loss = step(state, *batch, dropout_key=_dropout_key(seed, i))
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
    return state, losses, times, _build.launch_counts()


def _check_per_step(label, launches, want: dict, steps: int) -> None:
    for k, n in want.items():
        check(launches.get(k, 0) == n * steps,
              f"{label}: {k} launched {launches.get(k, 0)} times in "
              f"{steps} steps, not {n} a step")


def _worst_rel(space, gk, gp):
    plain = space.unpack(gp, "buffer")
    return max((float((a - plain[n]).norm()
                      / plain[n].norm().clamp_min(1e-30)), n)
               for n, a in space.unpack(gk, "buffer").items())


def train_dropout(seed: int, dev, card: str, base_ms: float) -> dict:
    """Phase 12b: GPT-2 345M with Megatron's dropouts, phase 4's model,
    weights and batch, FusedAdam, DROPOUT_STEPS steps each with its own
    key; the batch-2 loss and gradients through the kernels against the
    plain versions on one key."""
    cfg = GPTConfig.gpt2_345m(attention_dropout=DROP_RATE,
                              hidden_dropout=DROP_RATE)
    model = init_gpt_pretrain_params(
        cfg, torch.Generator().manual_seed(seed), device=dev)
    step, state = make_gpt_pretrain_step(
        cfg, FusedAdam(lr=1e-4, weight_decay=0.01))(model)
    rng = np.random.RandomState(seed)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab_size,
                                       (TRAIN_BATCH, cfg.max_seq_len + 1)),
                           device=dev).long()
    x, y = toks[:, :-1], toks[:, 1:]
    key = _dropout_key(seed, 1000)
    x2, y2 = x[:2], y[:2]
    loss_k, gk = _grads(step, model, lambda t: model(
        t, deterministic=False, dropout_key=key), x2, y2)
    loss_p, gp = _grads(step, model, lambda t: model.forward_plain(
        t, deterministic=False, dropout_key=key), x2, y2)
    loss_d, gd = _grads(step, model, lambda t: model._forward(
        t, None, None, None, False, DROPOUT_ONLY, False, key), x2, y2)
    with torch.no_grad():
        loss_det = float(gpt_loss_fn(model(x2), y2))
    worst = _worst_rel(state.space, gk, gp)
    drop_same = loss_d == loss_p and bool(torch.equal(gd, gp))
    del gk, gp, gd
    print(f"  batch 2, the dropout kernel alone (every other op plain) "
          f"against the plain path: loss and gradients bitwise {drop_same}")
    check(drop_same, "GPT: the dropout kernel alone moves the loss or the "
          "gradients")
    print(f"  batch 2 with dropout, kernels vs plain on one key: loss "
          f"{loss_k:.5f} vs {loss_p:.5f} (tol {TRAIN_LOSS_TOL}); worst "
          f"gradient relative L2 error {worst[0]:.3e} in {worst[1]} (tol "
          f"{TRAIN_GRAD_REL_TOL}); the loss without dropout {loss_det:.5f}")
    check(abs(loss_k - loss_p) <= TRAIN_LOSS_TOL,
          "GPT dropout loss: kernel path disagrees with the plain path")
    check(worst[0] <= TRAIN_GRAD_REL_TOL,
          "GPT dropout gradients: kernel path disagrees with the plain path")
    state, losses, times, launches = _dropout_loop(
        step, state, (x, y), DROPOUT_STEPS, seed)
    peak = torch.cuda.max_memory_allocated()
    step_s = float(np.median(times[2:]))
    tokens = TRAIN_BATCH * cfg.max_seq_len
    print(f"  losses {[round(v_, 4) for v_ in losses]}")
    print(f"  launches over {DROPOUT_STEPS} steps {launches}")
    print(f"  GPT-2 345M dropout {DROP_RATE}: step_ms median of the last "
          f"{DROPOUT_STEPS - 2} {step_s * 1e3:.2f} (first "
          f"{times[0] * 1e3:.1f}) against phase 4's {base_ms:.2f} without "
          f"dropout in this call; tokens_per_s={tokens / step_s:.0f}, peak "
          f"memory {peak / 2**30:.2f} GiB on {card}")
    check(all(np.isfinite(losses)), "GPT dropout: non-finite loss")
    check(losses[-1] < losses[0], "GPT dropout: the loss did not fall")
    n = cfg.num_layers
    _check_per_step("GPT dropout", launches, {
        attention.KERNEL: n, attention.BWD_DQ_KERNEL: n,
        attention.BWD_DKV_KERNEL: n, dropout_op.FWD_KERNEL: 2 * n,
        dropout_op.BWD_KERNEL: 2 * n, mt_ops.ADAM_KERNEL: 1},
        DROPOUT_STEPS)
    (state, _), prof = _profiled(
        lambda: step(state, x, y, dropout_key=_dropout_key(seed, 99)),
        "GPT dropout step", {"dropout": ("dropout_kernel",),
                             "flash": ("flash_",)})
    return {"launches": launches, "steps": DROPOUT_STEPS, "losses": losses,
            "step_ms": step_s * 1e3, "step_ms_all": [t * 1e3 for t in times],
            "base_step_ms": base_ms, "tokens_per_s": tokens / step_s,
            "peak_gib": peak / 2**30, "batch2_loss": [loss_k, loss_p],
            "batch2_loss_without_dropout": loss_det,
            "batch2_grad_rel_err": {"max": worst[0], "param": worst[1]},
            "batch2_dropout_kernel_alone_bitwise": drop_same,
            "profile": prof}


def train_bert_dropout(seed: int, dev, card: str, base: dict) -> dict:
    """Phase 12c: BERT-Large with both dropouts at 0.1 and NVLAMB on each
    backend (the flash kernel drops in its tiles; the softmax backend
    drops the probabilities through dropout.cu), DROPOUT_STEPS steps
    each; the batch-2 loss and gradients through the kernels against the
    plain versions on one key."""
    batch = bert_batch(seed, dev, 30528)
    b2 = tuple(t[:2] for t in batch)
    padded = len(BERT_LENS) * 512
    out = {}
    key = _dropout_key(seed, 1000)
    for backend in ("softmax", "flash"):
        cfg = BertConfig.bert_large(attention_backend=backend,
                                    attention_dropout=DROP_RATE,
                                    hidden_dropout=DROP_RATE)
        model = BertModel(cfg, device=dev,
                          generator=torch.Generator().manual_seed(seed))
        opt = FusedLAMB(lr=1e-4, weight_decay=0.01, max_grad_norm=1.0,
                        use_nvlamb=True)
        step = PretrainStep(model, opt, loss_fn=bert_dropout_loss)
        state = step.init()
        loss_k, gk = _bert_grads(step, lambda *a: model(
            *a, deterministic=False, dropout_key=key), b2)
        loss_p, gp = _bert_grads(step, lambda *a: model.forward_plain(
            *a, deterministic=False, dropout_key=key), b2)
        loss_d, gd = _bert_grads(step, lambda *a: model._forward(
            *a, DROPOUT_ONLY, False, key), b2)
        worst = _worst_rel(state.space, gk, gp)
        drop_same = loss_d == loss_p and bool(torch.equal(gd, gp))
        del gk, gp, gd
        print(f"  BERT-Large {backend} with dropout, batch 2, kernels vs "
              f"plain on one key: loss {loss_k:.5f} vs {loss_p:.5f} (tol "
              f"{BERT_DROPOUT_LOSS_TOL}); worst gradient relative L2 error "
              f"{worst[0]:.3e} in {worst[1]} (tol {BERT_GRAD_REL_TOL}); "
              f"the dropout kernel alone bitwise the plain path {drop_same}")
        check(drop_same, f"BERT {backend}: the dropout kernel alone moves "
              "the loss or the gradients")
        # the same gap on other keys: how far the kernels' roundings move
        # this loss (no check: the spread behind BERT_DROPOUT_LOSS_TOL)
        gaps = {}
        with torch.no_grad():
            for k_ in GAP_KEYS:
                lk, lp = (float(bert_loss_fn(
                    *fwd(*b2[:3], deterministic=False, dropout_key=k_),
                    *b2[3:])) for fwd in (model, model.forward_plain))
                gaps[str(k_)] = abs(lk - lp)
        print(f"    loss gaps on other keys: " + ", ".join(
            f"{k_} {g_:.3e}" for k_, g_ in gaps.items()))
        check(abs(loss_k - loss_p) <= BERT_DROPOUT_LOSS_TOL,
              f"BERT {backend} dropout loss: kernels disagree with plain")
        check(worst[0] <= BERT_GRAD_REL_TOL,
              f"BERT {backend} dropout gradients: kernels disagree with "
              "plain")
        state, losses, times, launches = _dropout_loop(
            step, state, batch, DROPOUT_STEPS, seed)
        peak = torch.cuda.max_memory_allocated()
        step_s = float(np.median(times[2:]))
        print(f"  losses {[round(v_, 4) for v_ in losses]}")
        print(f"  launches over {DROPOUT_STEPS} steps {launches}")
        print(f"  BERT-Large {backend} dropout {DROP_RATE}: step_ms median "
              f"of the last {DROPOUT_STEPS - 2} {step_s * 1e3:.2f} against "
              f"phase 6's {base[backend]['step_ms']:.2f} without dropout in "
              f"this call; tokens_per_s {padded / step_s:.0f} padded; peak "
              f"memory {peak / 2**30:.2f} GiB on {card}")
        check(all(np.isfinite(losses)), f"BERT {backend} dropout: non-finite "
              "loss")
        check(losses[-1] < losses[0], f"BERT {backend} dropout: the loss did "
              "not fall")
        n = cfg.num_layers
        if backend == "softmax":
            want = {softmax.MASKED_KERNEL: n, softmax.BWD_KERNEL: n,
                    dropout_op.FWD_KERNEL: 3 * n,
                    dropout_op.BWD_KERNEL: 3 * n}
            absent = FLASH_KERNELS
        else:
            want = {attention.KERNEL: n, attention.BWD_DQ_KERNEL: n,
                    attention.BWD_DKV_KERNEL: n,
                    dropout_op.FWD_KERNEL: 2 * n,
                    dropout_op.BWD_KERNEL: 2 * n}
            absent = SOFTMAX_KERNELS
        _check_per_step(f"BERT {backend} dropout", launches, want,
                        DROPOUT_STEPS)
        for k in absent:
            check(launches.get(k, 0) == 0,
                  f"kernel {k} launched on the BERT {backend} dropout path")
        out[backend] = {"launches": launches, "steps": DROPOUT_STEPS,
                        "losses": losses, "step_ms": step_s * 1e3,
                        "step_ms_all": [t * 1e3 for t in times],
                        "base_step_ms": base[backend]["step_ms"],
                        "tokens_per_s_padded": padded / step_s,
                        "peak_gib": peak / 2**30,
                        "batch2_loss": [loss_k, loss_p],
                        "batch2_grad_rel_err": {"max": worst[0],
                                                "param": worst[1]},
                        "batch2_dropout_kernel_alone_bitwise": drop_same,
                        "batch2_loss_gaps_other_keys": gaps}
        del model, step, state, opt
        torch.cuda.empty_cache()
    return out


def bert_dropout_loss(model, tokens, keep, tt, labels, loss_mask, nsp,
                      dropout_key=None):
    return bert_loss_fn(*model(tokens, keep, tt,
                               deterministic=dropout_key is None,
                               dropout_key=dropout_key),
                        labels, loss_mask, nsp)


class _RecordingStep(DecodeStep):
    """A DecodeStep that keeps each dispatch's logits (on the host), its
    sampling arrays, fold positions and selected tokens."""

    def __init__(self, model, cache):
        super().__init__(model, cache)
        self.calls = []

    def _select(self, out, state, sampling, fold_pos):
        res = DecodeStep._select(out, state, sampling, fold_pos)
        self.calls.append((out.cpu(), sampling, np.asarray(fold_pos).copy(),
                           res.next_token.cpu()))
        return res


def serve_sampled(seed: int, dev, card: str, srv: dict) -> dict:
    """Phase 12d: phase 3's eight requests with the lanes mixed, the odd
    ones sampled at SAMPLED with their own seeds: the greedy lanes give
    phase 3's tokens, a second run replays every stream, and the sampler
    on the host (the plain CPU ops) draws the card's token from the
    card's logits at every dispatch."""
    cfg = GPTConfig.gpt2_345m()
    model = GPTModel(cfg, device=dev,
                     generator=torch.Generator().manual_seed(seed))
    model.requires_grad_(False)
    cache = KVCache.for_config(cfg, num_blocks=8 * 1024 // 16,
                               block_size=16, device=dev)
    state = cache.init_state()
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, n) for n in PROMPT_LENS]
    requests = [Request(id=i, prompt=p, max_new_tokens=MAX_NEW,
                        **(dict(SAMPLED, seed=1000 + i) if i % 2 else {}))
                for i, p in enumerate(prompts)]

    def run(step_fn=None):
        nonlocal state
        cache.reset_prefix_cache()
        batcher = ContinuousBatcher(model, cache, max_batch=8,
                                    prefill_chunk=PREFILL_CHUNK,
                                    step_fn=step_fn)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        state, results = serve_loop(batcher, state, requests)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return ({r.id: r for r in results}, wall, batcher.step_idx,
                _build.launch_counts())

    state, _ = serve_loop(ContinuousBatcher(model, cache), state, [
        Request(id="warm", prompt=prompts[1][:16], max_new_tokens=2,
                **SAMPLED)])
    res, wall, steps, launches = run()
    check(len(res) == len(requests), "not every sampled request finished")
    for i, r in res.items():
        check(r.finish_reason == "length" and len(r.tokens) == MAX_NEW,
              f"request {i} finished with {r.finish_reason}")
    for kernel in (layer_norm.KERNEL, attention.KERNEL):
        check(launches.get(kernel, 0) > 0,
              f"kernel {kernel} never launched on the sampled serving path")
    greedy_same = {i: res[i].tokens == srv["tokens"][i]
                   for i in res if i % 2 == 0}
    rec = _RecordingStep(model, cache)
    res2, _, _, _ = run(rec)
    replay = {i: res2[i].tokens == res[i].tokens for i in res}
    host_same, draws = 0, 0
    for logits, sampling, fold_pos, tok in rec.calls:
        want = select_token(logits, sampling, fold_pos)
        host_same += int(torch.equal(want, tok))
        draws += 1
    distinct = {i: len(set(res[i].tokens)) for i in res if i % 2}
    tokens = sum(len(r.tokens) for r in res.values())
    tpot = float(np.mean([r.tpot_s for r in res.values()])) * 1e3
    ttft = float(np.mean([r.ttft_s for r in res.values()])) * 1e3
    print(f"  sampled serving (lanes 1, 3, 5, 7 at {SAMPLED}): "
          f"tokens_per_s={tokens / wall:.1f} mean_ttft_ms={ttft:.2f} "
          f"mean_tpot_ms={tpot:.2f} over {steps} engine steps, against "
          f"phase 3's greedy {srv['tokens_per_s']:.1f} tokens/s and "
          f"{srv['mean_tpot_ms']:.2f} ms in this call, on {card}")
    print(f"  greedy lanes as phase 3: {greedy_same}; replay token for "
          f"token: {replay}; host sampler on the card's logits draws the "
          f"card's tokens in {host_same} of {draws} dispatches; distinct "
          f"tokens per sampled stream {distinct}")
    check(all(greedy_same.values()), "a greedy lane differs from phase 3")
    check(all(replay.values()), "a sampled stream did not replay")
    check(host_same == draws, "the host sampler disagrees with the card's")
    check(all(n > 1 for n in distinct.values()), "a sampled stream is "
          "constant")
    return {"launches": launches, "steps": steps,
            "tokens_per_s": tokens / wall, "mean_tpot_ms": tpot,
            "mean_ttft_ms": ttft, "wall_s": wall,
            "greedy_as_phase3": greedy_same, "replay": replay,
            "host_sampler_agrees": [host_same, draws],
            "tokens": {i: r.tokens for i, r in res.items()}}


# -- phase 12: master-free bf16 training with stochastic rounding --------------

# the seed (the optimizer's step count) the phase-12a kernels round with
SR_SEED = 3
# 2^24 copies of 1 + 2^-10, 1/8 of a bf16 ulp above 1: the share rounded
# up must be 1/8 within 0.1% (a binomial's sd there is 0.008%)
SR_UNBIASED_N = 1 << 24
SR_UP_TOL = 1e-3
# the bf16-master paths (12b, 12c): phase 6's and phase 4's settings with
# master_dtype=bf16 and stochastic_rounding=True
SR_OPT = dict(master_dtype=torch.bfloat16, stochastic_rounding=True)
SR_STEPS = 10


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance between two bf16 buffers in ulps (bit
    patterns of same-sign values)."""
    return int((a.view(torch.int16).int() - b.view(torch.int16).int())
               .abs().max())


def _sr_row(name, source, n, err, run, plain_run, fp32_run, nbytes_, ops,
            shape, library_run=None, hashed=0, **extra) -> dict:
    """Time an SR kernel (CUDA graph replay), its plain version (host
    clock), the same kernel over an fp32 master (the yardstick) and, where
    one PyTorch call computes the same function (none rounds
    stochastically), that call, with its bound: bytes over 3.35 TB/s or,
    for a kernel that hashes ``hashed`` elements (csrc/sr_common.cuh: 20
    rounds, the key injections, the add and truncation), the SR cast's
    instructions an element plus ``ops`` fp32 operations (``int_bound``),
    else ``ops`` over 67 T/s, whichever is larger."""
    ms = device_ms(run, iters=5, replays=3)
    plain_ms = host_ms(plain_run, iters=1, warmup=1)
    fp32_ms = device_ms(fp32_run, iters=5, replays=3) if fp32_run else None
    lib_ms = device_ms(library_run) if library_run else None
    if hashed:
        b_ms, by, pipe = int_bound(nbytes_, SR_SASS, hashed, ops)
        extra["bound_pipe"] = pipe
    else:
        b_ms, by = bound(nbytes_, ops, PEAK_FP32_FLOPS)
    fmt = lambda x: "none" if x is None else f"{x:.5f}"  # noqa: E731
    print(f"    {name}: ms={ms:.5f} plain_ms={plain_ms:.5f} fp32_master_ms="
          f"{fmt(fp32_ms)} library_ms={fmt(lib_ms)} bound_ms={b_ms:.5f} "
          f"({by})")
    return {"name": name, "route": "cuda",
            "source": f"apex_tpu_torch/csrc/{source}",
            "replaces": extra.pop("replaces",
                                  "apex_tpu/multi_tensor/engine.py:84"),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "fp32_master_ms": fp32_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": lib_ms, "shape": shape, **extra}


def sr_cast_case(dev) -> dict:
    """``stochastic_round_cast`` at GPT-2 345M's buffer, bitwise against
    its plain version; unbiased on 2^24 copies of 1 + 2^-10; a fixed seed
    replays bitwise."""
    n = gpt_flat_size(GPTConfig.gpt2_345m())
    x = _seeded(n, dev, 30, 2e-2)
    x[:3] = torch.tensor([float("inf"), -float("inf"), float("nan")])
    got = engine.stochastic_round_cast(x, SR_SEED, 0)
    want = engine.stochastic_round_cast(x, SR_SEED, 0, plain=True)
    torch.cuda.synchronize()
    bitwise = torch.equal(got.view(torch.int16), want.view(torch.int16))
    err = float((got.float() - want.float())[3:].abs().max())
    del want
    ones = torch.full((SR_UNBIASED_N,), 1.0 + 2.0 ** -10, device=dev)
    y = engine.stochastic_round_cast(ones, 11)
    up = float((y.float() > 1.0).float().mean())
    replay = torch.equal(y.view(torch.int16),
                         engine.stochastic_round_cast(ones, 11)
                         .view(torch.int16))
    del ones, y
    print(f"  {engine.SR_CAST_KERNEL} n={n} fp32 -> bf16: bitwise={bitwise}"
          f" (inf, -inf, nan included); 2^24 x (1 + 2^-10): rounded up "
          f"{up:.6f} (1/8 within {SR_UP_TOL}); fixed-seed replay bitwise "
          f"{replay}")
    check(bitwise and replay and abs(up - 0.125) <= SR_UP_TOL,
          "stochastic_round kernel: not bitwise, not unbiased or not "
          "replayed")
    launches = _direct(lambda: engine.stochastic_round_cast(x, SR_SEED))
    return _sr_row(
        engine.SR_CAST_KERNEL, "stochastic_round.cu", n, err,
        lambda: engine.stochastic_round_cast(x, SR_SEED),
        lambda: engine.stochastic_round_cast(x, SR_SEED, plain=True), None,
        6 * n, 0, f"n={n} fp32 -> bf16 (GPT-2 345M flat buffer)",
        hashed=n, replaces="apex_tpu/multi_tensor/engine.py:48",
        up_share=up, direct_launches=launches)


def _sr_update(name, fn, p32, slots, n, shape, nbytes_, ops, source,
               dev) -> dict:
    """One functor's SR kernel: ``fn(p, slots, plain)`` runs the update
    in place on ``p`` (bf16 with SR, or fp32) and ``slots``; the kernel
    against the plain version on copies (p' and the slots bitwise), its
    launch count on one call, then the times."""
    pb = p32.bfloat16()
    copies = lambda: [t.clone() for t in slots]       # noqa: E731
    got = fn(pb.clone(), copies(), False)
    want = fn(pb.clone(), copies(), True)
    torch.cuda.synchronize()
    p_bitwise = torch.equal(got[0].view(torch.int16),
                            want[0].view(torch.int16))
    s_bitwise = all(torch.equal(a, b) for a, b in zip(got[1:], want[1:])
                    if isinstance(a, torch.Tensor) and a.ndim)
    err = float((got[0].float() - want[0].float()).abs().max())
    del got, want
    print(f"  {name} n={n} bf16 p (SR, seed {SR_SEED}): p' bitwise="
          f"{p_bitwise}, slots bitwise={s_bitwise}, max_abs_err={err:.3e}")
    check(p_bitwise and s_bitwise, f"{name}: SR kernel disagrees with its "
          "plain version")
    launches = _direct(lambda: fn(pb, slots, False))
    return _sr_row(name, source, n, err, lambda: fn(pb, slots, False),
                   lambda: fn(pb.clone(), copies(), True),
                   lambda: fn(p32, slots, False), nbytes_,
                   ops, shape, hashed=n, direct_launches=launches)


def _direct(run) -> dict:
    """The launch counts of one call of ``run``, set to 0 just before:
    the path of a kernel that no model path of this script runs."""
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    run()
    torch.cuda.synchronize()
    return _build.launch_counts()


def sr_update_cases(dev) -> list:
    """12a: each functor's SR kernel against its plain version. Adam,
    Adagrad, NovoGrad and LAMB stage 1 / stage 2 (whole buffer and the
    large leaves' segment list, keys per leaf) at GPT-2 345M's buffers;
    SGD and LARS (and LARS's ||p|| over a bf16 p) at ResNet-50's."""
    cfg = GPTConfig.gpt2_345m()
    space = FlatSpace.create(gpt_leaves(cfg))
    n = space.total
    ids = space.device_subtile_leaf_ids(dev)
    p32 = _seeded(n, dev, 31, 2e-2)
    g = _seeded(n, dev, 32, 1e-2)
    rows = []
    gshape = f"n={n} (GPT-2 345M flat buffers), bf16 p, fp32 slots"
    m, v = _seeded(n, dev, 33, 1e-3), _seeded(n, dev, 34, 1e-6, True)
    kw = dict(lr=1e-4, weight_decay=0.01, step=3)

    def adam(p, s, plain):
        return fused_adam_update(
            p, s[0], s[1], g, plain=plain,
            sr_seed=SR_SEED if p.dtype == torch.bfloat16 else None, **kw)

    rows.append(_sr_update(mt_ops.ADAM_KERNEL + mt_ops.SR_SUFFIX, adam, p32,
                           [m, v], n, gshape, 24 * n, 16 * n,
                           "fused_adam.cu", dev))
    bad = g.clone()
    bad[n // 5] = float("inf")
    pb = p32.bfloat16()
    before = [pb.clone(), m.clone(), v.clone()]
    *_, found = fused_adam_update(pb, m, v, bad, in_place=False,
                                  sr_seed=SR_SEED, **kw)
    untouched = all(torch.equal(a, b) for a, b in zip((pb, m, v), before))
    print(f"  fused_adam_sr with an inf: found_inf={float(found)}, state "
          f"untouched={untouched}")
    check(float(found) == 1.0 and untouched, "fused_adam_sr found_inf / "
          "skip wrong")
    del bad, before, pb

    def adagrad(p, s, plain):
        return mt_ops.fused_adagrad_update(
            p, s[0], g, lr=1e-3, weight_decay=0.01, plain=plain,
            sr_seed=SR_SEED if p.dtype == torch.bfloat16 else None)

    rows.append(_sr_update(mt_ops.ADAGRAD_KERNEL + mt_ops.SR_SUFFIX, adagrad,
                           p32, [v], n, gshape, 16 * n, 7 * n,
                           "adagrad_novograd.cu", dev))
    denom = torch.rand(space.num_leaves, device=dev).add_(0.5)

    def novograd(p, s, plain):
        return mt_ops.novograd_apply(
            p, s[0], g, denom, lr=1e-2, beta1=0.95, beta3=0.05,
            weight_decay=1e-3, bc1=torch.tensor(1.0), tile_ids=ids,
            plain=plain,
            sr_seed=SR_SEED if p.dtype == torch.bfloat16 else None)

    rows.append(_sr_update(mt_ops.NOVOGRAD_KERNEL + mt_ops.SR_SUFFIX,
                           novograd, p32, [m], n, gshape, 16 * n, 6 * n,
                           "adagrad_novograd.cu", dev))
    del denom
    rows += _sr_lamb_cases(dev, cfg, space, ids, p32, m, v, g)
    del p32, m, v, g
    torch.cuda.empty_cache()
    rspace = resnet_space()
    rn = rspace.total
    rids = rspace.device_subtile_leaf_ids(dev)
    rp, rmom, rg = (_seeded(rn, dev, 40 + i, s_) for i, s_ in
                    enumerate((1.0, 1e-2, 1e-2)))
    rshape = f"n={rn} (ResNet-50 flat buffers), bf16 p, fp32 momentum"

    def sgd(p, s, plain):
        return mt_ops.fused_sgd_update(
            p, s[0], rg, lr=0.1, momentum=0.9, weight_decay=1e-4,
            plain=plain,
            sr_seed=SR_SEED if p.dtype == torch.bfloat16 else None)

    rows.append(_sr_update(mt_ops.SGD_KERNEL + mt_ops.SR_SUFFIX, sgd, rp,
                           [rmom], rn, rshape, 16 * rn, 7 * rn,
                           "fused_sgd.cu", dev))
    rpb = rp.bfloat16()
    got = engine.fused_sumsq_partials(rpb, 16)
    want = engine.fused_sumsq_partials(rpb, 16, plain=True)
    torch.cuda.synchronize()
    rel = float(((got - want).abs() / want.abs().clamp_min(1e-30)).max())
    print(f"  {engine.SUMSQ_KERNEL}_bf16 over ResNet-50's bf16 p (LARS's "
          f"||p||): per-subtile max_rel_err={rel:.3e} (tol {SUMSQ_REL_TOL})")
    check(rel <= SUMSQ_REL_TOL, "sumsq over a bf16 buffer disagrees with "
          "its plain version")
    launches = _direct(lambda: engine.fused_sumsq_partials(rpb, 16))
    sumsq_row = _sr_row(
        engine.SUMSQ_KERNEL + "_bf16", "sumsq.cu", rn,
        float((got - want).abs().max()),
        lambda: engine.fused_sumsq_partials(rpb, 16),
        lambda: engine.fused_sumsq_partials(rpb, 16, plain=True),
        lambda: engine.fused_sumsq_partials(rp, 16), 2 * rn + 4 * (rn // 2048),
        2 * rn, f"n={rn} bf16 (ResNet-50), 2048-element tiles",
        library_run=lambda: torch.linalg.vector_norm(rpb,
                                                     dtype=torch.float32),
        replaces="apex_tpu/multi_tensor/engine.py:519", max_rel_err=rel,
        direct_launches=launches)
    rows.append(sumsq_row)
    ratio = mt_ops.lars_ratio(mt_ops.per_tensor_l2norm(rpb, rspace),
                              mt_ops.per_tensor_l2norm(rg, rspace),
                              trust_coefficient=0.02, weight_decay=1e-4,
                              eps=1e-8, clip=True)

    def lars(p, s, plain):
        return mt_ops.lars_apply(
            p, s[0], rg, ratio, lr=0.1, momentum=0.9, weight_decay=1e-4,
            tile_ids=rids, plain=plain,
            sr_seed=SR_SEED if p.dtype == torch.bfloat16 else None)

    rows.append(_sr_update(mt_ops.LARS_KERNEL + mt_ops.SR_SUFFIX, lars, rp,
                           [rmom], rn, rshape, 16 * rn, 5 * rn,
                           "fused_sgd.cu", dev))
    return rows


def _sr_lamb_cases(dev, cfg, space, ids, p32, m, v, g) -> list:
    """LAMB stage 1 over a bf16 p (u, m', v' bitwise), stage 2 with SR
    over the whole buffer and over the large leaves' segments of
    FusedLAMB's segmented GPT-2 345M layout (p' bitwise given the same
    ratios)."""
    n = space.total
    pb = p32.bfloat16()
    kw = dict(beta1=0.9, beta2=0.999, beta3=0.1, eps=1e-6,
              weight_decay=0.01, bias_correction1=0.271,
              bias_correction2=0.002997, adam_w_mode=True,
              inv_scale=torch.tensor(1.75, device=dev),
              with_norm_partials=True, in_place=False)
    got, _ = mt_ops.fused_lamb_compute_update_term(pb, m, v, g, **kw)
    want, _ = mt_ops.fused_lamb_compute_update_term(pb, m, v, g, plain=True,
                                                    **kw)
    torch.cuda.synchronize()
    bitwise = _bitwise(got[:3], want[:3])
    part_rel = max(float(((a.sum(-1) - b.sum(-1)).abs()
                          / b.sum(-1).abs().clamp_min(1e-30)).max())
                   for a, b in zip(got[3:], want[3:]))
    err = max(float((a - b).abs().max()) for a, b in zip(got[:3], want[:3]))
    print(f"  {mt_ops.LAMB_STAGE1_BF16_KERNEL} n={n}: u/m'/v' bitwise="
          f"{bitwise}; partials max_rel_err={part_rel:.3e}")
    check(bitwise and part_rel <= SUMSQ_REL_TOL, "lamb_stage1 over a bf16 "
          "p disagrees with its plain version")
    u = got[0]
    del got, want
    rows = [_sr_row(
        mt_ops.LAMB_STAGE1_BF16_KERNEL, "fused_lamb.cu", n, err,
        lambda: mt_ops.fused_lamb_compute_update_term(pb, m, v, g, **kw),
        lambda: mt_ops.fused_lamb_compute_update_term(pb, m, v, g,
                                                      plain=True, **kw),
        lambda: mt_ops.fused_lamb_compute_update_term(p32, m, v, g, **kw),
        26 * n + 8 * (n // 2048), 22 * n, f"n={n} (GPT-2 345M plain flat "
        "space), bf16 p, with the p and u partials")]
    ratio = torch.rand(space.num_leaves, device=dev).add_(0.5)
    s2 = lambda p, plain=False: mt_ops.lamb_apply(  # noqa: E731
        p, u, ratio, lr=1e-3, tile_ids=ids, in_place=False, plain=plain,
        sr_seed=SR_SEED if p.dtype == torch.bfloat16 else None)
    a, b = s2(pb), s2(pb, True)
    torch.cuda.synchronize()
    whole = torch.equal(a.view(torch.int16), b.view(torch.int16))
    err2 = float((a.float() - b.float()).abs().max())
    del a, b
    # the segment list: the large leaves of FusedLAMB's GPT-2 layout, each
    # with its own stream (key per leaf, index within the leaf)
    sspace, meta, _ = segment_layout(cfg)
    ns = sspace.total
    segs, _, _ = meta.device_large(dev)
    sp = _seeded(ns, dev, 35, 2e-2).bfloat16()
    su = _seeded(ns, dev, 36, 1.0)
    sratio = torch.rand(sspace.num_leaves, device=dev).add_(0.5)
    sids = sspace.device_subtile_leaf_ids(dev)
    streams = meta.device_large_streams(dev)
    seg = lambda out, plain=False: mt_ops.lamb_stage2_segments(  # noqa
        sp, su, out, sratio, sids, segs, meta.seg_elems, lr=1e-3,
        seg_streams=streams, sr_seed=SR_SEED, plain=plain)
    a, b = seg(sp.clone()), seg(sp.clone(), True)
    torch.cuda.synchronize()
    listed = torch.equal(a.view(torch.int16), b.view(torch.int16))
    del a, b
    large = segs.numel() * meta.seg_elems
    print(f"  {mt_ops.LAMB_STAGE2_KERNEL}{mt_ops.SR_SUFFIX}: whole buffer "
          f"n={n} p' bitwise={whole}; the {len(meta.large)} large leaves' "
          f"{segs.numel()} segments ({large} elements, keys per leaf) p' "
          f"bitwise={listed}")
    check(whole and listed, "lamb_stage2 SR disagrees with its plain "
          "version")
    out = sp.clone()
    row = _sr_row(
        mt_ops.LAMB_STAGE2_KERNEL + mt_ops.SR_SUFFIX, "fused_lamb.cu", n,
        err2, lambda: s2(pb), lambda: s2(pb, True), lambda: s2(p32),
        8 * n + 4 * (n // 2048), 3 * n,
        f"n={n} (GPT-2 345M plain flat space), bf16 p, per-leaf ratios",
        hashed=n)
    seg_ms = device_ms(lambda: seg(out), iters=5, replays=3)
    seg_plain_ms = host_ms(lambda: seg(out, True), iters=1, warmup=1)
    # the same segment list over an fp32 master (no stochastic rounding)
    sp32 = sp.float()
    out32 = sp32.clone()
    seg32_ms = device_ms(lambda: mt_ops.lamb_stage2_segments(
        sp32, su, out32, sratio, sids, segs, meta.seg_elems, lr=1e-3),
        iters=5, replays=3)
    del sp32, out32
    seg_bound, seg_by, _ = int_bound(8 * large, SR_SASS, large, 3 * large)
    print(f"    segment list ({large} elements): ms={seg_ms:.5f} "
          f"plain_ms={seg_plain_ms:.5f} fp32_master_ms={seg32_ms:.5f} "
          f"bound_ms={seg_bound:.5f} ({seg_by})")
    row["cases"] = [{"segments": int(segs.numel()), "elements": large,
                     "ms": seg_ms, "plain_ms": seg_plain_ms,
                     "fp32_master_ms": seg32_ms, "bound_ms": seg_bound,
                     "bound_by": seg_by}]
    rows.append(row)
    return rows


def bert_leaves(cfg: BertConfig) -> dict:
    """BERT of ``cfg``'s parameters in module order, as shapes on the
    meta device, from a one-layer model's names."""
    one = BertModel(dataclasses.replace(cfg, num_layers=1), device="cpu")
    items = [(k, tuple(p_.shape)) for k, p_ in one.named_parameters()]
    layer = [(k[len("layers.0."):], s_) for k, s_ in items
             if k.startswith("layers.0.")]
    out = {}
    for k, s_ in items:
        if k.startswith("layers.0."):
            if k == "layers.0." + layer[0][0]:
                for i in range(cfg.num_layers):
                    for name, shp in layer:
                        out[f"layers.{i}.{name}"] = torch.empty(
                            shp, device="meta")
            continue
        out[k] = torch.empty(s_, device="meta")
    return out


def sr_segment_case(dev) -> dict:
    """12a: the segment pass with SR over FusedLAMB's segmented layout of
    BERT-Large (phase 6's optimizer), p stash on and off, u fp32 and
    bf16: m', v' bitwise, p' within one bf16 ulp (the ratios' sums in
    another order); the fp32-master pass beside it."""
    from apex_tpu_torch.multi_tensor.segmented import _small_segment_pass
    cfg = BertConfig.bert_large()
    space, meta = FusedLAMB(lr=1e-4, weight_decay=0.01, max_grad_norm=1.0,
                            use_nvlamb=True).layout(bert_leaves(cfg))
    n = space.total
    p32 = _seeded(n, dev, 50, 2e-2)
    pb = p32.bfloat16()
    m, v = _seeded(n, dev, 51, 1e-3), _seeded(n, dev, 52, 1e-6, True)
    g = _seeded(n, dev, 53, 1e-2)
    large_ids = {l_ for l_, _, _ in meta.large}
    real = sum(space.sizes[i] for i in range(space.num_leaves)
               if i not in large_ids)
    scal = (0.9, 0.999, 0.1, 1e-6, 0.01, 0.271, 0.002997, 1.0)
    base = dict(meta=meta, scalars=scal, inv_scale=1.0, lr=1e-4,
                use_nvlamb=True, wd_is_zero=False)
    outs = [torch.empty_like(pb), torch.empty_like(m), torch.empty_like(v)]
    ref = [torch.empty_like(pb), torch.empty_like(m), torch.empty_like(v)]
    cases, worst = [], 0
    for stash in (True, False):
        for u_dt in (torch.float32, torch.bfloat16):
            kw = dict(base, stash_p=stash, u_dtype=u_dt, sr_seed=SR_SEED)
            f, _ = _small_segment_pass(pb, m, v, g, outs, **kw)
            wf, _ = _small_segment_pass(pb, m, v, g, ref, plain=True, **kw)
            torch.cuda.synchronize()
            small = torch.cat([torch.arange(s_ * meta.seg_elems,
                                            (s_ + 1) * meta.seg_elems,
                                            device=dev)
                               for s_ in meta.small_segments])
            mv = all(torch.equal(a[small].view(torch.int32),
                                 b[small].view(torch.int32))
                     for a, b in zip(outs[1:], ref[1:]))
            ulps = _bf16_ulps(outs[0][small], ref[0][small])
            worst = max(worst, ulps)
            del small
            print(f"  {segmented.SEGMENT_SR_KERNEL} stash_p={stash} u="
                  f"{str(u_dt)[6:]}: m'/v' bitwise={mv}, p' within {ulps} "
                  f"bf16 ulp (tol 1), found={float(f)}")
            check(mv and ulps <= 1 and float(f) == 0.0,
                  "lamb_segment SR disagrees with its plain version")
            run = lambda kw=kw: _small_segment_pass(  # noqa: E731
                pb, m, v, g, outs, **kw)
            ms = device_ms(run, iters=5, replays=3)
            plain_ms = host_ms(lambda kw=kw: _small_segment_pass(
                pb, m, v, g, ref, plain=True, **kw), iters=1, warmup=1)
            # the small leaves' own parameters: p (2 bytes, twice without
            # the stash), m, v, g read, p', m', v' written; the hash
            b_ms, by = bound((24 if stash else 26) * real,
                             (25 + 12) * real, PEAK_FP32_FLOPS)
            print(f"    ms={ms:.5f} plain_ms={plain_ms:.5f} bound_ms="
                  f"{b_ms:.5f} ({by}) over {real} parameters")
            cases.append({"stash_p": stash, "u_dtype": str(u_dt)[6:],
                          "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                          "bound_by": by, "p_ulps": ulps})
    fkw = dict(base, stash_p=True)
    fp32_ms = device_ms(lambda: _small_segment_pass(p32, m, v, g,
                                                    [p32, m, v], **fkw),
                        iters=5, replays=3)
    print(f"    the fp32-master pass (stash, u fp32): ms={fp32_ms:.5f}")
    top = cases[0]
    return {"name": segmented.SEGMENT_SR_KERNEL, "route": "cuda",
            "source": "apex_tpu_torch/csrc/lamb_segment.cu",
            "replaces": "apex_tpu/multi_tensor/segmented.py:126",
            "max_abs_err": worst, "max_abs_err_unit": "bf16 ulp",
            "ms": top["ms"], "plain_ms": top["plain_ms"],
            "fp32_master_ms": fp32_ms, "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": None, "cases": cases,
            "shape": f"{len(meta.small_segments)} small segments of "
                     f"{meta.seg_elems} (BERT-Large segmented layout, "
                     f"{real} parameters), bf16 p"}


SR_PROFILE_SHARES = {"optimizer": OPT_KERNEL_KEYS + ("adam_kernel",)}


def _grad_cast_ms(grad: torch.Tensor) -> float:
    """Device ms of the fp32 copy of a bf16 master's flat gradient that
    ``step_flat`` makes (``g.float()``, 6 bytes an element)."""
    ms = device_ms(lambda: grad.float(), iters=5, replays=3)
    print(f"  the gradient's fp32 copy (g.float(), {grad.numel()} bf16 -> "
          f"fp32): {ms:.5f} ms, bound "
          f"{6 * grad.numel() / PEAK_BYTES_PER_S * 1e3:.5f} ms (bytes)")
    return ms


def train_bert_sr(seed: int, dev, card: str, base: dict) -> dict:
    """12b: BERT-Large (bf16 parameters, softmax backend) with phase 6's
    FusedLAMB (NVLAMB) over a bf16 master with SR, ten steps on phase 6's
    batch beside phase 6's fp32-master run in this call; at batch 2 the
    loss and gradients through the kernels against the plain versions
    (phase 6's tolerances), and one update on the real gradient through
    the kernels against the plain versions (m', v' bitwise, p' within
    one bf16 ulp)."""
    cfg = BertConfig.bert_large(param_dtype=torch.bfloat16)
    batch = bert_batch(seed, dev, cfg.vocab_size)
    b2 = tuple(t[:2] for t in batch)
    padded, real = len(BERT_LENS) * 512, sum(BERT_LENS)
    t0 = time.perf_counter()
    model = BertModel(cfg, device=dev, generator=torch.Generator()
                      .manual_seed(seed)).bfloat16()
    opt = FusedLAMB(lr=1e-4, weight_decay=0.01, max_grad_norm=1.0,
                    use_nvlamb=True, **SR_OPT)
    step = PretrainStep(model, opt, loss_fn=bert_loss)
    state = step.init()
    meta = state.seg_meta
    print(f"  BERT-Large, bf16 master (SR): {state.master.numel()} bf16 "
          f"elements, seg_elems {meta.seg_elems}, {len(meta.small_segments)}"
          f" small segments, {len(meta.large)} large leaves; set-up "
          f"{time.perf_counter() - t0:.1f} s")
    loss_k, gk = _bert_grads(step, model, b2)
    loss_p, gp = _bert_grads(step, model.forward_plain, b2)
    worst = max((float((a.float() - gp_.float()).norm()
                       / gp_.float().norm().clamp_min(1e-30)), name)
                for (name, a), gp_ in zip(
                    state.space.unpack(gk, "buffer").items(),
                    state.space.unpack(gp, "buffer").values()))
    print(f"  batch 2, kernels vs plain: loss {loss_k:.5f} vs {loss_p:.5f} "
          f"(tol {BERT_LOSS_TOL}); worst gradient relative L2 error "
          f"{worst[0]:.3e} in {worst[1]} (tol {BERT_GRAD_REL_TOL})")
    check(abs(loss_k - loss_p) <= BERT_LOSS_TOL and worst[0]
          <= BERT_GRAD_REL_TOL, "BERT bf16 master: kernel path disagrees "
          "with the plain path")
    # one update on the real gradient, one norm handed to both
    gf = gk.float()
    norm, _ = mt_ops.multi_tensor_l2norm(gf)
    ukw = dict(lr=1e-4, weight_decay=0.01, max_grad_norm=1.0,
               use_nvlamb=True, step=1, global_grad_norm=norm,
               in_place=False, sr_seed=0)
    upd = [fused_lamb_segmented_update(
        state.master, state.slots["m"], state.slots["v"], gf, state.space,
        meta, plain=plain, **ukw) for plain in (False, True)]
    torch.cuda.synchronize()
    u_mv = _bitwise(upd[0][1:3], upd[1][1:3])
    u_ulps = _bf16_ulps(upd[0][0], upd[1][0])
    print(f"  one update on the real gradient, kernels vs plain: m'/v' "
          f"bitwise {u_mv}, p' within {u_ulps} bf16 ulp (tol 1)")
    check(u_mv and u_ulps <= 1, "BERT bf16 update: kernels disagree with "
          "the plain versions")
    del gk, gp, gf, upd
    state, losses, times, launches = _train_loop(step, state, batch,
                                                 SR_STEPS)
    peak = torch.cuda.max_memory_allocated()
    step_s = float(np.median(times[2:]))
    print(f"  losses {[round(v_, 4) for v_ in losses]}")
    print(f"  launches over {SR_STEPS} steps {launches}")
    print(f"  BERT-Large bf16 master: step_ms median of steps 3-{SR_STEPS} "
          f"{step_s * 1e3:.2f} against phase 6's fp32 master "
          f"{base['step_ms']:.2f} in this call; tokens_per_s "
          f"{padded / step_s:.0f} padded, {real / step_s:.0f} real; peak "
          f"memory {peak / 2**30:.2f} GiB (phase 6 {base['peak_gib']:.2f}) "
          f"on {card}")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          "BERT bf16 master: the loss is not finite or did not fall")
    per_step = {segmented.SEGMENT_SR_KERNEL: 1,
                mt_ops.LAMB_STAGE1_BF16_KERNEL: 1,
                mt_ops.LAMB_STAGE2_KERNEL + mt_ops.SR_SUFFIX: 1,
                engine.SUMSQ_KERNEL: 1,
                softmax.MASKED_KERNEL: cfg.num_layers,
                softmax.BWD_KERNEL: cfg.num_layers}
    for k, c in per_step.items():
        check(launches.get(k, 0) == c * SR_STEPS, f"BERT bf16: {k} "
              f"launched {launches.get(k, 0)} times, not {c} a step")
    for k in (SEGMENT_KERNEL, mt_ops.LAMB_STAGE1_KERNEL,
              mt_ops.LAMB_STAGE2_KERNEL):
        check(launches.get(k, 0) == 0, f"BERT bf16: the fp32 {k} launched")
    prof = _profiled(lambda: step(state, *batch), "BERT bf16-master step",
                     SR_PROFILE_SHARES)[1]
    cast_ms = _grad_cast_ms(step.grad)
    return {"grad_cast_ms": cast_ms, "launches": launches,
            "steps": SR_STEPS, "losses": losses,
            "step_ms": step_s * 1e3, "step_ms_all": [t * 1e3 for t in times],
            "fp32_master_step_ms": base["step_ms"],
            "tokens_per_s_padded": padded / step_s,
            "tokens_per_s_real": real / step_s, "peak_gib": peak / 2**30,
            "batch2_loss": [loss_k, loss_p], "batch2_grad_rel_err": worst,
            "update_p_ulps": u_ulps, "profile": prof}


def train_gpt_sr(seed: int, dev, card: str, base: dict) -> dict:
    """12c: GPT-2 345M (bf16 parameters) with phase 4's FusedAdam over a
    bf16 master with SR, ten steps on phase 4's batch beside phase 4's
    run in this call; batch 2 kernels vs plain (phase 4's tolerances);
    one Adam update on the real gradient, kernel vs plain, bitwise; then
    a step under the dynamic loss scaler with an inf in the gradient:
    skipped bitwise, the count not advanced, and the next step draws the
    stream the skipped one would have."""
    cfg = GPTConfig.gpt2_345m(param_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    model = init_gpt_pretrain_params(
        cfg, torch.Generator().manual_seed(seed), device=dev).bfloat16()
    opt = FusedAdam(lr=1e-4, weight_decay=0.01, **SR_OPT)
    step, state = make_gpt_pretrain_step(cfg, opt)(model)
    x, y = _gpt_batch(seed, dev, cfg)
    print(f"  GPT-2 345M, bf16 master (SR): {state.master.numel()} bf16 "
          f"elements; set-up {time.perf_counter() - t0:.1f} s")
    x2, y2 = x[:2], y[:2]
    loss_k, gk = _grads(step, model, model, x2, y2)
    loss_p, gp = _grads(step, model, model.forward_plain, x2, y2)
    worst = max((float((a.float() - gp_.float()).norm()
                       / gp_.float().norm().clamp_min(1e-30)), name)
                for (name, a), gp_ in zip(
                    state.space.unpack(gk, "buffer").items(),
                    state.space.unpack(gp, "buffer").values()))
    print(f"  batch 2, kernels vs plain: loss {loss_k:.5f} vs {loss_p:.5f} "
          f"(tol {TRAIN_LOSS_TOL}); worst gradient relative L2 error "
          f"{worst[0]:.3e} in {worst[1]} (tol {TRAIN_GRAD_REL_TOL})")
    check(abs(loss_k - loss_p) <= TRAIN_LOSS_TOL
          and worst[0] <= TRAIN_GRAD_REL_TOL, "GPT bf16 master: kernel path "
          "disagrees with the plain path")
    gf = gk.float()
    upd = [fused_adam_update(state.master, state.slots["m"],
                             state.slots["v"], gf, lr=1e-4,
                             weight_decay=0.01, step=1, in_place=False,
                             sr_seed=0, plain=plain) for plain in (False, True)]
    torch.cuda.synchronize()
    u_ok = (torch.equal(upd[0][0].view(torch.int16),
                        upd[1][0].view(torch.int16))
            and _bitwise(upd[0][1:3], upd[1][1:3]))
    print(f"  one Adam update on the real gradient, kernel vs plain: "
          f"bitwise {u_ok}")
    check(u_ok, "GPT bf16 Adam update: kernel disagrees with the plain "
          "version")
    del gk, gp, gf, upd
    state, losses, times, launches = _train_loop(step, state, (x, y),
                                                 SR_STEPS)
    out = _run_summary("GPT-2 345M bf16 master", losses, times, launches,
                       torch.cuda.max_memory_allocated(), card, cfg)
    print(f"  against phase 4's fp32 master in this call: step_ms "
          f"{base['step_ms']:.2f}, peak {base['peak_gib']:.2f} GiB")
    check(losses[-1] < losses[0], "GPT bf16 master: the loss did not fall")
    _check_launches("GPT bf16 master", launches,
                    {mt_ops.ADAM_KERNEL + mt_ops.SR_SUFFIX: 1,
                     mt_ops.ADAM_KERNEL: 0}, SR_STEPS)
    (state, _), out["profile"] = _profiled(
        lambda: step(state, x, y), "GPT bf16-master step", SR_PROFILE_SHARES)
    state, out["split"] = split_step(step, state, x, y)
    out["grad_cast_ms"] = _grad_cast_ms(step.grad)
    # the scaler: an inf in the gradient is skipped, count unmoved, and
    # the next step rounds with the stream the skipped one would have
    tstep = make_train_step(opt, scaler=LossScaler())
    sstep = PretrainStep(model, opt, train_step=tstep)
    ss = tstep.scaler.init()
    sstep.backward(state, x, y, scaler_state=ss)
    real_grad = sstep.grad.clone()
    replica = state._replace(master=state.master.clone(), slots={
        k: t_.clone() for k, t_ in state.slots.items()})
    expect, _, _ = tstep(replica, real_grad, ss)
    master, m_, count = state.master.clone(), state.slots["m"].clone(), \
        state.count
    bad = real_grad.clone()
    bad[12345] = float("inf")
    state2, ss2, aux = tstep(state, bad, ss)
    torch.cuda.synchronize()
    skipped = (float(aux.found_inf) == 1.0 and state2.count == count
               and torch.equal(state2.master.view(torch.int16),
                               master.view(torch.int16))
               and torch.equal(state2.slots["m"], m_)
               and ss2.loss_scale == ss.loss_scale / 2)
    after, _, _ = tstep(state2, real_grad, ss)
    torch.cuda.synchronize()
    same_stream = torch.equal(after.master.view(torch.int16),
                              expect.master.view(torch.int16))
    print(f"  scaler step with an inf: skipped (found_inf "
          f"{float(aux.found_inf)}, count {count} -> {state2.count}, master "
          f"and m bitwise, scale {ss.loss_scale} -> {ss2.loss_scale}): "
          f"{skipped}; the next step's p' bitwise the one the skipped step "
          f"would have written: {same_stream}")
    check(skipped and same_stream, "GPT bf16 master: the overflow step was "
          "not skipped cleanly")
    out.update(batch2_loss=[loss_k, loss_p], batch2_grad_rel_err=worst,
               fp32_master_step_ms=base["step_ms"],
               overflow_skipped=skipped, same_stream_after_skip=same_stream)
    return out


# -- phase 13: the flash kernels' bias, positions and lse cotangent, driven by
# -- contrib multi-head attention and zig-zag chunked causal attention --------

# the reference's multi-head attention perf test at its defaults
# (examples/multihead_attn/perf_test_multihead_attn.py): hidden 1024, 16
# heads, sequence 64, 18 layers, dropout 0.1, the largest of its 10-120
# sequences, biases and norm-add on, bf16 (its accelerator dtype); one
# layer's weights applied 18 times with the key PRNGKey(i) at layer i
MHA_HIDDEN, MHA_HEADS, MHA_SEQ, MHA_SEQS, MHA_LAYERS = 1024, 16, 64, 120, 18
MHA_LENS = (32, 64)          # the additive key-padding mask's real lengths
MHA_CHECK_SEQS = 8
MHA_TRIALS, MHA_WARMUP = 5, 2
# the 18-layer stacks at 8 sequences, the flash kernels against the plain
# attention (LayerNorm kernels and bf16 projections on both sides), in
# relative L2 norm per tensor: the kernels round P and dS to bf16 where the
# plain attention keeps fp32, and the residual stream carries each layer's
# difference into the next. An H100 read 3.3e-3 to 4.7e-3 on the output
# and at most 4.1e-3 to 6.5e-3 on a gradient (the input's) in the three
# stacks; about 3x that is held
MHA_OUT_REL_TOL = 1.5e-2
MHA_GRAD_REL_TOL = 2e-2
# zig-zag chunked causal attention at GPT-2 345M's attention layout: cp 4
# shards of two 1024-token chunks, each shard cut in ng x ng sub-tiles
ZZ_HEADS, ZZ_SEQ, ZZ_D, ZZ_CP, ZZ_NG = 16, 8192, 64, 4, 2
# chunked against unchunked kernel, the flash tolerances (two bf16 ulps of
# a row's or a gradient's largest |value|): each chunk's output is rounded
# to bf16 before the fp32 merge, and each chunk's dq, dk, dv to bf16
# before they are summed (up to 2 x 4 partials a row). An H100 read 9.1e-3
# on the output and 8.3e-4 to 6.6e-3 on the gradients
ZZ_OUT_REL_TOL = FLASH_OUT_REL_TOL
ZZ_GRAD_REL_TOL = FLASH_BWD_REL_TOL


def _live_pairs(q_pos, k_pos) -> int:
    """(query, key) pairs a causal mask over these positions leaves."""
    return int((k_pos[None, :] <= q_pos[:, None]).sum())


def _tile_pairs(q_pos, k_pos, tile: int = 64):
    """(tile pairs, pairs the position bounds skip) of one kernel call:
    ``_block_live_dynamic``'s test on each (64-query, 64-key) tile."""
    qt = [q_pos[i:i + tile] for i in range(0, len(q_pos), tile)]
    kt = [k_pos[i:i + tile] for i in range(0, len(k_pos), tile)]
    skipped = sum(1 for a in qt for b_ in kt if b_.min() > a.max())
    return len(qt) * len(kt), skipped


def flash_bias_dropout_probe(dev, b, h, s) -> dict:
    """The forward kernel's keep mask with a bias, read off its output: q
    = 0 leaves softmax(bias) in each row (every entry > 0) and V the
    identity over ``s`` keys puts key j's dropped weight in column j."""
    q = torch.zeros(b, h, s, s, dtype=torch.bfloat16, device=dev)
    k = torch.randn(b, h, s, s, device=dev).to(torch.bfloat16)
    v = torch.eye(s, device=dev).to(torch.bfloat16).expand(
        b, h, s, s).contiguous()
    bias = 2 * torch.randn(b, 1, 1, s, device=dev)
    seed = attention.dropout_seed(DROPOUT_KEY)
    out, _ = attention._flash_cuda(q, k, v, None, None, 1.0, False, None,
                                   DROP_RATE, seed, bias=bias)
    pout = attention._attention_torch(q, k, v, bias, None, None, 1.0, False,
                                      None, DROP_RATE, seed)
    bh = torch.arange(b * h, device=dev).reshape(b, h, 1, 1)
    keep = attention._dropout_keep(
        seed, bh, torch.arange(s, device=dev).reshape(s, 1),
        torch.arange(s, device=dev).reshape(1, s), DROP_RATE)
    same = bool(torch.equal(out != 0, keep)) and bool(
        torch.equal(pout != 0, keep))
    print(f"  flash bias + dropout mask probe over {b * h * s * s} (query, "
          f"key) pairs: the kernel's and the plain mask bitwise the hash's "
          f"{same}")
    check(same, "flash with a bias: the dropout mask is not the plain mask")
    return {"pairs": b * h * s * s, "bitwise": same}


def dbias_case(name, gen, dev, b, h, s, d, shape) -> dict:
    """dbias by recompute (``_dbias`` from the kernels' lse, in PyTorch)
    against ``torch.autograd`` through the plain forward; dq, dk, dv with
    it. Times the recompute alone."""
    def rnd(*shape_):
        return torch.randn(*shape_, generator=gen).to(dev, torch.bfloat16)
    q, k, v, do = (rnd(b, h, s, d) for _ in range(4))
    bias0 = torch.randn(*shape, generator=gen).to(dev)
    grads = []
    for flash in (True, False):
        leaves = [t.clone().requires_grad_() for t in (q, k, v, bias0)]
        with torch.enable_grad():
            if flash:
                out = attention.flash_attention(*leaves[:3], bias=leaves[3])
            else:
                out = attention._attention_torch(
                    *leaves[:3], leaves[3], None, None, d ** -0.5, False)
            out.backward(do)
        grads.append([t.grad for t in leaves])
    torch.cuda.synchronize()
    errs = {n: float((g_.float() - w_.float()).abs().max())
            / max(float(w_.float().abs().max()), 1e-6)
            for n, g_, w_ in zip(("dq", "dk", "dv", "dbias"), *grads)}
    print(f"  dbias[{name}] bias {tuple(shape)}: relative errors against "
          f"autograd through the plain forward {errs} (tol "
          f"{FLASH_BWD_REL_TOL})")
    check(all(e <= FLASH_BWD_REL_TOL for e in errs.values()),
          f"dbias[{name}]: disagrees with autograd through the plain forward")
    scale = d ** -0.5
    out, lse = attention._flash_cuda(q, k, v, None, None, scale, False, None,
                                     bias=bias0)
    delta = (out.float() * do.float()).sum(-1)
    ms = device_ms(lambda: attention._dbias(
        q, k, v, bias0, lse, do, delta, None, None, scale, False, None, 0.0,
        None, None, None, None), iters=5, replays=2)
    print(f"    dbias recompute (PyTorch, not a kernel) ms={ms:.5f}")
    return {"case": name, "shape": list(shape), "errors": errs,
            "dbias_ms": ms}


def flash_extra_cases(gen, dev) -> dict:
    """Phase 13a: bias of each broadcast class in fp32 and bf16 at the
    multi-head attention stack's shape, bias with dropout, positions and
    the lse cotangent at the 1024-token sub-tiles of phase 13c, dbias by
    recompute."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dev, torch.bfloat16)
    b, h, s, d = MHA_SEQS, MHA_HEADS, MHA_SEQ, MHA_HIDDEN // MHA_HEADS
    q, k, v, do = (rnd(b, h, s, d) for _ in range(4))
    lens = torch.from_numpy(np.random.RandomState(7).randint(
        MHA_LENS[0], MHA_LENS[1] + 1, size=b)).to(dev)
    pad = torch.where(torch.arange(s, device=dev)[None] >= lens[:, None],
                      -10000.0, 0.0)
    classes = {"q_k": (1, 1, s, s), "key_padding": (b, 1, 1, s),
               "full": (b, h, s, s)}
    rows = {"fwd": [], "dq": [], "dkv": []}

    def add(case_rows):
        for key, row in zip(("fwd", "dq", "dkv"), case_rows):
            rows[key].append(row)
    mha_shape = f"b={b} h={h} s={s} d={d}"
    for cname, shape in classes.items():
        for dt in (torch.float32, torch.bfloat16):
            bias = torch.randn(*shape, generator=gen).to(dev)
            if cname == "key_padding":
                bias = bias + pad[:, None, None, :]
            bias = bias.to(dt)
            add(flash_option_case(
                f"bias_{cname}_{str(dt)[6:]}", q, k, v, do, causal=False,
                bias=bias, live_pairs=b * h * s * s,
                sdpa=dict(attn_mask=bias.to(torch.bfloat16)),
                shape=f"{mha_shape} bias {tuple(shape)} {dt}"))
    bias = pad[:, None, None, :].contiguous()
    add(flash_option_case(
        "bias_key_padding_dropout", q, k, v, do, causal=False, bias=bias,
        rate=DROP_RATE, live_pairs=b * h * s * s,
        sdpa=dict(attn_mask=bias.to(torch.bfloat16)),
        shape=f"{mha_shape} bias {tuple(bias.shape)} dropout {DROP_RATE}"))
    probe = flash_bias_dropout_probe(dev, b, h, s)
    # positions: the 1024-token sub-tiles that phase 13c's schedule gives
    # the kernels (shard 0 holds chunks 0 and 7, shard 3 chunks 3 and 4):
    # chunk 4 against itself (a diagonal call), chunk 7 against chunk 3
    # (wholly past), and chunk 0 against chunk 4, wholly in the future,
    # which 13c skips: there every row is masked, out and the gradients
    # exactly 0 and lse NEG_INF
    perm, _ = context_parallel.zigzag_indices(ZZ_SEQ, ZZ_CP)
    n = ZZ_SEQ // ZZ_CP // ZZ_NG

    def sub_tile(i, b_):
        return perm[(i * ZZ_NG + b_) * n:(i * ZZ_NG + b_ + 1) * n]
    zq, zk, zv, zdo = (rnd(1, ZZ_HEADS, n, ZZ_D) for _ in range(4))
    glse = torch.randn(1, ZZ_HEADS, n, generator=gen).to(dev)
    tiles = {}
    for cname, (i, qb), (j, kb) in (("diagonal", (3, 1), (3, 1)),
                                    ("past", (0, 1), (3, 0)),
                                    ("future", (0, 0), (3, 1))):
        qp, kp = sub_tile(i, qb), sub_tile(j, kb)
        qpd, kpd = (torch.from_numpy(p_.astype(np.int32)).to(dev)
                    for p_ in (qp, kp))
        mask = torch.where(kpd[None, :] <= qpd[:, None], 0.0,
                           attention.NEG_INF).to(torch.bfloat16)
        live = ZZ_HEADS * _live_pairs(qp, kp)
        tiles[cname] = _tile_pairs(qp, kp)
        zshape = (f"b=1 h={ZZ_HEADS} s={n} d={ZZ_D} chunk {qp[0] // n} "
                  f"against chunk {kp[0] // n} of {ZZ_SEQ} tokens")
        add(flash_option_case(f"positions_{cname}", zq, zk, zv, zdo,
                              causal=True, q_pos=qpd, k_pos=kpd,
                              live_pairs=live, sdpa=dict(attn_mask=mask),
                              shape=zshape))
        add(flash_option_case(f"positions_glse_{cname}", zq, zk, zv, zdo,
                              causal=True, q_pos=qpd, k_pos=kpd, glse=glse,
                              live_pairs=live, shape=zshape))
        if cname == "future":
            scale = ZZ_D ** -0.5
            out, lse = attention._flash_cuda(zq, zk, zv, None, None, scale,
                                             True, None, q_pos=qpd,
                                             k_pos=kpd)
            delta = (out.float() * zdo.float()).sum(-1)
            grads = attention._flash_bwd_cuda(
                zq, zk, zv, lse, zdo, delta, None, None, scale, True, None,
                q_pos=qpd, k_pos=kpd, glse=glse)
            masked = (not out.count_nonzero() and not any(
                g_.count_nonzero() for g_ in grads)
                and bool((lse == attention.NEG_INF).all()))
            print(f"  flash positions wholly in the future: out, dq, dk, dv "
                  f"exactly 0 and lse NEG_INF {masked}")
            check(masked, "flash positions: a chunk wholly in the future "
                  "left a nonzero output or gradient or a finite lse")
    print(f"  position tile pairs (total, skipped by the position bounds) "
          f"per call: {tiles}")
    add(flash_option_case("glse", q, k, v, do, causal=False,
                          glse=torch.randn(b, h, s, generator=gen).to(dev),
                          live_pairs=b * h * s * s, shape=mha_shape))
    dbias = [dbias_case(cname, gen, dev, b, h, s, d, shape)
             for cname, shape in classes.items()]
    return {**rows, "bias_dropout_probe": probe, "position_tiles": tiles,
            "dbias": dbias}


def _mha_stack(mod, x, mem, masks, keys):
    """The perf test's stack: one layer applied ``len(keys)`` times, each
    with its dropout key."""
    h = x
    for key in keys:
        h, _ = mod(*((h,) if mem is None else (h, mem)), **masks,
                   dropout_key=key)
    return h


def _mha_fwd_bwd(mod, x, mem, masks, keys, x_grad=False, loss_scale=1.0):
    """One forward and backward of the stack on ``sum(h^2) *
    loss_scale``."""
    mod.zero_grad(set_to_none=True)
    x = x.detach().requires_grad_(x_grad)
    with torch.enable_grad():
        h = _mha_stack(mod, x, mem, masks, keys)
        (h.float().pow(2).sum() * loss_scale).backward()
    return h.detach(), x.grad


def _rel_l2(got, want) -> float:
    return float((got.float() - want.float()).norm()
                 / want.float().norm().clamp_min(1e-12))


MHA_KERNELS = (attention.KERNEL, attention.BWD_DQ_KERNEL,
               attention.BWD_DKV_KERNEL, layer_norm.KERNEL,
               layer_norm.BWD_KERNEL)


def mha_stacks(seed: int, dev, card: str, dtype=torch.bfloat16) -> dict:
    """Phase 13b (and 14d at fp32 and fp16): three 18-layer multi-head
    attention stacks at the perf test's shape, ``impl="fast"`` (the flash
    kernels) against ``"default"`` (the plain attention) on the same
    weights and keys, in ``dtype``."""
    s, b, e = MHA_SEQ, MHA_SEQS, MHA_HIDDEN
    dname = str(dtype)[6:]
    out_tol, grad_tol = MHA_REL_TOLS[dtype]
    ls = MHA_FP16_LOSS_SCALE if dtype == torch.float16 else 1.0
    kernels = [attention.kernel_name(k_, dtype) for k_ in MHA_KERNELS[:3]] \
        + [layer_norm.kernel_name(k_, dtype) for k_ in MHA_KERNELS[3:]] \
        + ([attention.SPLIT_KERNEL] if dtype == torch.float32 else [])
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(0.5 * rng.randn(s, b, e).astype(np.float32)).to(
        dev, dtype)
    lens = torch.from_numpy(rng.randint(MHA_LENS[0], MHA_LENS[1] + 1,
                                        size=b)).to(dev)
    pad = torch.where(torch.arange(s, device=dev)[None] >= lens[:, None],
                      -10000.0, 0.0)
    future = torch.triu(torch.ones(s, s, dtype=torch.bool, device=dev), 1)
    keys = [jrandom.key_words(jrandom.PRNGKey(i)) for i in range(MHA_LAYERS)]
    stacks = {
        "self_future": (SelfMultiheadAttn, {}, {"attn_mask": future}),
        "self_key_padding": (SelfMultiheadAttn, {"mask_additive": True},
                             {"key_padding_mask": pad}),
        "encdec_key_padding": (EncdecMultiheadAttn, {"mask_additive": True},
                               {"key_padding_mask": pad}),
    }
    res = {}
    for sname, (cls, kw, masks) in stacks.items():
        mods = {impl: cls(e, MHA_HEADS, dropout=DROP_RATE, bias=True,
                          include_norm_add=True, impl=impl,
                          dtype=dtype, device=dev,
                          generator=torch.Generator().manual_seed(seed), **kw)
                for impl in ("fast", "default")}
        mem = x if cls is EncdecMultiheadAttn else None
        launches, per_layer = {}, {}
        for impl, mod in mods.items():
            torch.cuda.synchronize()
            _build.reset_launch_counts()
            _mha_fwd_bwd(mod, x, mem, masks, keys, loss_scale=ls)
            torch.cuda.synchronize()
            launches[impl] = _build.launch_counts()
            want = MHA_LAYERS if impl == "fast" else 0
            for kname in kernels:
                n = want if kname.startswith("flash") else MHA_LAYERS
                if kname == attention.SPLIT_KERNEL:
                    # q, k, v in the forward, dO in the backward
                    n = 2 * want
                check(launches[impl].get(kname, 0) == n,
                      f"MHA {sname} {impl}: {kname} launched "
                      f"{launches[impl].get(kname, 0)} times, not {n}")
            for _ in range(MHA_WARMUP):
                _mha_fwd_bwd(mod, x, mem, masks, keys, loss_scale=ls)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(MHA_TRIALS):
                _mha_fwd_bwd(mod, x, mem, masks, keys, loss_scale=ls)
            torch.cuda.synchronize()
            per_layer[impl] = ((time.perf_counter() - t0) * 1e3
                               / MHA_TRIALS / MHA_LAYERS)
        # 8 sequences: output, input gradient and every parameter's
        # gradient through the kernels against the plain attention
        xs = x[:, :MHA_CHECK_SEQS].contiguous()
        ms_ = {n_: (m_[:MHA_CHECK_SEQS] if n_ == "key_padding_mask" else m_)
               for n_, m_ in masks.items()}
        outs = {}
        for impl, mod in mods.items():
            h, gx = _mha_fwd_bwd(mod, xs, None if mem is None else xs, ms_,
                                 keys, x_grad=True, loss_scale=ls)
            outs[impl] = (h, gx, {n_: p.grad.clone()
                                  for n_, p in mod.named_parameters()})
        (h, gx, gp), (ph, pgx, pgp) = outs["fast"], outs["default"]
        out_err = _rel_l2(h, ph)
        grad_errs = {"x": _rel_l2(gx, pgx),
                     **{n_: _rel_l2(gp[n_], pgp[n_]) for n_ in gp}}
        worst = max(grad_errs.items(), key=lambda kv: kv[1])
        finite = bool(torch.isfinite(h.float()).all())
        print(f"  MHA {sname} ({MHA_LAYERS} layers, {b} x {s} tokens, "
              f"hidden {e}, {MHA_HEADS} heads, dropout {DROP_RATE}, "
              f"{dname}): "
              f"fwd+bwd ms per layer fast {per_layer['fast']:.4f} default "
              f"{per_layer['default']:.4f} "
              f"({per_layer['default'] / per_layer['fast']:.2f}x) on {card}")
        print(f"    launches in one fwd+bwd: fast "
              f"{ {k_: launches['fast'].get(k_, 0) for k_ in kernels} } "
              f"default "
              f"{ {k_: launches['default'].get(k_, 0) for k_ in kernels} }")
        print(f"    {MHA_CHECK_SEQS} sequences, fast vs default: output "
              f"relative L2 {out_err:.3e} (tol {out_tol}), worst "
              f"gradient {worst[1]:.3e} in {worst[0]} (tol {grad_tol})")
        check(finite, f"MHA {sname} {dname}: non-finite output")
        check(out_err <= out_tol,
              f"MHA {sname} {dname}: output through the kernels disagrees")
        check(worst[1] <= grad_tol,
              f"MHA {sname} {dname}: gradients through the kernels disagree")
        res[sname] = {"ms_per_layer": per_layer, "launches": launches["fast"],
                      "launches_default": launches["default"],
                      "steps": 1, "out_rel_l2": out_err,
                      "grad_rel_l2": grad_errs}
        if sname == "self_key_padding" and dtype == torch.bfloat16:
            _, res["profile"] = _profiled(
                lambda: _mha_fwd_bwd(mods["fast"], x, mem, masks, keys),
                f"MHA {sname} fwd+bwd (fast)",
                {"flash": ("flash_",), "layer_norm": ("ln_",),
                 "gemm": ("gemm", "sm90_", "nvjet", "cutlass"),
                 "elementwise": ("elementwise", "direct_copy",
                                 "reduce_kernel")})
        del mods, outs
        torch.cuda.empty_cache()
    return res


def _zz_chunk_out(parts):
    """The ring's merge of one shard's partials (the reference's order:
    sub-tiles of a kv shard first, then shard after shard)."""
    acc = None
    for p_ in parts:
        acc = p_ if acc is None else context_parallel._merge(acc, p_)
    return acc


def zigzag_chunked(seed: int, dev, card: str) -> dict:
    """Phase 13c: causal attention over 8192 tokens in cp 4 zig-zag shards
    on one card, the ring's serial schedule: each q shard against every kv
    shard through ``_chunk_attn`` (ng x ng sub-tiles, a sub-tile wholly in
    the future skipped), merged by ``_merge``; then ``_chunk_grads``
    against the global lse and delta; then the same combine differentiated
    by autograd through out and lse (the lse cotangent). All against the
    unchunked ``flash_attention(causal=True)`` kernel on the same tokens."""
    h, S, d, cp, ng = ZZ_HEADS, ZZ_SEQ, ZZ_D, ZZ_CP, ZZ_NG
    rng = np.random.RandomState(seed + 13)
    q, k, v, g = (torch.from_numpy(rng.randn(1, h, S, d).astype(
        np.float32)).to(dev, torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    perm, _ = context_parallel.zigzag_indices(S, cp)
    n, sub = S // cp, S // cp // ng
    rows = [perm[i * n:(i + 1) * n] for i in range(cp)]
    rows_dev = [torch.from_numpy(r_).to(dev) for r_ in rows]

    def cut(t, i, b_):
        return t[:, :, rows_dev[i][b_ * sub:(b_ + 1) * sub]].contiguous()
    pos = [[torch.from_numpy(rows[i][b_ * sub:(b_ + 1) * sub].astype(
        np.int32)).to(dev) for b_ in range(ng)] for i in range(cp)]
    qs = [[cut(q, i, b_) for b_ in range(ng)] for i in range(cp)]
    ks = [[cut(k, i, b_) for b_ in range(ng)] for i in range(cp)]
    vs = [[cut(v, i, b_) for b_ in range(ng)] for i in range(cp)]
    gs = [[cut(g, i, b_) for b_ in range(ng)] for i in range(cp)]

    def live(i, qb, j, kb):
        # `_skip_future_tile`: the sub-tile runs unless wholly in the future
        return (rows[j][kb * sub:(kb + 1) * sub].min()
                <= rows[i][qb * sub:(qb + 1) * sub].max())
    sched = [(i, qb, j, kb) for i in range(cp) for qb in range(ng)
             for step in range(cp) for j in [(i - step) % cp]
             for kb in range(ng)]
    live_calls = [c_ for c_ in sched if live(*c_)]
    tiles = [0, 0]
    for i, qb, j, kb in live_calls:
        t_, s_ = _tile_pairs(rows[i][qb * sub:(qb + 1) * sub],
                             rows[j][kb * sub:(kb + 1) * sub])
        tiles[0] += t_
        tiles[1] += s_
    zero = (torch.zeros(1, h, sub, d, device=dev),
            torch.full((1, h, sub), attention.NEG_INF, device=dev))

    def forward(chunk_attn):
        """(out fp32, lse) of every shard's sub-blocks, [i][qb]."""
        res = []
        for i in range(cp):
            res.append([_zz_chunk_out(
                chunk_attn(i, qb, j, kb) if live(i, qb, j, kb) else zero
                for step in range(cp) for j in [(i - step) % cp]
                for kb in range(ng)) for qb in range(ng)])
        return res

    def kernel_attn(i, qb, j, kb):
        return context_parallel._chunk_attn(qs[i][qb], ks[j][kb], vs[j][kb],
                                            pos[i][qb], pos[j][kb], scale,
                                            True)

    def global_stats(fwd):
        """The global (lse, delta) of every shard's sub-blocks, [i][qb]."""
        return [[(fwd[i][qb][1].contiguous(),
                  (fwd[i][qb][0].to(torch.bfloat16).float()
                   * gs[i][qb].float()).sum(-1))
                 for qb in range(ng)] for i in range(cp)]

    def backward(fwd):
        """dq [i][qb], dk and dv [j][kb] in fp32, each sub-tile's share
        through ``_chunk_grads`` against the global lse and delta."""
        dq = [[torch.zeros(1, h, sub, d, device=dev) for _ in range(ng)]
              for _ in range(cp)]
        dk = [[torch.zeros(1, h, sub, d, device=dev) for _ in range(ng)]
              for _ in range(cp)]
        dv = [[torch.zeros(1, h, sub, d, device=dev) for _ in range(ng)]
              for _ in range(cp)]
        stats = global_stats(fwd)
        for i, qb, j, kb in live_calls:
            lse_b, delta_b = stats[i][qb]
            dq_p, dk_p, dv_p = context_parallel._chunk_grads(
                qs[i][qb], ks[j][kb], vs[j][kb], pos[i][qb], pos[j][kb],
                gs[i][qb], lse_b, delta_b, scale, True)
            dq[i][qb] += dq_p.float()
            dk[j][kb] += dk_p.float()
            dv[j][kb] += dv_p.float()
        return dq, dk, dv

    def assemble(parts):
        full = torch.zeros(1, h, S, d, device=dev)
        for i in range(cp):
            for b_ in range(ng):
                full[:, :, rows_dev[i][b_ * sub:(b_ + 1) * sub]] = \
                    parts[i][b_].float()
        return full

    def row_rel(got, ref):
        diff = (got.float() - ref.float()).abs()
        return float((diff / ref.float().abs().amax(-1, keepdim=True)
                      .clamp_min(1e-6)).max())

    def max_rel(got, ref):
        return float((got.float() - ref.float()).abs().max()
                     / ref.float().abs().max().clamp_min(1e-6))

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    fwd = forward(kernel_attn)
    grads = backward(fwd)
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    n_live = len(live_calls)
    for kname in (attention.KERNEL, attention.BWD_DQ_KERNEL,
                  attention.BWD_DKV_KERNEL):
        check(launches.get(kname, 0) == n_live,
              f"zig-zag: {kname} launched {launches.get(kname, 0)} times, "
              f"not once for each of the {n_live} live sub-tiles")
    # the schedule's last diagonal and last wholly-past sub-tile call
    # (chunk 4 against itself and against chunk 0), each kernel against
    # its plain version on the same inputs
    stats = global_stats(fwd)
    plain_err = {}
    for i, qb, j, kb in reversed(live_calls):
        kind = "diagonal" if (i, qb) == (j, kb) else "past"
        if kind in plain_err:
            continue
        o_k, l_k = kernel_attn(i, qb, j, kb)
        o_p, l_p = attention._attention_torch(
            qs[i][qb], ks[j][kb], vs[j][kb], None, None, None, scale, True,
            return_lse=True, q_pos=pos[i][qb], k_pos=pos[j][kb])
        lse_b, delta_b = stats[i][qb]
        g_k = context_parallel._chunk_grads(
            qs[i][qb], ks[j][kb], vs[j][kb], pos[i][qb], pos[j][kb],
            gs[i][qb], lse_b, delta_b, scale, True)
        g_p = attention._flash_bwd_torch(
            qs[i][qb], ks[j][kb], vs[j][kb], lse_b, gs[i][qb], delta_b,
            None, None, scale, True, None, q_pos=pos[i][qb],
            k_pos=pos[j][kb])
        grad_errs = _rel_errs(g_k, g_p)
        plain_err[kind] = {"out": row_rel(o_k.to(torch.bfloat16), o_p),
                           "lse": float((l_k - l_p).abs().max()),
                           **grad_errs}
        check(plain_err[kind]["out"] <= FLASH_OUT_REL_TOL
              and plain_err[kind]["lse"] <= FLASH_LSE_TOL
              and all(e_ <= FLASH_BWD_REL_TOL for e_ in grad_errs.values()),
              f"zig-zag: the {kind} sub-tile call disagrees with the plain "
              "version")
    print(f"    sub-tile calls of the schedule against the plain versions: "
          f"{plain_err} (tol out {FLASH_OUT_REL_TOL}, lse {FLASH_LSE_TOL}, "
          f"grads {FLASH_BWD_REL_TOL})")
    check(len(plain_err) == 2, "zig-zag: the schedule lacks a diagonal or "
          "a wholly-past sub-tile call")
    out_c = assemble([[o_ for o_, _ in r_] for r_ in fwd])
    lse_c = torch.zeros(1, h, S, device=dev)
    for i in range(cp):
        for b_ in range(ng):
            lse_c[:, :, rows_dev[i][b_ * sub:(b_ + 1) * sub]] = fwd[i][b_][1]
    dq_c, dk_c, dv_c = (assemble(p_) for p_ in grads)
    # the unchunked kernel on the same tokens
    with torch.no_grad():
        out_f, lse_f = attention.flash_attention(q, k, v, causal=True,
                                                 return_lse=True)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    with torch.enable_grad():
        attention.flash_attention(*leaves, causal=True).backward(g)
    want = [t.grad for t in leaves]

    out_err = row_rel(out_c.to(torch.bfloat16), out_f)
    lse_err = float((lse_c - lse_f).abs().max())
    grad_err = {n_: max_rel(a_, b_) for n_, a_, b_ in
                zip(("dq", "dk", "dv"), (dq_c, dk_c, dv_c), want)}
    # the blockwise combine differentiated by autograd through out and lse
    lq, lk, lv = (t.clone().requires_grad_() for t in (q, k, v))
    with torch.enable_grad():
        cq = [[cut(lq, i, b_) for b_ in range(ng)] for i in range(cp)]
        ck = [[cut(lk, i, b_) for b_ in range(ng)] for i in range(cp)]
        cv = [[cut(lv, i, b_) for b_ in range(ng)] for i in range(cp)]
        afwd = forward(lambda i, qb, j, kb: context_parallel._chunk_attn(
            cq[i][qb], ck[j][kb], cv[j][kb], pos[i][qb], pos[j][kb], scale,
            True))
        loss = sum((afwd[i][b_][0] * gs[i][b_].float()).sum()
                   for i in range(cp) for b_ in range(ng))
        loss.backward()
    glse_err = {n_: max_rel(a_.grad, b_) for n_, a_, b_ in
                zip(("dq", "dk", "dv"), (lq, lk, lv), want)}
    print(f"  zig-zag S={S} h={h} d={d} cp={cp} ng={ng} bf16: "
          f"{n_live} of {len(sched)} sub-tile calls live; kernel tile pairs "
          f"{tiles[0]}, {tiles[1]} skipped by the position bounds; launches "
          f"{ {k_: launches.get(k_, 0) for k_ in MHA_KERNELS[:3]} }")
    print(f"    chunked vs unchunked kernel: out row_rel_err {out_err:.3e} "
          f"(tol {ZZ_OUT_REL_TOL}) lse_err {lse_err:.3e} (tol "
          f"{FLASH_LSE_TOL}); _chunk_grads {grad_err}; autograd through "
          f"out and lse {glse_err} (tol {ZZ_GRAD_REL_TOL})")
    check(bool(torch.isfinite(out_c).all()), "zig-zag: non-finite output")
    check(out_err <= ZZ_OUT_REL_TOL and lse_err <= FLASH_LSE_TOL,
          "zig-zag: the chunked forward disagrees with the unchunked kernel")
    check(all(e_ <= ZZ_GRAD_REL_TOL for e_ in grad_err.values()),
          "zig-zag: _chunk_grads disagree with the unchunked kernel")
    check(all(e_ <= ZZ_GRAD_REL_TOL for e_ in glse_err.values()),
          "zig-zag: the lse-cotangent gradients disagree with the "
          "unchunked kernel")
    del afwd, loss, cq, ck, cv, lq, lk, lv, leaves
    # times: the serial schedule against the unchunked call, on the device
    # (CUDA graph replay: the kernels, merges and the gaps between them)
    # and by CUDA events around back-to-back runs (the schedule's host
    # work included)
    with torch.no_grad():
        delta_f = (out_f.float() * g.float()).sum(-1)
        runs = {
            "fwd": lambda: forward(kernel_attn),
            "bwd": lambda: backward(fwd),
            "unchunked_fwd": lambda: attention._flash_cuda(
                q, k, v, None, None, scale, True, None),
            "unchunked_bwd": lambda: attention._flash_bwd_cuda(
                q, k, v, lse_f, g, delta_f, None, None, scale, True, None)}
        dev_ms = {n_: device_ms(fn, iters=3, replays=3)
                  for n_, fn in runs.items()}
        host = {n_: host_ms(fn, iters=3, warmup=1) for n_, fn in runs.items()}
    pairs = h * S * (S + 1) // 2
    fwd_bound = bound(0, 4 * d * pairs, PEAK_BF16_TENSOR_FLOPS)[0]
    bwd_bound = bound(0, 14 * d * pairs, PEAK_BF16_TENSOR_FLOPS)[0]
    print("    device ms (graph replay): " + ", ".join(
        f"{n_} {t_:.4f}" for n_, t_ in dev_ms.items()) + "; with the host "
          "(CUDA events): " + ", ".join(f"{n_} {t_:.4f}"
                                        for n_, t_ in host.items())
          + f"; bound forward {fwd_bound:.4f}, backward {bwd_bound:.4f} "
          f"(operations) on {card}")
    return {"launches": launches, "steps": 1, "live_calls": n_live,
            "calls": len(sched), "tile_pairs": tiles[0],
            "tiles_skipped": tiles[1], "out_row_rel_err": out_err,
            "lse_err": lse_err, "chunk_grads_rel_err": grad_err,
            "glse_grads_rel_err": glse_err, "sub_tile_vs_plain": plain_err,
            "device_ms": dev_ms,
            "host_ms": host, "bound_ms": {"fwd": fwd_bound,
                                          "bwd": bwd_bound}}


# -- phase 14: fp32 and fp16 kernels, any head width, strided RoPE tables,
# -- fixed-order leaf sums and the probes ------------------------------------

# fp32 flash against the plain fp32 version, relative to each output's
# (each gradient's) largest |value|: the kernels' products are exact (three
# bf16 parts a value, six products), only the fp32 sums run in another
# order (and the forward's online softmax rescales its partial sums), so
# an output row errs by a few ulps of its terms, |v|, not of its own mean,
# which over 1024 keys can be ten times smaller (an H100 read 1.4e-5 of a
# row's largest |value| at the training shape, 1.1e-6 to 4.3e-6 of the
# tensor's on small cases)
FLASH32_REL_TOL = 1e-5
# fp16: two fp16 ulps (the kernel rounds P to fp16 before P.V, the plain
# forward does not; both round dS); an H100 read 9.7e-4 on outputs
FLASH16_REL_TOL = 2.0 ** -9
FP16_ULP = 2.0 ** -10        # one fp16 ulp of the value (LayerNorm, softmax)
FP16_SUBNORMAL_ULP = 2.0 ** -24   # the ulp of fp16's subnormals
FP16_ABS = 2.0 ** -14        # near zero, as LN_ABS_TOL is for bf16
FP16_ROW_TOL = 2.0 ** -9     # two fp16 ulps of a row's largest |dx|
FLASH_DTYPE_TOLS = {torch.float32: FLASH32_REL_TOL,
                    torch.float16: FLASH16_REL_TOL,
                    torch.bfloat16: FLASH_OUT_REL_TOL}
# the example's own dtype: GPT-2 345M in fp32 (pretrain_gpt.py without
# --bf16), and amp's fp16 under the dynamic loss scaler
FP32_STEPS, FP16_STEPS = 10, 5
# fp32 through 24 layers, kernels against plain versions at batch 2: every
# product exact on both sides, fp32 sums in other orders (flash, LayerNorm).
# An H100 read a loss 9.5e-7 apart (one fp32 ulp of ~9.2) and gradients at
# most 1.2e-6 apart in relative L2; about 10x and 8x that is held
TRAIN32_LOSS_TOL = 1e-5
TRAIN32_GRAD_REL_TOL = 1e-5
# fp16 rounds 8x finer than bf16 (2^-11 against 2^-8); its gradients are
# taken of the loss times the scaler's scale, as the fp16 path takes them
# (unscaled, its small gradients flush to 0 and an H100 read 9.7e-2).
# Under the scale an H100 read losses 1e-5 apart and gradients at most
# 1.9e-3 apart in relative L2 (a LayerNorm weight); about 10x and 3x that
# is held
TRAIN16_LOSS_TOL, TRAIN16_GRAD_REL_TOL = 1e-4, 6e-3
# the multi-head attention stacks at each dtype (relative L2, output and
# gradients): bf16 as phase 13b; fp32 exact products, sums in other orders
# (an H100 read at most 3.2e-7 on an output and 5.5e-7 on a gradient;
# about 20x is held); fp16 (an H100 read 5.8e-4 and 8.0e-4; about 3x)
# fp16's backward through 18 layers overflows at the loss sum(h^2) on both
# paths (plain too: |dx| passes 65504); 2^-8, the scale a loss scaler would
# settle on, keeps |dx| under 1,000
MHA_FP16_LOSS_SCALE = 2.0 ** -8
MHA_REL_TOLS = {torch.bfloat16: (MHA_OUT_REL_TOL, MHA_GRAD_REL_TOL),
                torch.float32: (1e-5, 1e-5),
                torch.float16: (2e-3, 2.5e-3)}
KPROBE_N = 64_000_000        # the reference's --n (tools/tpu_kprobe.py:47)
LN_TRAIN_ROWS = TRAIN_BATCH * 1024


def _rate(dtype) -> float:
    """The peak the flash kernels' operations are bounded by: the fp16 and
    bf16 tensor cores, or, in fp32, the same tensor cores at a sixth of
    that (PEAK_FP32_EXACT_FLOPS: six bf16 products for each exact fp32
    one)."""
    return PEAK_FP32_EXACT_FLOPS if dtype == torch.float32 else \
        PEAK_BF16_TENSOR_FLOPS


def flash_dtype_case(name, gen, dev, dtype, b, h, hk, sq, sk, d, *,
                     causal=True, written=None, bias_shape=None,
                     dropout=False, positions=None) -> dict:
    """The flash forward, dq and dk/dv kernels at ``dtype`` against their
    plain versions on one case: the output per row and each gradient
    within FLASH_DTYPE_TOLS, then each kernel's device ms, its bound, the
    plain version's ms and SDPA's (forward; backward by autograd) at the
    same dtype. Returns ``{"fwd": row, "dq": row, "dkv": row}``."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dev, dtype)
    q, k, v, do = rnd(b, h, sq, d), rnd(b, hk, sk, d), rnd(b, hk, sk, d), \
        rnd(b, h, sq, d)
    kw = {"causal": causal}
    kv_seg = None
    if written is not None:
        L = sk - sq
        ctx = torch.arange(L)[None, :] >= torch.tensor(written)[:, None]
        kv_seg = torch.cat([ctx.int(), torch.zeros(b, sq, dtype=torch.int32)],
                           dim=1).to(dev)
        kw["kv_segment_ids"] = kv_seg
    bias = None
    if bias_shape is not None:
        bias = torch.where(torch.rand(*bias_shape, generator=gen) < 0.25,
                           -10000.0, 0.0).to(dev, dtype)
        kw["bias"] = bias
    if dropout:
        kw.update(dropout_rate=DROP_RATE, dropout_rng=DROPOUT_KEY)
    if positions is not None:
        kw.update(q_positions=positions[0], kv_positions=positions[1])
    scale, q_seg, k_seg, seed, q_pos, k_pos = attention._prepare(
        q, k, v, bias, None, kw.get("kv_segment_ids"), causal, None, None,
        DROP_RATE if dropout else 0.0, kw.get("dropout_rng"),
        kw.get("q_positions"), kw.get("kv_positions"))
    rate = DROP_RATE if dropout else 0.0
    ex = dict(bias=bias, q_pos=q_pos, k_pos=k_pos)
    fwd = lambda: attention._flash_cuda(  # noqa: E731
        q, k, v, q_seg, k_seg, scale, causal, None, rate, seed, **ex)
    out, lse = fwd()
    pout, plse = attention._attention_torch(
        q, k, v, bias, q_seg, k_seg, scale, causal, None, rate, seed,
        return_lse=True, q_pos=q_pos, k_pos=k_pos)
    delta = (out.float() * do.float()).sum(-1)
    args = (q, k, v, lse, do, delta, q_seg, k_seg, scale, causal, None, rate,
            seed)
    grads = attention._flash_bwd_cuda(*args, **ex)
    pgrads = attention._flash_bwd_torch(*args, **ex)
    torch.cuda.synchronize()
    check_repeat(f"flash_fwd {name}", fwd, (out, lse))
    check_repeat(f"flash {name}", lambda: attention._flash_bwd_cuda(
        *args, **ex), grads)
    tol = FLASH_DTYPE_TOLS[dtype]
    # bf16 and fp16 per output row (their roundings are the row's); fp32
    # against the output's largest |value| (FLASH32_REL_TOL)
    row = (pout.float().abs().amax(dim=-1, keepdim=True)
           if dtype != torch.float32 else pout.float().abs().max())
    out_err = float(((out.float() - pout.float()).abs()
                     / row.clamp_min(1e-6)).max())
    lse_err = float((lse - plse).abs().max())
    g_errs = {n_: float((a.float() - e.float()).abs().max()
                        / e.float().abs().max().clamp_min(1e-6))
              for n_, a, e in zip(("dq", "dk", "dv"), grads, pgrads)}
    abs_errs = {"fwd": float((out.float() - pout.float()).abs().max()),
                "dq": float((grads[0].float() - pgrads[0].float()).abs()
                            .max()),
                "dkv": max(float((a.float() - e.float()).abs().max())
                           for a, e in zip(grads[1:], pgrads[1:]))}
    finite = all(bool(torch.isfinite(t.float()).all())
                 for t in (out, *grads))
    dname = str(dtype)[6:]
    shape = (f"b={b} h={h} hk={hk} sq={sq} sk={sk} d={d} {dname} causal="
             f"{causal}" + (" segments" if written is not None else "")
             + (f" bias {tuple(bias_shape)}" if bias_shape else "")
             + (f" dropout {DROP_RATE}" if dropout else "")
             + (" positions" if positions is not None else ""))
    print(f"  flash {dname}[{name}] {shape}: out rel_err={out_err:.3e} "
          f"lse_err={lse_err:.3e} " + " ".join(
              f"{n_}={e_:.3e}" for n_, e_ in g_errs.items())
          + f" (tol {tol}, lse {FLASH_LSE_TOL})")
    check(finite, f"flash {dname}[{name}]: non-finite output or gradient")
    check(out_err <= tol and lse_err <= FLASH_LSE_TOL
          and max(g_errs.values()) <= tol,
          f"flash {dname}[{name}] kernels disagree with their plain versions")
    del pout, plse, pgrads
    plain_fwd = device_ms(lambda: attention._attention_torch(
        q, k, v, bias, q_seg, k_seg, scale, causal, None, rate, seed,
        return_lse=True, q_pos=q_pos, k_pos=k_pos), iters=2, replays=2)
    plain_bwd = device_ms(lambda: attention._flash_bwd_torch(*args, **ex),
                          iters=2, replays=2)
    # the library's attention at the same dtype, forward and backward
    live = _allowed(b, sq, sk, causal, kv_seg, dev)
    if positions is not None:
        live = (positions[1][None, None, :].long()
                <= positions[0][None, :, None].long()).expand(b, sq, sk)
    mask = None
    if bias is not None:
        mask = bias.expand(b, h, sq, sk)
    elif written is not None or positions is not None or sq != sk:
        mask = live[:, None]
    sdpa_kw = dict(attn_mask=mask, dropout_p=rate, enable_gqa=hk != h,
                   is_causal=causal and mask is None)
    sdpa_fwd = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, **sdpa_kw)
    lib_fwd = _library_ms(f"SDPA {dname}", sdpa_fwd)
    lib_fwd_dev = device_ms(sdpa_fwd)
    lib_bwd, lib_bwd_host = sdpa_bwd_ms(f"SDPA backward {dname}", q, k, v,
                                        do, **sdpa_kw)
    pairs = int(live.sum()) * h
    rows = {}
    split_ms, fsplit_ms, bex, fwd_k = None, None, ex, fwd
    if dtype == torch.float32:
        # fp32's kernels read the split pass's planes: the split timed
        # apart (q, k, v for the forward; q, k, v, dO for the backward
        # pair), the kernels on planes made once
        width = attention.tma_width(d)
        split_ms = device_ms(lambda: attention._split3_cuda((q, k, v, do),
                                                            width))
        fsplit_ms = device_ms(lambda: attention._split3_cuda((q, k, v),
                                                             width))
        bex = dict(ex, planes=attention._split3_cuda((q, k, v, do), width))
        fex = dict(ex, planes=bex["planes"][:3])
        fwd_k = lambda: attention._flash_cuda(  # noqa: E731
            q, k, v, q_seg, k_seg, scale, causal, None, rate, seed, **fex)
        check_repeat(f"flash_fwd {name} on given planes", fwd_k, (out, lse))
    for key, kname, kernel, n_prod, outs, pms, lms in (
            ("fwd", attention.KERNEL, fwd_k, 2, (out, lse), plain_fwd,
             lib_fwd),
            ("dq", attention.BWD_DQ_KERNEL, lambda: attention._flash_bwd_cuda(
                *args, kernels=(attention.BWD_DQ_KERNEL,), **bex), 3,
             grads[:1], plain_bwd, lib_bwd),
            ("dkv", attention.BWD_DKV_KERNEL,
             lambda: attention._flash_bwd_cuda(
                 *args, kernels=(attention.BWD_DKV_KERNEL,), **bex), 4,
             grads[1:], plain_bwd, lib_bwd)):
        ms = device_ms(kernel)
        ins = (q, k, v) if key == "fwd" else (q, k, v, do, lse, delta)
        b_ms, by = bound(nbytes(*ins, *outs, bias, kv_seg),
                         2 * d * n_prod * pairs, _rate(dtype))
        print(f"    {attention.kernel_name(kname, dtype)}: ms={ms:.5f} "
              f"bound_ms={b_ms:.5f} ({by}) plain_ms={pms:.5f} "
              f"library_ms={lms if lms is None else round(lms, 5)}"
              + (f" (SDPA by device time {lib_fwd_dev:.5f})" if key == "fwd"
                 else " (plain and library: both backward kernels' work)"))
        rows[key] = {"case": name, "ms": ms, "bound_ms": b_ms,
                     "bound_by": by, "plain_ms": pms, "library_ms": lms,
                     **({"library_device_ms": lib_fwd_dev} if key == "fwd"
                        else {"library_host_ms": lib_bwd_host}),
                     **({"split_ms": split_ms} if key == "dq" and split_ms
                        is not None else {}),
                     **({"split_ms": fsplit_ms, "with_split_ms": ms
                         + fsplit_ms} if key == "fwd" and fsplit_ms
                        is not None else {}),
                     "max_abs_err": abs_errs[key],
                     "rel_err": out_err if key == "fwd" else max(
                         g_errs[x_] for x_ in (("dq",) if key == "dq"
                                               else ("dk", "dv"))),
                     "shape": shape}
    if split_ms is not None:
        print(f"    {attention.SPLIT_KERNEL} (q, k, v into bf16 parts, one "
              f"launch): ms={fsplit_ms:.5f}; forward + split "
              f"{rows['fwd']['with_split_ms']:.5f} against SDPA's forward "
              f"{lib_fwd_dev:.5f} (device)")
        print(f"    {attention.SPLIT_KERNEL} (q, k, v, dO into bf16 parts, "
              f"one launch): ms={split_ms:.5f}; dq + dk/dv + split "
              f"{rows['dq']['ms'] + rows['dkv']['ms'] + split_ms:.5f} against "
              f"SDPA's backward {lib_bwd:.5f} (device)")
    del out, lse, grads
    return rows


def split_case(gen, dev) -> dict:
    """The fp32 kernels' split pass (``csrc/flash_split3.cu``
    ``flash_split3_kernel``) at GPT-2 345M's training shape, q, k, v and dO
    (b 8, h 16, s 1024, d 64) in one launch: bitwise its plain version,
    its device ms beside its bound (each fp32 input read once, each bf16
    plane written once) and the plain version's. No PyTorch call computes
    the same planes (library_ms null)."""
    xs = [torch.randn(TRAIN_BATCH, 16, 1024, 64, generator=gen).to(dev)
          for _ in range(4)]
    width = attention.tma_width(64)
    got = attention._split3_cuda(xs, width)
    want = [attention._split3_torch(x, width) for x in xs]
    torch.cuda.synchronize()
    same = all(torch.equal(g_.view(torch.int16), w_.view(torch.int16))
               for g_, w_ in zip(got, want))
    check(same, f"{attention.SPLIT_KERNEL}: the planes differ from the plain "
          "version's")
    ms = device_ms(lambda: attention._split3_cuda(xs, width))
    plain_ms = device_ms(lambda: [attention._split3_torch(x, width)
                                  for x in xs], iters=5)
    b_ms, by = bound(nbytes(*xs, *got), 8 * sum(x.numel() for x in xs),
                     PEAK_FP32_FLOPS)
    print(f"  {attention.SPLIT_KERNEL} 4 x (8, 16, 1024, 64) fp32 -> bf16 "
          f"planes: bitwise={same} ms={ms:.5f} plain_ms={plain_ms:.5f} "
          f"bound_ms={b_ms:.5f} ({by})")
    return {"name": attention.SPLIT_KERNEL, "route": "cuda",
            "source": "apex_tpu_torch/csrc/flash_split3.cu",
            "replaces": "apex_tpu/ops/attention.py:182",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": by, "library_ms": None, "max_abs_err": 0.0,
            "bitwise": same,
            "shape": "q, k, v, dO (8, 16, 1024, 64) fp32, planes of 64"}


def flash_dtype_cases(gen, dev) -> tuple:
    """Phase 14a's flash cases: fp32 and fp16 at GPT-2 345M's training
    shape (b 8, h 16, s 1024, d 64, causal), at the serving prefill and
    decode shapes, once with a key-padding bias at the multi-head attention
    shape, once with the zig-zag positions of a past 1024-token sub-tile
    and once with dropout 0.1; and head_dim 96 in bf16 (zero-padded to the
    built 96). Returns (the six fp32 and fp16 rows, the bf16 d=96 case
    for each bf16 row)."""
    zz_q = torch.arange(7 * 1024, 8 * 1024, device=dev, dtype=torch.int32)
    zz_k = torch.arange(3 * 1024, 4 * 1024, device=dev, dtype=torch.int32)
    rows = []
    for dtype in (torch.float32, torch.float16):
        cases = [
            flash_dtype_case("train", gen, dev, dtype, TRAIN_BATCH, 16, 16,
                             1024, 1024, 64),
            flash_dtype_case("prefill", gen, dev, dtype, 4, 16, 16, 512, 512,
                             64),
            flash_dtype_case("decode", gen, dev, dtype, 8, 16, 16, 1, 1025,
                             64, causal=False,
                             written=[1024, 700, 512, 300, 200, 100, 64, 32]),
            flash_dtype_case("mha_bias", gen, dev, dtype, MHA_SEQS, 16, 16,
                             MHA_SEQ, MHA_SEQ, 64, causal=False,
                             bias_shape=(MHA_SEQS, 1, 1, MHA_SEQ)),
            flash_dtype_case("positions_past", gen, dev, dtype, 1, 16, 16,
                             1024, 1024, 64, positions=(zz_q, zz_k)),
            flash_dtype_case("train_dropout", gen, dev, dtype, TRAIN_BATCH,
                             16, 16, 1024, 1024, 64, dropout=True),
        ]
        torch.cuda.empty_cache()
        dname = str(dtype)[6:]
        for key, base, src, line in (
                ("fwd", attention.KERNEL, "flash_fwd", 182),
                ("dq", attention.BWD_DQ_KERNEL, "flash_bwd", 402),
                ("dkv", attention.BWD_DKV_KERNEL, "flash_bwd", 470)):
            crows = [c[key] for c in cases]
            top = {k_: v_ for k_, v_ in crows[0].items() if k_ != "case"}
            rows.append({"name": attention.kernel_name(base, dtype),
                         "route": "cuda",
                         "source": f"apex_tpu_torch/csrc/{src}_{dname}.cu"
                         .replace("float32", "fp32").replace("float16",
                                                             "fp16"),
                         "replaces": f"apex_tpu/ops/attention.py:{line}",
                         **top, "max_abs_err": max(
                             c_["max_abs_err"] for c_ in crows),
                         "cases": crows})
    d96 = flash_dtype_case("head_dim_96", gen, dev, torch.bfloat16, 4, 16,
                           16, 1024, 1024, 96)
    return rows, d96


# phase 14f: the bf16/fp16 flash kernels on wgmma and TMA at the training
# shape (h 16, s 1024, causal), each head width, and the forward's serving
# and multi-head attention shapes, each beside its bound and SDPA's by
# device time: name, dtype, (batch, sq, sk, head_dim), flash_dtype_case's
# options
_TRAIN = (TRAIN_BATCH, 1024, 1024, 64)
FLASH_REPORT = (
    ("bf16_train", torch.bfloat16, _TRAIN, {}),
    ("fp16_train", torch.float16, _TRAIN, {}),
    ("bf16_train_dropout", torch.bfloat16, _TRAIN, dict(dropout=True)),
    # serving: GPT-2 345M's decode over the paged context (segment ids for
    # the unwritten tail) and a prefill; one warpgroup a block at sq 1
    ("bf16_decode", torch.bfloat16, (8, 1, 1025, 64),
     dict(causal=False, written=[1024, 700, 512, 300, 200, 100, 64, 32])),
    ("bf16_prefill", torch.bfloat16, (4, 512, 512, 64), {}),
    # the multi-head attention stacks' 64 tokens with a key-padding bias
    ("bf16_mha_bias", torch.bfloat16, (MHA_SEQS, MHA_SEQ, MHA_SEQ, 64),
     dict(causal=False, bias_shape=(MHA_SEQS, 1, 1, MHA_SEQ))),
    ("bf16_d96", torch.bfloat16, (4, 1024, 1024, 96), {}),
    ("fp16_d96", torch.float16, (4, 1024, 1024, 96), {}),
    ("bf16_d128", torch.bfloat16, (4, 1024, 1024, 128), {}),
    ("fp16_d128", torch.float16, (4, 1024, 1024, 128), {}),
    ("bf16_d256", torch.bfloat16, (4, 1024, 1024, 256), {}),
    ("fp16_d256", torch.float16, (4, 1024, 1024, 256), {}),
    # no multiple of 8: the wrappers pad it to 64 (TMA's rows)
    ("bf16_d60", torch.bfloat16, (4, 1024, 1024, 60), {}),
    ("fp16_d60", torch.float16, (4, 1024, 1024, 60), {}),
    # fp32 (the exact three-part design of csrc/flash_bwd32_sm90.cuh),
    # at each shape above and each built width
    ("fp32_train", torch.float32, _TRAIN, {}),
    ("fp32_train_dropout", torch.float32, _TRAIN, dict(dropout=True)),
    ("fp32_mha_bias", torch.float32, (MHA_SEQS, MHA_SEQ, MHA_SEQ, 64),
     dict(causal=False, bias_shape=(MHA_SEQS, 1, 1, MHA_SEQ))),
    ("fp32_prefill", torch.float32, (4, 512, 512, 64), {}),
    ("fp32_decode", torch.float32, (8, 1, 1025, 64),
     dict(causal=False, written=[1024, 700, 512, 300, 200, 100, 64, 32])),
    ("fp32_d32", torch.float32, (4, 1024, 1024, 32), {}),
    ("fp32_d96", torch.float32, (4, 1024, 1024, 96), {}),
    ("fp32_d128", torch.float32, (4, 1024, 1024, 128), {}),
    ("fp32_d60", torch.float32, (4, 1024, 1024, 60), {}),
)


def flash_report_cases(gen, dev) -> dict:
    """Phase 14f: ``flash_dtype_case`` at each FLASH_REPORT shape (the
    forward, dq and dk/dv against their plain versions, repeated calls
    bitwise equal, device ms beside the bound and SDPA's by device time).
    Returns {name: {"fwd", "dq", "dkv"}}."""
    out = {}
    for name, dtype, (b, sq, sk, d), opts in FLASH_REPORT:
        out[name] = flash_dtype_case(name, gen, dev, dtype, b, 16, 16, sq,
                                     sk, d, **opts)
        torch.cuda.empty_cache()
    print("  flash forward per call (device ms; fp32 also with its split of "
          "q, k, v) against SDPA's forward (device ms) and the bound: "
          + "; ".join(
              f"{n} {r['fwd']['ms']:.4f}"
              + (f" (+ split {r['fwd']['with_split_ms']:.4f})"
                 if "with_split_ms" in r["fwd"] else "")
              + f" vs {r['fwd']['library_device_ms']:.4f}"
              f", bound {r['fwd']['bound_ms']:.4f}" for n, r in out.items()))
    print("  flash backward per call (dq + dk/dv, device ms) against SDPA's "
          "backward (device ms) and the bound: " + "; ".join(
              f"{n} {r['dq']['ms'] + r['dkv']['ms']:.4f} vs "
              f"{r['dq']['library_ms']}, bound "
              f"{r['dq']['bound_ms'] + r['dkv']['bound_ms']:.4f}"
              for n, r in out.items()))
    out["split"] = split_case(gen, dev)
    # the host cost of the tensor maps each launch encodes (four)
    lib = _build.library("flash_bwd", "apex_flash_bwd_map_us",
                         (_build.P,) + (_build.I,) * 4,
                         "apex_flash_bwd_error_string")
    lib.apex_flash_bwd_map_us.restype = ctypes.c_double
    x = torch.empty(TRAIN_BATCH * 16, 1024, 64, dtype=torch.bfloat16,
                    device=dev)
    map_us = lib.apex_flash_bwd_map_us(x.data_ptr(), TRAIN_BATCH * 16, 1024,
                                       64, 1000)
    print(f"  tensor-map encoding: {map_us:.3f} us a map on the host, four a "
          "launch")
    check(map_us > 0, "a tensor map failed to encode")
    out["map_encode_us"] = map_us
    # the host-side padding of a head_dim off TMA's 16-byte rows (60 -> 64
    # at b4 h16 s1024): the forward pads q, k, v and cuts out back, the
    # backward pads q, k, v and dO and cuts dq, dk and dv back
    t = torch.zeros(4, 16, 1024, 60, dtype=torch.bfloat16, device=dev)

    def pad_and_cut(n_in, n_out):
        wide = [F.pad(t, (0, 4)) for _ in range(n_in)]
        return [w[..., :60].contiguous() for w in wide[:n_out]]

    out["pad_fwd_ms"] = device_ms(lambda: pad_and_cut(3, 1))
    out["pad_ms"] = device_ms(lambda: pad_and_cut(4, 3))
    print(f"  padding d 60 to 64 around the forward: {out['pad_fwd_ms']:.5f} "
          f"ms, around the backward: {out['pad_ms']:.5f} ms (device, b4 h16 "
          "s1024 bf16)")
    return out


def ln_fp16_cases(gen, dev) -> list:
    """LayerNorm #1 and #3 in fp16 at the training rows (8192, 1024): the
    output within one fp16 ulp (plus FP16_ABS near zero), the statistics
    within LN_STAT_TOL, dx as the output, dw and db within LN_PARAM_TOL."""
    rows, h = LN_TRAIN_ROWS, 1024
    x = torch.randn(rows, h, generator=gen).mul_(2).add_(0.5).to(
        dev, torch.float16)
    g = torch.randn(rows, h, generator=gen).to(dev, torch.float16)
    w = (1 + 0.1 * torch.randn(h, generator=gen)).to(dev)
    b = (0.1 * torch.randn(h, generator=gen)).to(dev)
    y, mean, rstd = layer_norm._fwd_cuda(x, w, b, 1e-5, False)
    py, pmean, prstd = layer_norm._fwd_torch(x, w, b, 1e-5, False)
    dx, dw, db = layer_norm._bwd_cuda(x, w, mean, rstd, g, False)
    pdx, pdw, pdb = layer_norm._bwd_torch(x, w, mean, rstd, g, False)
    torch.cuda.synchronize()

    def excess(a, e):
        return float(((a.float() - e.float()).abs()
                      - FP16_ULP * e.float().abs()).max())
    y_ex, dx_ex = excess(y, py), excess(dx, pdx)
    stat = max(float((mean - pmean).abs().max()),
               float(((rstd - prstd) / prstd).abs().max()))
    p_err = max(float((a - e).abs().max()) / float(e.abs().max())
                for a, e in ((dw, pdw), (db, pdb)))
    print(f"  layer_norm fp16 rows={rows} h={h}: y excess over one fp16 ulp "
          f"{y_ex:.3e}, dx {dx_ex:.3e} (tol {FP16_ABS}); stat_err="
          f"{stat:.3e} (tol {LN_STAT_TOL}); dw/db rel_err={p_err:.3e} (tol "
          f"{LN_PARAM_TOL})")
    check(y_ex <= FP16_ABS and stat <= LN_STAT_TOL,
          "layer_norm_fwd fp16 kernel disagrees with its plain version")
    check_repeat(f"layer_norm_fwd fp16 rows={rows}",
                 lambda: layer_norm._fwd_cuda(x, w, b, 1e-5, False),
                 (y, mean, rstd))
    check(dx_ex <= FP16_ABS and p_err <= LN_PARAM_TOL,
          "layer_norm_bwd fp16 kernel disagrees with its plain version")

    def fwd(x_=x):
        return layer_norm._fwd_cuda(x_, w, b, 1e-5, False)

    def bwd(x_=x, g_=g, m_=mean, r_=rstd):
        return layer_norm._bwd_cuda(x_, w, m_, r_, g_, False)
    check_repeat(f"layer_norm_bwd fp16 rows={rows}", bwd, (dx, dw, db))
    wl, bl = w.half(), b.half()
    _, lmean, lrstd = torch.native_layer_norm(x, (h,), wl, bl, 1e-5)
    out = []
    for base, kernel, cold_ins, plain, lib, ins, outs, ops, line in (
            (layer_norm.KERNEL, fwd, (x,),
             lambda: layer_norm._fwd_torch(x, w, b, 1e-5, False),
             lambda: F.layer_norm(x, (h,), wl, bl, 1e-5), (x, w, b),
             (y, mean, rstd), 8, 45),
            (layer_norm.BWD_KERNEL, bwd, (x, g, mean, rstd),
             lambda: layer_norm._bwd_torch(x, w, mean, rstd, g, False),
             lambda: torch.ops.aten.native_layer_norm_backward(
                 g, x, (h,), lmean, lrstd, wl, bl, [True, True, True]),
             (x, g, w, mean, rstd), (dx, dw, db), 13, 67)):
        ms, h_ms = device_ms(kernel), host_ms(kernel)
        c_ms = cold_ms(kernel, *cold_ins)
        plain_ms = device_ms(plain, iters=5)
        lib_ms = device_ms(lib)
        b_ms, by = bound(nbytes(*ins, *outs), ops * rows * h,
                         PEAK_FP32_FLOPS)
        name = layer_norm.kernel_name(base, torch.float16)
        print(f"    {name}: ms={ms:.5f} cold_ms={c_ms:.5f} host_ms="
              f"{h_ms:.5f} plain_ms={plain_ms:.5f} library_ms="
              f"{lib_ms:.5f} bound_ms={b_ms:.5f} ({by})")
        out.append({"name": name, "route": "cuda",
                    "source": "apex_tpu_torch/csrc/layer_norm.cu",
                    "replaces": f"apex_tpu/ops/layer_norm.py:{line}",
                    "max_abs_err": float((y.float() - py.float()).abs().max())
                    if base == layer_norm.KERNEL
                    else float((dx.float() - pdx.float()).abs().max()),
                    "ms": ms, "cold_ms": c_ms, "host_ms": h_ms,
                    "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": by, "library_ms": lib_ms,
                    "shape": f"rows={rows} h={h} fp16 x, fp32 w/b"})
    return out


def rope_strided_case(dev) -> dict:
    """#16 with tables that vary per batch (C 3): Llama-2-7B's sbhd in bf16
    with a (s, b, 1, rot) cos and sin, read through their strides."""
    s, b, h, d = LLAMA_SBHD
    f = rope_freqs(s, d, dev)
    # a per-sequence position offset: each batch row's own table
    off = torch.arange(b, device=dev, dtype=torch.float32)[None, :, None,
                                                           None] * 17.0
    inv = f[1:2] if s > 1 else f
    ang = f + off * inv
    cgen = torch.Generator(device=dev).manual_seed(17)
    t = torch.randn(LLAMA_SBHD, generator=cgen, device=dev).bfloat16()
    return rope_case("llama2_7b_sbhd_per_batch_tables", t, torch.cos(ang),
                     torch.sin(ang), None)


def leaf_sum_case(dev) -> dict:
    """The fixed-order per-leaf sum (C 4) at GPT-2 345M's 292 leaves:
    bitwise its plain version, and two runs bitwise; ``index_add_`` (the
    atomics it replaces) as the library yardstick."""
    space = FlatSpace.create(gpt_leaves(GPTConfig.gpt2_345m()))
    n_sub = space.total // engine.DEFAULT_ALIGN
    x = _seeded(n_sub, dev, 71, 1.0, positive=True)
    a = engine.leaf_sums(x, space)
    b = engine.leaf_sums(x, space)
    p = engine.leaf_sums(x, space, plain=True)
    torch.cuda.synchronize()
    ok = _same_bits(a, p) and _same_bits(a, b)
    ids = space.device_subtile_leaf_ids(dev).long()
    lib = torch.zeros(space.num_leaves, device=dev).index_add_(0, ids,
                                                               x[:len(ids)])
    lib_rel = float(((lib - p) / p.abs().clamp_min(1e-30)).abs().max())
    runs = engine.leaf_runs(space)
    longest = int((runs[:, 1] - runs[:, 0]).max())
    print(f"  leaf_sum {n_sub} partials in {space.num_leaves} leaves "
          f"(the longest run {longest}): kernel vs plain and two runs "
          f"bitwise {ok}; index_add_ (atomics) max rel {lib_rel:.3e}")
    check(ok, "leaf_sum kernel is not bitwise its plain version")
    ms = device_ms(lambda: engine.leaf_sums(x, space))
    # the plain version reads its longest run on the host: CUDA events
    plain_ms = host_ms(lambda: engine.leaf_sums(x, space, plain=True),
                       iters=3, warmup=1)
    out = torch.zeros(space.num_leaves, device=dev)
    lib_ms = device_ms(lambda: out.zero_().index_add_(0, ids, x[:len(ids)]))
    b_ms, by = bound(nbytes(x, a) + 8 * space.num_leaves, n_sub,
                     PEAK_FP32_FLOPS)
    print(f"    ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms={lib_ms:.5f} "
          f"bound_ms={b_ms:.5f} ({by})")
    return {"name": engine.LEAF_SUM_KERNEL, "route": "cuda",
            "source": "apex_tpu_torch/csrc/sumsq.cu",
            "replaces": "apex_tpu/multi_tensor/engine.py:519",
            "max_abs_err": float((a - p).abs().max()), "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": lib_ms, "index_add_rel_err": lib_rel,
            "shape": f"{n_sub} fp32 partials, {space.num_leaves} leaves "
                     "(GPT-2 345M)"}


def dtype_kernel_cases(seed: int, dev) -> dict:
    """Phase 14a: every new dtype case of the kernels against its plain
    version, with its times."""
    gen = torch.Generator().manual_seed(seed + 14)
    with torch.no_grad():
        flash, d96 = flash_dtype_cases(gen, dev)
        torch.cuda.empty_cache()
        ln = ln_fp16_cases(gen, dev)
        torch.cuda.empty_cache()
        sm = softmax_cases(gen, dev, torch.float16)
        torch.cuda.empty_cache()
        rp = rope_strided_case(dev)
        torch.cuda.empty_cache()
        ls = leaf_sum_case(dev)
        torch.cuda.empty_cache()
    return {"rows": flash + ln + sm + [ls], "d96": d96, "rope": rp}


def _flash_names(dtype):
    return tuple(attention.kernel_name(k_, dtype) for k_ in (
        attention.KERNEL, attention.BWD_DQ_KERNEL, attention.BWD_DKV_KERNEL))


def _ln_names(dtype):
    return tuple(layer_norm.kernel_name(k_, dtype)
                 for k_ in (layer_norm.KERNEL, layer_norm.BWD_KERNEL))


def _worst_grad(space, gk, gp):
    plain = space.unpack(gp, "buffer")
    return max((float((a - plain[n_]).norm()
                      / plain[n_].norm().clamp_min(1e-30)), n_)
               for n_, a in space.unpack(gk, "buffer").items())


def train_fp32(seed: int, dev, card: str) -> dict:
    """Phase 14b: GPT-2 345M at the example's own dtype, fp32 (flash
    backend, FusedAdam, 8 x 1024 tokens, FP32_STEPS steps): every fp32
    flash kernel exactly 24 times a step and the split pass 48 (q, k, v in
    each layer's forward, whose planes the backward takes; dO in its
    backward), losses finite and falling, step time, tokens/s, peak memory,
    a profiled step's busy share with the forward's and the backward's
    flash time; at batch 2 the loss and gradients against the plain
    path."""
    cfg = GPTConfig.gpt2_345m(dtype=torch.float32)
    t0 = time.perf_counter()
    model = init_gpt_pretrain_params(
        cfg, torch.Generator().manual_seed(seed), device=dev)
    step, state = make_gpt_pretrain_step(
        cfg, FusedAdam(lr=1e-4, weight_decay=0.01))(model)
    x, y = _gpt_batch(seed, dev, cfg)
    print(f"  GPT-2 345M fp32 (torch.backends.cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, PyTorch's default), "
          f"set-up {time.perf_counter() - t0:.1f} s")
    state, losses, times, launches = _train_loop(step, state, (x, y),
                                                 FP32_STEPS)
    out = _run_summary("GPT-2 fp32", losses, times, launches,
                       torch.cuda.max_memory_allocated(), card, cfg)
    check(losses[-1] < losses[0], "the fp32 training loss did not fall")
    per_step = {k_: cfg.num_layers for k_ in _flash_names(torch.float32)}
    per_step[attention.SPLIT_KERNEL] = 2 * cfg.num_layers
    per_step.update({k_: 2 * cfg.num_layers + 1
                     for k_ in _ln_names(torch.float32)})
    per_step[mt_ops.ADAM_KERNEL] = 1
    _check_per_step("GPT-2 fp32", launches, per_step, FP32_STEPS)
    for k_ in _flash_names(torch.bfloat16)[:1] + _flash_names(
            torch.float16)[:1]:
        check(launches.get(k_, 0) == 0, f"GPT-2 fp32: {k_} launched")
    (state, _), out["profile"] = _profiled(
        lambda: step(state, x, y), "GPT-2 fp32 step",
        {"flash": ("flash_",), "optimizer": ("adam_kernel",),
         **LN_PROFILE_SHARES})
    prof = out["profile"]
    _ln_profile(prof, "the fp32 step")
    # parts of the "flash" share: the forward and its split of q, k, v
    # (the split's three-job instance), the backward pair and its split of
    # dO (one job)
    prof["flash_fwd_ms"] = sum(m["ms"] for m in prof["matched"]
                               if "flash_fwd" in m["name"]
                               or "flash_split3_kernel<3>" in m["name"])
    prof["flash_bwd_ms"] = sum(m["ms"] for m in prof["matched"]
                               if "flash_bwd" in m["name"]
                               or "flash_split3_kernel<1>" in m["name"])
    if prof["device_busy_ms"] > 0:
        for part in ("fwd", "bwd"):
            ms = prof[f"flash_{part}_ms"]
            print(f"  the fp32 flash {part} and its split pass: {ms:.3f} ms "
                  f"of {prof['device_busy_ms']:.1f} ms busy "
                  f"({100 * ms / prof['device_busy_ms']:.2f}%)")
    x2, y2 = x[:2], y[:2]
    loss_k, gk = _grads(step, model, model, x2, y2)
    loss_p, gp = _grads(step, model, model.forward_plain, x2, y2)
    worst = _worst_grad(state.space, gk, gp)
    print(f"  batch 2, kernels vs plain: loss {loss_k:.7f} vs {loss_p:.7f} "
          f"(|diff| {abs(loss_k - loss_p):.3e}, tol {TRAIN32_LOSS_TOL}); "
          f"worst gradient relative L2 {worst[0]:.3e} in {worst[1]} (tol "
          f"{TRAIN32_GRAD_REL_TOL})")
    check(abs(loss_k - loss_p) <= TRAIN32_LOSS_TOL,
          "fp32 loss: kernel path disagrees with the plain path")
    check(worst[0] <= TRAIN32_GRAD_REL_TOL,
          "fp32 gradients: kernel path disagrees with the plain path")
    out.update({"batch2_loss": [loss_k, loss_p],
                "batch2_grad_rel_err": {"max": worst[0], "param": worst[1]},
                "allow_tf32": torch.backends.cuda.matmul.allow_tf32})
    return out


def train_fp16(seed: int, dev, card: str, backend: str) -> dict:
    """Phase 14c: GPT-2 345M at ``dtype=float16`` under the dynamic loss
    scaler (``make_train_step(FusedAdam, scaler=LossScaler())`` through
    ``PretrainStep``), FP16_STEPS steps on ``backend``: the fp16 flash
    kernels (flash) or the fp16 causal softmax and its backward (softmax)
    exactly 24 times a step, LayerNorm fp16 49; the scale and the skipped
    steps; at batch 2 the loss and gradients against the plain path."""
    cfg = GPTConfig.gpt2_345m(dtype=torch.float16, attention_backend=backend)
    model = init_gpt_pretrain_params(
        cfg, torch.Generator().manual_seed(seed), device=dev)
    opt = FusedAdam(lr=1e-4, weight_decay=0.01)
    tstep = make_train_step(opt, scaler=LossScaler())
    step = PretrainStep(model, opt, train_step=tstep)
    state, ss = step.init(), tstep.scaler.init()
    x, y = _gpt_batch(seed, dev, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    losses, times, scales, skipped = [], [], [], []
    for _ in range(FP16_STEPS):
        t0 = time.perf_counter()
        count = state.count
        state, ss, loss = step(state, x, y, scaler_state=ss)
        losses.append(float(loss))
        times.append(time.perf_counter() - t0)
        scales.append(float(ss.loss_scale))
        skipped.append(state.count == count)
    launches = _build.launch_counts()
    label = f"GPT-2 fp16 {backend}"
    out = _run_summary(label, losses, times, launches,
                       torch.cuda.max_memory_allocated(), card, cfg)
    print(f"  {label}: loss scale after each step {scales}, skipped "
          f"{sum(skipped)} of {FP16_STEPS} ({skipped})")
    check(not all(skipped), f"{label}: every step skipped")
    check(losses[-1] < losses[0], f"{label}: the loss did not fall")
    per_step = {k_: 2 * cfg.num_layers + 1 for k_ in _ln_names(torch.float16)}
    if backend == "flash":
        per_step.update({k_: cfg.num_layers
                         for k_ in _flash_names(torch.float16)})
    else:
        per_step.update({softmax.kernel_name(k_, torch.float16):
                         cfg.num_layers for k_ in (softmax.CAUSAL_KERNEL,
                                                   softmax.BWD_KERNEL)})
        for k_ in _flash_names(torch.float16):
            check(launches.get(k_, 0) == 0, f"{label}: {k_} launched")
    for k_ in _flash_names(torch.float32) + (attention.SPLIT_KERNEL,):
        check(launches.get(k_, 0) == 0, f"{label}: {k_} launched")
    _check_per_step(label, launches, per_step, FP16_STEPS)
    x2, y2 = x[:2], y[:2]
    step._bind(state)          # the model on the state's (new) master
    # the gradients as the fp16 path takes them: of the loss times the
    # scaler's scale (unscaled, fp16's small gradients flush to 0)
    scale = float(ss.loss_scale)
    loss_k, gk = _grads(step, step.model, step.model, x2, y2, scale)
    loss_p, gp = _grads(step, step.model, step.model.forward_plain, x2, y2,
                        scale)
    worst = _worst_grad(state.space, gk, gp)
    print(f"  batch 2, kernels vs plain: loss {loss_k:.5f} vs {loss_p:.5f} "
          f"(tol {TRAIN16_LOSS_TOL}); worst gradient relative L2 "
          f"{worst[0]:.3e} in {worst[1]} (tol {TRAIN16_GRAD_REL_TOL})")
    check(abs(loss_k - loss_p) <= TRAIN16_LOSS_TOL,
          f"{label} loss: kernel path disagrees with the plain path")
    check(worst[0] <= TRAIN16_GRAD_REL_TOL,
          f"{label} gradients: kernel path disagrees with the plain path")
    out.update({"loss_scales": scales, "skipped": skipped,
                "batch2_loss": [loss_k, loss_p],
                "batch2_grad_rel_err": {"max": worst[0], "param": worst[1]}})
    return out


def probe_cases(dev) -> list:
    """Phase 14e: the kprobe ladder at KPROBE_N (every kernel rung bitwise
    its plain version, adam_found exactly 0 and then 1 on an injected inf)
    and the launch probe (every case inside sm_90's limits PASSes, every
    one outside FAILs). One row a kernel, with its launches on this run."""
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    recs = kprobe.ladder(KPROBE_N, device=dev, timer=device_ms)
    k_launches = _build.launch_counts()
    gb = KPROBE_N * 4 / 1e9
    for rec in recs.values():
        print(f"  kprobe {json.dumps(rec)}")
        print(f"    {rec['what']}: {rec['gb_per_sec']:.1f} GB/s against "
              f"{PEAK_BYTES_PER_S / 1e9:.0f} GB/s "
              f"({100 * rec['gb_per_sec'] / (PEAK_BYTES_PER_S / 1e9):.1f}%)")
    for rung in kprobe.KERNEL_RUNGS:
        check(recs[rung]["bitwise"],
              f"kprobe {rung} is not bitwise its plain version")
    check(recs["adam_found"]["found_clean"] == 0.0
          and recs["adam_found"]["found_inf"] == 1.0,
          "kprobe adam_found: the flag is wrong")
    p, m, v, g = kprobe.inputs(KPROBE_N, dev)
    rows = []
    for rung in kprobe.KERNEL_RUNGS:
        rec = recs[rung]
        plain_ms = device_ms(lambda r=rung: kprobe.plain_rung(r, p, m, v, g),
                             iters=3, replays=2)
        lib_ms = device_ms(lambda: torch.mul(p, 1.0000001)) \
            if rung == "copy1" else None
        b_ms, by = bound(kprobe.STREAMS[rung] * gb * 1e9,
                         (1 if rung == "copy1" else 11) * KPROBE_N,
                         PEAK_FP32_FLOPS)
        print(f"    {kprobe.kernel_name(rung)}: ms={rec['ms']:.5f} plain_ms="
              f"{plain_ms:.5f} library_ms="
              f"{lib_ms if lib_ms is None else round(lib_ms, 5)} bound_ms="
              f"{b_ms:.5f} ({by})")
        rows.append({"name": kprobe.kernel_name(rung), "route": "cuda",
                     "source": "apex_tpu_torch/csrc/kprobe.cu",
                     "replaces": "tools/tpu_kprobe.py:" + {
                         "copy1": "93", "multi7": "108", "adam_math": "134",
                         "adam_found": "163", "adam_alias": "180"}[rung],
                     "max_abs_err": 0.0 if rec["bitwise"] else None,
                     "ms": rec["ms"], "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
                     "gb_per_sec": rec["gb_per_sec"],
                     "direct_launches": k_launches,
                     "shape": f"n={KPROBE_N} fp32"})
    rows[0]["ladder"] = recs
    del p, m, v, g
    torch.cuda.empty_cache()
    _build.reset_launch_counts()
    results = launch_probe.probe_all(dev, echo=lambda s_: print(s_))
    l_launches = _build.launch_counts()
    off = [r for r in results if r["result"] != r["expected"]]
    check(not off, f"launch probe: cases not as expected {off}")
    # each kernel's time on one case: the largest tiling, 64 K elements at
    # 256 threads, the gather
    big = launch_probe.CASES[8]
    xt = torch.rand(big.arr_shape, device=dev)
    xl = torch.rand(1 << 16, device=dev)
    ids, vals, xg = launch_probe.gather_inputs(dev)
    sz = launch_probe.GATHER_SIZES
    lim = launch_probe.Limit("threads 256", 256, 0, 1, True)
    org = torch.from_numpy(launch_probe.block_origins(big)).to(dev)
    for name, kernel, plain, lib, ins, line in (
            (launch_probe.TILES_KERNEL,
             lambda: launch_probe.run_tiles(big, xt, org),
             lambda: launch_probe.plain_tiles(big, xt),
             lambda: torch.mul(xt, 2.0), (xt,), "24"),
            (launch_probe.LIMITS_KERNEL,
             lambda: launch_probe.run_limit(lim, xl),
             lambda: xl * 2.0, lambda: torch.mul(xl, 2.0), (xl,), "24"),
            (launch_probe.GATHER_KERNEL,
             lambda: launch_probe.run_gather(ids, vals, xg, sz["tile_rows"],
                                             sz["sub"]),
             lambda: launch_probe.plain_gather(ids, vals, xg,
                                               sz["tile_rows"], sz["sub"]),
             None, (xg,), "102")):
        ms = device_ms(kernel)
        plain_ms = host_ms(plain, iters=5)
        lib_ms = device_ms(lib) if lib is not None else None
        b_ms, by = bound(2 * nbytes(*ins), ins[0].numel(), PEAK_FP32_FLOPS)
        print(f"    {name}: ms={ms:.5f} plain_ms={plain_ms:.5f} library_ms="
              f"{lib_ms if lib_ms is None else round(lib_ms, 5)} bound_ms="
              f"{b_ms:.6f} ({by})")
        rows.append({"name": name, "route": "cuda",
                     "source": "apex_tpu_torch/csrc/launch_probe.cu",
                     "replaces": f"tools/mosaic_probe.py:{line}",
                     "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
                     "direct_launches": l_launches,
                     "cases": [r for r in results if r["kind"] == {
                         launch_probe.TILES_KERNEL: "tiles",
                         launch_probe.LIMITS_KERNEL: "limits",
                         launch_probe.GATHER_KERNEL: "gather"}[name]]})
    return rows


def fp16_softmax_dispatch(seed: int, dev) -> dict:
    """Phase 14c: ``FusedScaleMaskSoftmax(input_in_fp16=True)`` at the BERT
    scores' shape, with BERT's padding mask and without one, forward and
    backward, the counts set to 0 just before: the fp16 masked and scaled
    forwards, which no fp16 model path here calls, and the backward."""
    gen = torch.Generator().manual_seed(seed)
    scores = torch.randn(*BERT_SCORES, generator=gen).to(
        dev, torch.float16).requires_grad_()
    mask = bert_extended_attention_mask(bert_keep(dev))
    _build.reset_launch_counts()
    fn = FusedScaleMaskSoftmax(input_in_fp16=True)
    fn(scores, mask).float().sum().backward()
    fn(scores).float().sum().backward()
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    print(f"  FusedScaleMaskSoftmax fp16 with a padding mask and without, "
          f"forward and backward: launches {launches}")
    for base, n in ((softmax.MASKED_KERNEL, 1), (softmax.SCALED_KERNEL, 1),
                    (softmax.BWD_KERNEL, 2)):
        k_ = softmax.kernel_name(base, torch.float16)
        check(launches.get(k_, 0) == n, f"{k_} launched "
              f"{launches.get(k_, 0)} times in the dispatcher run, not {n}")
    check(bool(torch.isfinite(scores.grad.float()).all()),
          "fp16 dispatcher: non-finite gradient")
    return {"launches": launches, "steps": 1}


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
        print(f"  built {', '.join(_build.SOURCES)} in {secs:.1f} s; the "
              "slowest: " + ", ".join(
                  f"{n} {t:.1f} s" for n, t in sorted(
                      _build.build_seconds.items(), key=lambda kv: -kv[1])[:4]))
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
            rows = [ln, flash_cases(gen, dev), layer_norm_bwd_cases(gen, dev),
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

    def dropout_kernel_cases():
        gen = torch.Generator().manual_seed(args.seed + 11)
        with torch.no_grad():
            flash = flash_dropout_cases(gen, dev)
            torch.cuda.empty_cache()
            return flash, dropout_cases(gen, dev)

    fdrop, drow = phase("phase 11a: the flash kernels with dropout and "
                        "dropout.cu against their plain versions",
                        dropout_kernel_cases)
    gdr = phase("phase 11b: GPT-2 345M with attention and hidden dropout "
                "0.1", lambda: train_dropout(args.seed, dev, card,
                                             trn["step_ms"]))
    bdr = phase("phase 11c: BERT-Large with attention and hidden dropout "
                "0.1 on both backends",
                lambda: train_bert_dropout(args.seed, dev, card, bert))
    ssv = phase("phase 11d: serving GPT-2 345M with sampled lanes",
                lambda: serve_sampled(args.seed, dev, card, srv))

    def sr_kernel_cases():
        with torch.no_grad():
            rows = [sr_cast_case(dev)]
            torch.cuda.empty_cache()
            rows += sr_update_cases(dev)
            torch.cuda.empty_cache()
            rows.append(sr_segment_case(dev))
        return rows

    srk = phase("phase 12a: the stochastic-rounding kernels against their "
                "plain versions", sr_kernel_cases)
    bsr = phase("phase 12b: BERT-Large with a bf16 master (FusedLAMB NVLAMB, "
                "stochastic rounding)",
                lambda: train_bert_sr(args.seed, dev, card, bert["softmax"]))
    gsr = phase("phase 12c: GPT-2 345M with a bf16 master (FusedAdam, "
                "stochastic rounding) and the loss scaler",
                lambda: train_gpt_sr(args.seed, dev, card, trn))

    def flash_extra_kernel_cases():
        gen = torch.Generator().manual_seed(args.seed + 13)
        with torch.no_grad():
            return flash_extra_cases(gen, dev)

    fx = phase("phase 13a: the flash kernels with a bias, global positions "
               "and an lse cotangent against their plain versions",
               flash_extra_kernel_cases)
    mha = phase("phase 13b: contrib multi-head attention, three 18-layer "
                "stacks at the perf test's shape",
                lambda: mha_stacks(args.seed, dev, card))
    zz = phase("phase 13c: zig-zag chunked causal attention over "
               f"{ZZ_SEQ} tokens in {ZZ_CP} shards",
               lambda: zigzag_chunked(args.seed, dev, card))
    dk14 = phase("phase 14a: fp32 and fp16 flash, fp16 LayerNorm and "
                 "softmax, head_dim 96, per-batch RoPE tables and the "
                 "fixed-order leaf sums against their plain versions",
                 lambda: dtype_kernel_cases(args.seed, dev))
    f32 = phase("phase 14b: GPT-2 345M pretraining in fp32 (the example's "
                "dtype)", lambda: train_fp32(args.seed, dev, card))
    f16 = {backend: phase(f"phase 14c: GPT-2 345M at fp16 under the loss "
                          f"scaler, {backend} backend",
                          lambda b_=backend: train_fp16(args.seed, dev, card,
                                                        b_))
           for backend in ("flash", "softmax")}
    f16["dispatcher"] = phase("phase 14c: the fp16 softmax dispatcher",
                              lambda: fp16_softmax_dispatch(args.seed, dev))
    mha16 = {str(dt)[6:]: phase(
        f"phase 14d: contrib multi-head attention stacks at "
        f"{str(dt)[6:]}", lambda d_=dt: mha_stacks(args.seed, dev, card, d_))
        for dt in (torch.float32, torch.float16)}
    prb = phase("phase 14e: the kprobe ladder and the launch probe",
                lambda: probe_cases(dev))

    def flash_report():
        with torch.no_grad():
            return flash_report_cases(torch.Generator().manual_seed(
                args.seed + 17), dev)

    bwr = phase("phase 14f: the wgmma/TMA flash forward and backward (bf16, "
                "fp16) at the training, serving and multi-head attention "
                "shapes and head widths 60 to 256", flash_report)
    # the dropout cases join their kernels' rows; dropout.cu gets its own
    by_name = {k["name"]: k for k in kernels}
    by_name[attention.KERNEL]["cases"] += fdrop["fwd"]
    by_name[attention.KERNEL]["dropout_mask_probe"] = fdrop["probe"]
    by_name[attention.BWD_DQ_KERNEL]["cases"] += fdrop["dq"]
    by_name[attention.BWD_DKV_KERNEL]["cases"] += fdrop["dkv"]
    # the bias, position and lse-cotangent cases join them too
    by_name[attention.KERNEL]["cases"] += fx["fwd"]
    by_name[attention.KERNEL]["bias_dropout_mask_probe"] = \
        fx["bias_dropout_probe"]
    by_name[attention.BWD_DQ_KERNEL]["cases"] += fx["dq"]
    by_name[attention.BWD_DKV_KERNEL]["cases"] += fx["dkv"]
    # phase 14: head_dim 96 (bf16) and the per-batch RoPE tables join their
    # rows; the new dtypes, the leaf sum and the probes get their own
    for key, base in (("fwd", attention.KERNEL),
                      ("dq", attention.BWD_DQ_KERNEL),
                      ("dkv", attention.BWD_DKV_KERNEL)):
        by_name[base]["cases"].append(dk14["d96"][key])
    by_name[rope.KERNEL]["cases"].append(dk14["rope"])
    kernels.append(drow)
    kernels += srk
    kernels += dk14["rows"] + prb
    # phase 14f's cases join the rows of their dtype
    kernels.append(bwr.pop("split"))
    by_name = {k["name"]: k for k in kernels}
    for name, dtype, *_ in FLASH_REPORT:
        for key, base in (("fwd", attention.KERNEL),
                          ("dq", attention.BWD_DQ_KERNEL),
                          ("dkv", attention.BWD_DKV_KERNEL)):
            by_name[attention.kernel_name(base, dtype)]["cases"].append(
                bwr[name][key])
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
        # one kernel, counted forward and backward apart
        "dropout": ("training_gpt_dropout", gdr["launches"], gdr["steps"]),
        mt_ops.ADAM_KERNEL + mt_ops.SR_SUFFIX: ("training_gpt_bf16",
                                                gsr["launches"],
                                                gsr["steps"]),
    }
    for k in (segmented.SEGMENT_SR_KERNEL, mt_ops.LAMB_STAGE1_BF16_KERNEL,
              mt_ops.LAMB_STAGE2_KERNEL + mt_ops.SR_SUFFIX):
        paths[k] = ("training_bert_bf16", bsr["launches"], bsr["steps"])
    for k in _flash_names(torch.float32) + (attention.SPLIT_KERNEL,):
        paths[k] = ("training_gpt_fp32", f32["launches"], f32["steps"])
    for k in _flash_names(torch.float16) + _ln_names(torch.float16):
        paths[k] = ("training_gpt_fp16_flash", f16["flash"]["launches"],
                    f16["flash"]["steps"])
    for base in (softmax.CAUSAL_KERNEL, softmax.BWD_KERNEL):
        paths[softmax.kernel_name(base, torch.float16)] = (
            "training_gpt_fp16_softmax", f16["softmax"]["launches"],
            f16["softmax"]["steps"])
    for base in (softmax.SCALED_KERNEL, softmax.MASKED_KERNEL):
        paths[softmax.kernel_name(base, torch.float16)] = (
            "fp16_dispatcher", f16["dispatcher"]["launches"], 1)
    paths[engine.LEAF_SUM_KERNEL] = ("training_novograd", novo["launches"],
                                     novo["steps"])
    # the SR kernels that no model path here runs: one call each, the
    # counts set to 0 just before; the probes: their own run
    for label, rows_ in (("phase12a_direct", srk), ("phase14e_probes", prb)):
        for row in rows_:
            direct = row.pop("direct_launches", None)
            if direct is not None:
                paths.setdefault(row["name"], (label, direct, 1))

    def launched(counts: dict, name: str) -> int:
        # dropout.cu is one kernel, counted forward and backward apart
        if name == drow["name"]:
            return sum(counts.get(c_, 0) for c_ in DROPOUT_COUNTERS)
        return counts.get(name, 0)

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
        k["launches"] = launched(launches, name)
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
                         ("xentropy", xent), ("gpt_dropout", gdr),
                         ("bert_dropout_softmax", bdr["softmax"]),
                         ("bert_dropout_flash", bdr["flash"]),
                         ("serving_sampled", ssv), ("bert_bf16", bsr),
                         ("gpt_bf16", gsr),
                         ("mha_self_future", mha["self_future"]),
                         ("mha_self_key_padding", mha["self_key_padding"]),
                         ("mha_encdec_key_padding",
                          mha["encdec_key_padding"]),
                         ("zigzag", zz), ("gpt_fp32", f32),
                         ("gpt_fp16_flash", f16["flash"]),
                         ("gpt_fp16_softmax", f16["softmax"]),
                         *((f"mha_{d_}_{k_}", mha16[d_][k_])
                           for d_ in mha16 for k_ in (
                               "self_future", "self_key_padding",
                               "encdec_key_padding"))):
            k[f"launches_{key}"] = launched(run["launches"], name)
        check(k["launches"] > 0, f"{name}: no launch on its path")
    for counter in DROPOUT_COUNTERS:
        drow[f"launches_{counter}"] = gdr["launches"].get(counter, 0)

    check(len(kernels) == 57, f"{len(kernels)} kernels in the line, not 57")
    print("phase 15: kernels")
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
                       "training_gpt_dropout": gdr,
                       "training_bert_dropout": bdr,
                       "serving_sampled": ssv, "training_bert_bf16": bsr,
                       "training_gpt_bf16": gsr,
                       "flash_extra": {k_: fx[k_] for k_ in (
                           "bias_dropout_probe", "position_tiles", "dbias")},
                       "multihead_attn": mha, "zigzag": zz,
                       "training_gpt_fp32": f32, "training_gpt_fp16": f16,
                       "multihead_attn_dtypes": mha16,
                       "phase14_kernels": {"d96": dk14["d96"],
                                           "rope": dk14["rope"]},
                       "flash_report": bwr,
                       **line}, f, indent=1)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
