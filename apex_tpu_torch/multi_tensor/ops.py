"""Fused multi-tensor ops over flat buffers.

Counterpart of ``apex_tpu/multi_tensor/ops.py``. Every functor of the
reference is ported, each a kernel on CUDA buffers and plain PyTorch on
CPU buffers:

- ``multi_tensor_scale`` and ``multi_tensor_axpby`` (``csrc/scale_axpby.cu``:
  fp32, bf16 or fp16 in and out);
- the Adam / AdamW update (``csrc/fused_adam.cu``);
- Adagrad (``fused_adagrad_update``) and NovoGrad
  (``fused_novograd_update``: the per-tensor norms over
  ``csrc/sumsq.cu``, then the NovoGrad sweep), both in
  ``csrc/adagrad_novograd.cu``;
- the L2 norms (``per_tensor_l2norm``, ``multi_tensor_l2norm``,
  ``fused_unscale_l2norm``) over the sum-of-squares kernels
  (``csrc/sumsq.cu``), finished in plain PyTorch as the reference
  finishes them in XLA;
- LAMB: stage 1 (``fused_lamb_compute_update_term``) and stage 2 of
  ``fused_lamb_update`` (``csrc/fused_lamb.cu``), and the trust ratio;
- SGD (``fused_sgd_update``) and LARS (``fused_lars_update``: the
  per-tensor norms over ``csrc/sumsq.cu``, then the LARS sweep), both in
  ``csrc/fused_sgd.cu``.

A bf16 master with stochastic rounding: every update takes ``sr_seed``
(the reference's), and with it p (and p') are bf16: the kernels read p
as bf16, do the fp32 arithmetic as before and write p' through the
threefry stream of ``fold_in(PRNGKey(sr_seed), 0)`` over the element
index (``csrc/sr_common.cuh``; the key's words computed on the host),
bitwise the plain path's ``stochastic_round_cast``. The slots (m, v, h,
momentum) stay fp32, as in the reference. LAMB's stage 1 and the norms
(``per_tensor_l2norm``, the sum-of-squares kernel) read a bf16 p.

Scalars that come from the device (a clip factor from a device norm,
the trust ratios) stay on the device: the kernels read them through a
pointer, so a step never waits on a host read of them. Where the
reference aliases LAMB's gradient buffer to the update term u, the port
writes u into a buffer of its own and leaves the caller's gradient as
it was (the same bytes move).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch import _build
from apex_tpu_torch._backend import check_kernel_input, uses_kernel
from apex_tpu_torch.multi_tensor.engine import (
    LANES,
    PER_TENSOR_TILE_ROWS,
    fused_elementwise,
    fused_sumsq_partials,
    kernel_scalar,
    leaf_sums,
    register_kernel,
    scalar_pointer,
    sqrt_rn,
    sr_round_bits,
)
from apex_tpu_torch.random import M32, threefry2x32
from apex_tpu_torch.multi_tensor.flat_buffer import FlatSpace

SCALE_KERNEL = "multi_tensor_scale"
AXPBY_KERNEL = "multi_tensor_axpby"
ADAM_KERNEL = "fused_adam"
ADAGRAD_KERNEL = "fused_adagrad"
NOVOGRAD_KERNEL = "fused_novograd"
LAMB_STAGE1_KERNEL = "lamb_stage1"
LAMB_STAGE2_KERNEL = "lamb_stage2"
SGD_KERNEL = "fused_sgd"
LARS_KERNEL = "fused_lars"
# the bf16-master variants, counted apart: p' written with stochastic
# rounding (``<kernel>_sr``), and LAMB stage 1 reading a bf16 p
SR_SUFFIX = "_sr"
LAMB_STAGE1_BF16_KERNEL = "lamb_stage1_bf16"
# the leaf streams stage 2's segment list keys in shared memory
# (csrc/fused_lamb.cu kMaxStreams)
STAGE2_MAX_STREAMS = 6144


def _sr(sr_seed) -> dict:
    """The engine's stochastic-rounding arguments for output 0 (p')."""
    if sr_seed is None:
        return {}
    return {"sr_outputs": (0,), "sr_seed": sr_seed}


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _dev_f32(x, device) -> torch.Tensor:
    """``x`` as a 0-d fp32 tensor on ``device`` (a device tensor stays
    where it is: no host read). Arithmetic between two such tensors
    rounds as the reference's fp32 scalar arithmetic does; a CUDA
    tensor divided by a Python number would be multiplied by its
    reciprocal instead. A host number becomes a fill on the device's
    stream (``torch.tensor(..., device=cuda)`` would copy it from the
    host and wait for the stream)."""
    if isinstance(x, torch.Tensor) and x.device == torch.device(device):
        return x.reshape(()).to(torch.float32)
    return torch.full((), float(np.float32(float(x))), dtype=torch.float32,
                      device=device)


def _inv_scale(grad_scale, device) -> torch.Tensor:
    """``1 / grad_scale`` in fp32, as the reference computes it: a 0-d
    tensor on ``device`` for a device scale (no host read), else a 0-d
    CPU tensor."""
    if isinstance(grad_scale, torch.Tensor):
        return 1.0 / _dev_f32(grad_scale, device)
    return 1.0 / _f32(grad_scale)


def _host_scalars(name, scalars, allowed_device=()) -> None:
    for i, s in enumerate(scalars):
        if isinstance(s, torch.Tensor) and i not in allowed_device:
            raise NotImplementedError(
                f"{name}: scalar {i} lives on the device; the kernel takes "
                "it by value (only the scales it reads by pointer may)")


def _p_dtypes(sr) -> Tuple[torch.dtype, ...]:
    """The parameter dtype a functor kernel takes: bf16 when it writes p'
    with stochastic rounding (``sr`` the key words), else fp32."""
    return (torch.bfloat16,) if sr is not None else (torch.float32,)


def _sr_args(sr) -> Tuple[int, int, int]:
    """``(p_bf16, k0, k1)`` of a launcher: a bf16 p and the key of its
    stochastic rounding, or fp32 and no key."""
    return (0, 0, 0) if sr is None else (1, *sr)


def sr_variant(kernel: str, sr) -> str:
    """The counter of ``kernel``'s launch: its own, or with ``sr`` (the
    key words of a bf16 p' written with stochastic rounding) its SR
    variant's."""
    return kernel if sr is None else kernel + SR_SUFFIX


def _no_sr(kernel: str, sr) -> None:
    if sr is not None:
        raise NotImplementedError(
            f"{kernel}: the reference writes this functor's outputs without "
            "stochastic rounding, and so does its kernel")


def _launch_error(lib, fn_name: str, kernel: str, err: int) -> None:
    if err:
        msg = getattr(lib, fn_name)(err).decode()
        raise RuntimeError(f"{kernel}: CUDA error {err} at launch: {msg}")


# ---------------------------------------------------------------------------
# scale / axpby (the reference's :36-71; ref csrc/multi_tensor_scale_kernel.cu,
# multi_tensor_axpby_kernel.cu)
# ---------------------------------------------------------------------------

# the kernels' dtype codes (csrc/scale_axpby.cu)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _scale_fn(ins: Sequence[torch.Tensor], s: Sequence[torch.Tensor], _
              ) -> List[torch.Tensor]:
    """The reference's scale functor (:45-46): x in fp32 times the
    scale."""
    return [ins[0].float() * s[0]]


def _axpby_fn(ins: Sequence[torch.Tensor], s: Sequence[torch.Tensor], _
              ) -> List[torch.Tensor]:
    """The reference's axpby functor (:64-65): x * a + y * b in fp32, one
    elementwise op at a time."""
    return [ins[0].float() * s[0] + ins[1].float() * s[1]]


def _scale_axpby_launch(fn_name: str, kernel: str, argtypes, names, bufs,
                        found, *args) -> None:
    """Check ``bufs`` (fp32, bf16 or fp16 on one device), then launch
    ``fn_name`` of ``csrc/scale_axpby.cu`` with their pointers, ``found``,
    the length, their dtype codes and ``args``."""
    dev = bufs[0].device
    for name, t in zip(names, bufs):
        check_kernel_input(name, t, tuple(_DTYPE_CODES), dev)
    lib = _build.library("scale_axpby", fn_name, argtypes,
                         "apex_scale_axpby_error_string")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fn_name)(
            *(t.data_ptr() for t in bufs), found.data_ptr(), bufs[0].numel(),
            *(_DTYPE_CODES[t.dtype] for t in bufs), *args, stream)
    _launch_error(lib, "apex_scale_axpby_error_string", kernel, err)
    _build.count_launch(kernel)


def _scale_kernel(inputs, outputs, scalars, found, check_finite, per_tensor,
                  tile_ids, sumsq, sr) -> None:
    """Launch ``csrc/scale_axpby.cu`` ``apex_scale`` for :func:`_scale_fn`.
    The kernel sets ``found`` over its output after the cast
    (:func:`multi_tensor_scale`'s convention), so it takes no input
    check; the scale may live on the device."""
    if check_finite or per_tensor or tile_ids is not None or sumsq:
        raise NotImplementedError(
            "the scale kernel flags its outputs and takes no input check, "
            f"per-tensor scalars or sumsq partials; got check_finite="
            f"{check_finite}")
    _no_sr(SCALE_KERNEL, sr)
    val, ptr = scalar_pointer(scalars[0])
    P, L, F, I = _build.P, _build.L, _build.F, _build.I
    _scale_axpby_launch(
        "apex_scale", SCALE_KERNEL, (P, P, P, L, I, I, F, P, P),
        ("x", "out"), [inputs[0], outputs[0]], found, val, ptr)


def _axpby_kernel(inputs, outputs, scalars, found, check_finite, per_tensor,
                  tile_ids, sumsq, sr) -> None:
    """Launch ``csrc/scale_axpby.cu`` ``apex_axpby`` for
    :func:`_axpby_fn`: ``found`` over x, y or both; a and b may live on
    the device."""
    if not set(check_finite) <= {0, 1} or per_tensor \
            or tile_ids is not None or sumsq:
        raise NotImplementedError(
            "the axpby kernel checks x (input 0) and/or y (input 1) and "
            "takes no per-tensor scalars or sumsq partials; got "
            f"check_finite={check_finite}")
    _no_sr(AXPBY_KERNEL, sr)
    (a, a_ptr), (b, b_ptr) = (scalar_pointer(s) for s in scalars)
    P, L, F, I = _build.P, _build.L, _build.F, _build.I
    _scale_axpby_launch(
        "apex_axpby", AXPBY_KERNEL, (P, P, P, P, L, I, I, I, F, F, P, P, I, I,
                                     P),
        ("x", "y", "out"), [*inputs, outputs[0]], found, a, b, a_ptr, b_ptr,
        int(0 in check_finite), int(1 in check_finite))


register_kernel(_scale_fn, _scale_kernel)
register_kernel(_axpby_fn, _axpby_kernel)


def multi_tensor_scale(x, scale, *, out_dtype=None, in_place=False,
                       plain=False) -> Tuple[torch.Tensor, torch.Tensor]:
    """``out = x * scale`` in fp32, cast to ``out_dtype`` (default x's;
    each of fp32, bf16 and fp16 in and out), and ``found_inf`` over the
    outputs after the cast: a finite x whose scaled value overflows the
    output dtype counts, as in the reference (:50-51). On CUDA the
    kernel ``multi_tensor_scale`` sets the flag in the same sweep; the
    plain version checks the output afterwards, as the reference does.
    ``scale`` may be a 0-d tensor on the card (the kernel reads it by
    pointer). With ``in_place`` the result is written into x (same
    dtype). ``plain=True`` runs the plain version on any device.
    Returns ``(out, found_inf)``."""
    kernel = not plain and uses_kernel(x)
    (out,), found = fused_elementwise(
        _scale_fn, [x], scalars=[scale], out_dtypes=[out_dtype or x.dtype],
        aliases={0: 0} if in_place else None, kernel=kernel)
    if not kernel:
        found = (~torch.isfinite(out).all()).to(torch.float32)
    return out, found


def multi_tensor_axpby(x, y, a, b, *, arg_to_check=-1, out_dtype=None,
                       in_place=False, plain=False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``out = x * a + y * b`` in fp32, cast to ``out_dtype`` (default
    x's), with ``found_inf`` over x and y (``arg_to_check=-1``), x alone
    (0) or y alone (1), as the reference's (:55-71; the amp scaler's
    gradient accumulation). ``a`` and ``b`` may be 0-d tensors on the
    card. With ``in_place`` the result is written into x (same dtype).
    ``plain=True`` runs the plain version on any device (kernel
    ``multi_tensor_axpby`` on CUDA). Returns ``(out, found_inf)``."""
    if arg_to_check not in (-1, 0, 1):
        raise ValueError(f"arg_to_check must be -1, 0 or 1, got "
                         f"{arg_to_check}")
    (out,), found = fused_elementwise(
        _axpby_fn, [x, y], scalars=[a, b], out_dtypes=[out_dtype or x.dtype],
        check_finite={-1: (0, 1), 0: (0,), 1: (1,)}[arg_to_check],
        aliases={0: 0} if in_place else None,
        kernel=False if plain else None)
    return out, found


# ---------------------------------------------------------------------------
# Adam (the reference's :140-185; ref csrc/multi_tensor_adam.cu)
# ---------------------------------------------------------------------------


def _adam_fn(ins: Sequence[torch.Tensor], s: Sequence[torch.Tensor], _
             ) -> List[torch.Tensor]:
    """The reference's Adam functor (``fused_adam_update`` :161-173),
    one elementwise op at a time on fp32 0-d scalars."""
    p_, m_, v_, g_ = [x.float() for x in ins]
    lr_, b1, b2, eps_, wd, bc1_, bc2_, mode_, inv_scale = s
    g_ = g_ * inv_scale
    g_l2 = g_ + wd * p_
    g_eff = torch.where(mode_ > 0.5, g_, g_l2)
    m2 = b1 * m_ + (1.0 - b1) * g_eff
    v2 = b2 * v_ + (1.0 - b2) * g_eff * g_eff
    mhat = m2 / bc1_
    vhat = v2 / bc2_
    upd = mhat / (sqrt_rn(vhat) + eps_)
    upd = upd + torch.where(mode_ > 0.5, wd * p_, 0.0)
    return [p_ - lr_ * upd, m2, v2]


def _adam_kernel(inputs, outputs, scalars, found, check_finite, per_tensor,
                 tile_ids, sumsq, sr) -> None:
    """Launch ``csrc/fused_adam.cu`` for :func:`_adam_fn` (p and p' bf16
    with stochastic rounding when ``sr`` holds its key words)."""
    if check_finite != (3,):
        raise NotImplementedError(
            f"the Adam kernel checks the gradient (input 3) for "
            f"non-finite values; check_finite={check_finite} is not built")
    if per_tensor or tile_ids is not None or sumsq:
        raise NotImplementedError(
            "the Adam kernel takes no per-tensor scalars or sumsq partials")
    _host_scalars(ADAM_KERNEL, scalars, allowed_device=(8,))
    dev = inputs[0].device
    for name, t in zip(("p", "m", "v", "g", "p_out", "m_out", "v_out"),
                       (*inputs, *outputs)):
        check_kernel_input(name, t, _p_dtypes(sr) if name[0] == "p"
                           else (torch.float32,), dev)
    lr, b1, b2, eps, wd, bc1, bc2, mode = scalars[:8]
    inv_val, inv_ptr = scalar_pointer(scalars[8])
    P, L, F, I, U = _build.P, _build.L, _build.F, _build.I, _build.U
    lib = _build.library("fused_adam", "apex_adam",
                         (P,) * 8 + (L,) + (F,) * 8 + (P, I, I, U, U, P),
                         "apex_adam_error_string")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.apex_adam(*(t.data_ptr() for t in (*inputs, *outputs)),
                            found.data_ptr(), inputs[0].numel(), lr, b1, b2,
                            eps, wd, bc1, bc2, inv_val, inv_ptr,
                            int(mode > 0.5), *_sr_args(sr), stream)
    _launch_error(lib, "apex_adam_error_string", ADAM_KERNEL, err)
    _build.count_launch(sr_variant(ADAM_KERNEL, sr))


register_kernel(_adam_fn, _adam_kernel)


def fused_adam_update(
    p, m, v, g, *,
    lr, beta1=0.9, beta2=0.999, eps=1e-8, step=1,
    adam_w_mode=True, bias_correction=True, weight_decay=0.0,
    grad_scale=1.0, in_place=True, plain=False, sr_seed=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused Adam/AdamW step over flat fp32 buffers (p bf16 with
    ``sr_seed``: p' written with stochastic rounding).

    ``adam_w_mode`` selects decoupled weight decay (AdamW) against L2
    regularisation; ``grad_scale`` divides the gradient inside the same
    sweep (a 0-d tensor on the card stays there: the kernel reads its
    reciprocal through a pointer). The bias corrections are computed in
    fp32 as the reference
    computes them (:153-158). With ``in_place`` (the default, the
    reference's aliasing) p, m and v are overwritten and returned; with
    ``in_place=False`` they are left as they were and the results are
    new buffers. ``plain=True`` runs the plain version on any device
    (the kernel's yardstick on the card). Returns ``(p', m', v',
    found_inf)``, ``found_inf`` covering the raw gradients."""
    step_t = _f32(float(step))
    bc1 = 1.0 - torch.pow(_f32(beta1), step_t)
    bc2 = 1.0 - torch.pow(_f32(beta2), step_t)
    if not bias_correction:
        bc1 = bc2 = _f32(1.0)
    mode = 1.0 if adam_w_mode else 0.0
    inv_scale = _inv_scale(grad_scale, g.device)
    (p2, m2, v2), found = fused_elementwise(
        _adam_fn, [p, m, v, g],
        scalars=[lr, beta1, beta2, eps, weight_decay, bc1, bc2, mode,
                 inv_scale],
        num_outputs=3, out_dtypes=[p.dtype, m.dtype, v.dtype],
        check_finite=(3,),
        aliases={0: 0, 1: 1, 2: 2} if in_place else None,
        kernel=False if plain else None, **_sr(sr_seed))
    return p2, m2, v2, found


# ---------------------------------------------------------------------------
# Adagrad (the reference's :192-217; ref csrc/multi_tensor_adagrad.cu)
# ---------------------------------------------------------------------------


def _adagrad_fn(ins: Sequence[torch.Tensor], s: Sequence[torch.Tensor], _
                ) -> List[torch.Tensor]:
    """The reference's Adagrad functor (:201-206), one elementwise op at
    a time on fp32 0-d scalars; the division stays a division."""
    p_, h_, g_ = [x.float() for x in ins]
    lr_, eps_, wd, inv_scale = s
    g_ = g_ * inv_scale + wd * p_
    h2 = h_ + g_ * g_
    return [p_ - lr_ * g_ / (sqrt_rn(h2) + eps_), h2]


def _adagrad_family_launch(fn_name: str, kernel: str, argtypes, names,
                           inputs, outputs, found, sr, *args) -> None:
    """Check the three inputs and two outputs (fp32; p and p' bf16 with
    stochastic rounding), then launch ``fn_name`` of
    ``csrc/adagrad_novograd.cu`` with ``args`` and the SR arguments after
    the buffers and ``found``, on the buffers' current stream."""
    dev = inputs[0].device
    for name, t in zip(names, (*inputs, *outputs)):
        check_kernel_input(name, t, _p_dtypes(sr) if name[0] == "p"
                           else (torch.float32,), dev)
    argtypes = tuple(argtypes[:-1]) + (_build.I, _build.U, _build.U,
                                       argtypes[-1])
    args = (*args, *_sr_args(sr))
    lib = _build.library("adagrad_novograd", fn_name, argtypes,
                         "apex_adagrad_novograd_error_string")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fn_name)(
            *(t.data_ptr() for t in (*inputs, *outputs)), found.data_ptr(),
            *args, stream)
    _launch_error(lib, "apex_adagrad_novograd_error_string", kernel, err)
    _build.count_launch(sr_variant(kernel, sr))


def _adagrad_kernel(inputs, outputs, scalars, found, check_finite,
                    per_tensor, tile_ids, sumsq, sr) -> None:
    """Launch ``csrc/adagrad_novograd.cu`` ``apex_adagrad`` for
    :func:`_adagrad_fn`: the gradient's multiplier (scalar 3, 1 /
    grad_scale) may live on the device."""
    if check_finite != (2,) or per_tensor or tile_ids is not None or sumsq:
        raise NotImplementedError(
            "the Adagrad kernel checks g (input 2) for non-finite values "
            "and takes no per-tensor scalars or sumsq partials; got "
            f"check_finite={check_finite}")
    _host_scalars(ADAGRAD_KERNEL, scalars, allowed_device=(3,))
    lr, eps, wd, _ = scalars
    inv_val, inv_ptr = scalar_pointer(scalars[3])
    P, L, F = _build.P, _build.L, _build.F
    _adagrad_family_launch(
        "apex_adagrad", ADAGRAD_KERNEL, (P,) * 6 + (L,) + (F,) * 4 + (P, P),
        ("p", "h", "g", "p_out", "h_out"), inputs, outputs, found, sr,
        inputs[0].numel(), lr, eps, wd, inv_val, inv_ptr)


register_kernel(_adagrad_fn, _adagrad_kernel)


def fused_adagrad_update(
    p, h, g, *, lr, eps=1e-10, weight_decay=0.0, grad_scale=1.0,
    in_place=True, plain=False, sr_seed=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused Adagrad step over flat fp32 buffers (kernel
    ``fused_adagrad``; p bf16 with ``sr_seed``), L2-mode weight decay (the reference's
    ADAGRAD_MODE_0): ``h += g'^2; p -= lr * g' / (sqrt(h) + eps)`` with
    ``g' = g / grad_scale + wd * p``. The reciprocal of ``grad_scale`` is
    taken in fp32 as the reference takes it (:208); a 0-d tensor on the
    card stays there and the kernel reads its reciprocal by pointer.
    With ``in_place`` p and h are overwritten; else new buffers are
    returned and the inputs left as they were. ``plain=True`` runs the
    plain version on any device. Returns ``(p', h', found_inf)``,
    ``found_inf`` covering g."""
    (p2, h2), found = fused_elementwise(
        _adagrad_fn, [p, h, g],
        scalars=[lr, eps, weight_decay, _inv_scale(grad_scale, g.device)],
        num_outputs=2, out_dtypes=[p.dtype, h.dtype], check_finite=(2,),
        aliases={0: 0, 1: 1} if in_place else None,
        kernel=False if plain else None, **_sr(sr_seed))
    return p2, h2, found


# ---------------------------------------------------------------------------
# SGD (the reference's :220-243; ref csrc/multi_tensor_sgd_kernel.cu)
# ---------------------------------------------------------------------------


def _sgd_fn(ins: Sequence[torch.Tensor], s: Sequence[torch.Tensor], _
            ) -> List[torch.Tensor]:
    """The reference's SGD functor (:233-243), one elementwise op at a
    time on fp32 0-d scalars."""
    p_, mom_, g_ = [x.float() for x in ins]
    lr_, mu, damp, wd, scale_, first, nest, wd_after = s
    g_ = g_ * scale_
    g_ = torch.where(wd_after > 0.5, g_, g_ + wd * p_)
    mom2 = torch.where(first > 0.5, g_, mu * mom_ + (1.0 - damp) * g_)
    upd = torch.where(nest > 0.5, g_ + mu * mom2, mom2)
    upd = torch.where(mu == 0.0, g_, upd)
    mom2 = torch.where(mu == 0.0, mom_, mom2)
    upd = torch.where(wd_after > 0.5, upd + wd * p_, upd)
    return [p_ - lr_ * upd, mom2]


def _launch_sgd_family(fn_name: str, kernel: str, argtypes, inputs, outputs,
                       found, sr, *args) -> None:
    """Check the three inputs and two outputs (fp32; p and p' bf16 with
    stochastic rounding), then launch ``fn_name`` of ``csrc/fused_sgd.cu``
    with ``args`` and the SR arguments after the buffers and ``found``,
    on the buffers' current stream."""
    dev = inputs[0].device
    for name, t in zip(("p", "mom", "g", "p_out", "mom_out"),
                       (*inputs, *outputs)):
        check_kernel_input(name, t, _p_dtypes(sr) if name[0] == "p"
                           else (torch.float32,), dev)
    argtypes = tuple(argtypes[:-1]) + (_build.I, _build.U, _build.U,
                                       argtypes[-1])
    args = (*args, *_sr_args(sr))
    lib = _build.library("fused_sgd", fn_name, argtypes,
                         "apex_sgd_error_string")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fn_name)(
            *(t.data_ptr() for t in (*inputs, *outputs)), found.data_ptr(),
            *args, stream)
    _launch_error(lib, "apex_sgd_error_string", kernel, err)
    _build.count_launch(sr_variant(kernel, sr))


def _sgd_kernel(inputs, outputs, scalars, found, check_finite, per_tensor,
                tile_ids, sumsq, sr) -> None:
    """Launch ``csrc/fused_sgd.cu`` ``apex_sgd`` for :func:`_sgd_fn`: the
    scale (scalar 4) and the first-run flag (scalar 5) may live on the
    device."""
    if check_finite != (2,) or per_tensor or tile_ids is not None or sumsq:
        raise NotImplementedError(
            "the SGD kernel checks g (input 2) for non-finite values and "
            "takes no per-tensor scalars or sumsq partials; got "
            f"check_finite={check_finite}")
    _host_scalars(SGD_KERNEL, scalars, allowed_device=(4, 5))
    lr, mu, damp, wd, _, _, nest, wd_after = scalars
    scale_val, scale_ptr = scalar_pointer(scalars[4])
    first_val, first_ptr = scalar_pointer(scalars[5])
    P, L, F, I = _build.P, _build.L, _build.F, _build.I
    _launch_sgd_family(
        "apex_sgd", SGD_KERNEL, (P,) * 6 + (L,) + (F,) * 5 + (P, I, P, I, I, P),
        inputs, outputs, found, sr, inputs[0].numel(), lr, mu, damp, wd,
        scale_val, scale_ptr, int(first_val > 0.5), first_ptr,
        int(nest > 0.5), int(wd_after > 0.5))


register_kernel(_sgd_fn, _sgd_kernel)


def fused_sgd_update(
    p, mom, g, *,
    lr, momentum=0.0, dampening=0.0, nesterov=False, weight_decay=0.0,
    wd_after_momentum=False, scale=1.0, first_run=False, in_place=True,
    plain=False, sr_seed=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One fused SGD step over flat fp32 buffers (kernel ``fused_sgd``; p
    bf16 with ``sr_seed``):
    momentum, dampening, nesterov and the weight-decay order as the
    reference has them. ``scale`` multiplies the gradient (a 0-d tensor
    on the card stays there). ``first_run`` (a bool, or a 0-d tensor
    that the kernel reads on the device) seeds the momentum buffer with
    the gradient, the reference's first-iteration branch. With
    ``in_place`` p and mom are overwritten; else new buffers are
    returned and the inputs left as they were. ``plain=True`` runs the
    plain version on any device. Returns ``(p', mom', found_inf)``,
    ``found_inf`` covering g."""
    if isinstance(first_run, torch.Tensor):
        first = first_run
    else:
        first = 1.0 if first_run else 0.0
    (p2, mom2), found = fused_elementwise(
        _sgd_fn, [p, mom, g],
        scalars=[lr, momentum, dampening, weight_decay, scale, first,
                 1.0 if nesterov else 0.0,
                 1.0 if wd_after_momentum else 0.0],
        num_outputs=2, out_dtypes=[p.dtype, mom.dtype], check_finite=(2,),
        aliases={0: 0, 1: 1} if in_place else None,
        kernel=False if plain else None, **_sr(sr_seed))
    return p2, mom2, found


# ---------------------------------------------------------------------------
# L2 norms (the reference's :74-132)
# ---------------------------------------------------------------------------

_PT_TILE = PER_TENSOR_TILE_ROWS * LANES


def _leaf_norms(leaf_sq: torch.Tensor, norms=None) -> torch.Tensor:
    """L2 norms from per-leaf sums of squares: over the ranks a sharded
    state spans when ``norms`` (a ``parallel.sharded_norms.ShardedNorms``)
    is given."""
    return sqrt_rn(leaf_sq) if norms is None else norms.leaf_norms(leaf_sq)


def _norms_from_subtile_partials(partials: torch.Tensor, space: FlatSpace,
                                 plain: bool = False, norms=None
                                 ) -> torch.Tensor:
    """(num_leaves,) L2 norms from per-subtile sum-of-squares partials
    (the engine's ``sumsq_subtiles`` outputs): a lane sum, then a sum by
    leaf in a fixed order (``leaf_sums``) — every leaf is aligned to the
    subtile, so nothing re-reads the buffer. ``norms``: a sharded
    state's rule (:func:`_leaf_norms`)."""
    return _leaf_norms(leaf_sums(partials.sum(-1).reshape(-1), space,
                                 plain=plain), norms)


def per_tensor_l2norm(buf: torch.Tensor, space: FlatSpace, *,
                      plain: bool = False, norms=None) -> torch.Tensor:
    """(num_leaves,) L2 norms of each tensor in the flat buffer: per-
    subtile partials (kernel ``sumsq``) and a sum by leaf in a fixed order
    (kernel ``leaf_sum``); with ``norms``, of the whole leaves a sharded
    state holds parts of."""
    partials = fused_sumsq_partials(buf, PER_TENSOR_TILE_ROWS, plain=plain)
    return _leaf_norms(leaf_sums(partials, space, plain=plain), norms)


def multi_tensor_l2norm(buf: torch.Tensor, space: Optional[FlatSpace] = None,
                        *, per_tensor: bool = False, plain: bool = False):
    """Global L2 norm of a flat buffer, and the per-tensor norms with
    ``per_tensor=True`` (else None)."""
    if per_tensor:
        if space is None:
            raise ValueError("per_tensor=True requires a FlatSpace")
        pt = per_tensor_l2norm(buf, space, plain=plain)
        return sqrt_rn(torch.sum(pt * pt)), pt
    partials = fused_sumsq_partials(buf, plain=plain)
    return sqrt_rn(torch.sum(partials)), None


def fused_unscale_l2norm(g: torch.Tensor, *, inv_scale=1.0,
                         plain: bool = False):
    """Global L2 norm of ``inv_scale * g`` and ``found_inf`` in one read
    of ``g`` (kernel ``sumsq_scaled``): ``found_inf`` is 1 when the
    total is not finite (a non-finite gradient, or a square that
    overflows). Returns ``(norm, found_inf)``, both 0-d fp32 on ``g``'s
    device."""
    partials = fused_sumsq_partials(g, scale=inv_scale, plain=plain)
    total = torch.sum(partials)
    found = (~torch.isfinite(total)).to(torch.float32)
    return sqrt_rn(total), found


# ---------------------------------------------------------------------------
# LAMB (the reference's :265-411; ref csrc/multi_tensor_lamb.cu)
# ---------------------------------------------------------------------------


def _lamb_stage1_fn(ins: Sequence[torch.Tensor], s: Sequence[torch.Tensor], _
                    ) -> List[torch.Tensor]:
    """The reference's stage-1 functor (:300-309), one elementwise op at
    a time on fp32 0-d scalars. The gradient is DIVIDED by ``inv``
    (clip x grad_scale)."""
    p_, m_, v_, g_ = [x.float() for x in ins]
    b1_, b2_, beta3_, eps_, wd, bc1_, bc2_, mode_, inv = s
    g_ = g_ / inv
    g_eff = torch.where(mode_ > 0.5, g_, g_ + wd * p_)
    m2 = b1_ * m_ + beta3_ * g_eff
    v2 = b2_ * v_ + (1.0 - b2_) * g_eff * g_eff
    upd = (m2 / bc1_) / (sqrt_rn(v2 / bc2_) + eps_)
    upd = upd + torch.where(mode_ > 0.5, wd * p_, 0.0)
    return [upd, m2, v2]


def _lamb_stage2_fn(ins: Sequence[torch.Tensor], s: Sequence[torch.Tensor],
                    t: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The reference's stage-2 functor (:395-399): p - lr * ratio * u."""
    p_, u_ = [x.float() for x in ins]
    (lr_,) = s
    (r_,) = t
    return [p_ - lr_ * r_ * u_]


_STAGE1_SUMSQ = ((), (("in", 0), ("out", 0)),
                 (("in", 0), ("out", 0), ("in", 3)))


def _lamb_stage1_kernel(inputs, outputs, scalars, found, check_finite,
                        per_tensor, tile_ids, sumsq, sr) -> None:
    """Launch ``csrc/fused_lamb.cu`` stage 1 for :func:`_lamb_stage1_fn`
    (p fp32 or bf16)."""
    kinds = tuple((k, i) for k, i, _ in sumsq)
    if check_finite != (3,) or per_tensor or tile_ids is not None \
            or kinds not in _STAGE1_SUMSQ:
        raise NotImplementedError(
            "the LAMB stage-1 kernel checks g (input 3), takes no per-"
            "tensor scalars, and emits the partials of p, u and "
            f"optionally g; got check_finite={check_finite}, "
            f"sumsq_subtiles={kinds}")
    _no_sr(LAMB_STAGE1_KERNEL, sr)
    _host_scalars(LAMB_STAGE1_KERNEL, scalars, allowed_device=(8,))
    dev = inputs[0].device
    _check_stage1(inputs, outputs, dev)
    parts = [b.data_ptr() for _, _, b in sumsq] + [None] * (3 - len(sumsq))
    inv_val, inv_ptr = scalar_pointer(scalars[8])
    _stage1_launch(inputs, outputs, found, parts, scalars[:8], inv_val,
                   inv_ptr)


def _check_stage1(inputs, outputs, dev) -> None:
    """Stage 1's buffers: p fp32 or bf16, everything else fp32."""
    for name, t in zip(("p", "m", "v", "g", "u", "m_out", "v_out"),
                       (*inputs, *outputs)):
        check_kernel_input(name, t, (torch.float32, torch.bfloat16)
                           if name == "p" else (torch.float32,), dev)


def _stage1_launch(inputs, outputs, found, parts, scalars, inv_val, inv_ptr,
                   segs=None, seg_elems=0) -> None:
    b1, b2, beta3, eps, wd, bc1, bc2, mode = scalars
    P, L, F, I = _build.P, _build.L, _build.F, _build.I
    lib = _build.library("fused_lamb", "apex_lamb_stage1",
                         (P,) * 11 + (L,) + (F,) * 8 + (P, I, P, L, L, I, P),
                         "apex_lamb_error_string")
    dev = inputs[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.apex_lamb_stage1(
            *(t.data_ptr() for t in (*inputs, *outputs)), found.data_ptr(),
            *parts, inputs[0].numel(), b1, b2, beta3, eps, wd, bc1, bc2,
            inv_val, inv_ptr, int(mode > 0.5),
            None if segs is None else segs.data_ptr(),
            0 if segs is None else segs.numel(), seg_elems,
            int(inputs[0].dtype == torch.bfloat16), stream)
    _launch_error(lib, "apex_lamb_error_string", LAMB_STAGE1_KERNEL, err)
    _build.count_launch(LAMB_STAGE1_BF16_KERNEL
                        if inputs[0].dtype == torch.bfloat16
                        else LAMB_STAGE1_KERNEL)


def _lamb_stage2_kernel(inputs, outputs, scalars, found, check_finite,
                        per_tensor, tile_ids, sumsq, sr) -> None:
    """Launch ``csrc/fused_lamb.cu`` stage 2 for :func:`_lamb_stage2_fn`:
    the ratios stay on the device, each subtile reads its leaf's (p and
    p' bf16 with stochastic rounding when ``sr`` holds its key words)."""
    if check_finite or sumsq or len(per_tensor) != 1 or tile_ids is None:
        raise NotImplementedError(
            "the LAMB stage-2 kernel takes one per-tensor ratio through "
            "tile_ids and no finite check or sumsq partials")
    _host_scalars(LAMB_STAGE2_KERNEL, scalars)
    dev = inputs[0].device
    for name, t in zip(("p", "u", "p_out"), (*inputs, *outputs)):
        check_kernel_input(name, t, _p_dtypes(sr) if name[0] == "p"
                           else (torch.float32,), dev)
    (ratio,) = per_tensor
    _stage2_launch(inputs[0], inputs[1], outputs[0], ratio, tile_ids,
                   scalars[0], sr=sr)


def _stage2_launch(p, u, p_out, ratio, tile_ids, lr, segs=None,
                   seg_elems=0, sr=None, seg_streams=None,
                   sr_seed=None) -> None:
    P, L, F, I, U = _build.P, _build.L, _build.F, _build.I, _build.U
    lib = _build.library("fused_lamb", "apex_lamb_stage2",
                         (P, P, P, P, P, L, F, P, L, L, I, U, U, P, P, L, U,
                          P),
                         "apex_lamb_error_string")
    dev = p.device
    p_bf16, k0, k1 = _sr_args(sr)
    rows, leaves = (None, None) if seg_streams is None else seg_streams
    if seg_streams is not None:
        p_bf16 = 1
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.apex_lamb_stage2(
            p.data_ptr(), u.data_ptr(), p_out.data_ptr(), ratio.data_ptr(),
            tile_ids.data_ptr(), p.numel(), lr,
            None if segs is None else segs.data_ptr(),
            0 if segs is None else segs.numel(), seg_elems, p_bf16, k0, k1,
            None if rows is None else rows.data_ptr(),
            None if leaves is None else leaves.data_ptr(),
            0 if leaves is None else leaves.numel(),
            0 if sr_seed is None else int(sr_seed) & M32, stream)
    _launch_error(lib, "apex_lamb_error_string", LAMB_STAGE2_KERNEL, err)
    _build.count_launch(LAMB_STAGE2_KERNEL + (SR_SUFFIX if p_bf16 else ""))


register_kernel(_lamb_stage1_fn, _lamb_stage1_kernel)
register_kernel(_lamb_stage2_fn, _lamb_stage2_kernel)


def lamb_scalars(*, beta1, beta2, step, bias_correction, grad_averaging):
    """``(b1, b2, beta3, bc1, bc2)`` as fp32 0-d CPU tensors, computed as
    the reference computes them (:355-361)."""
    step_t = _f32(float(step))
    b1, b2 = _f32(beta1), _f32(beta2)
    beta3 = 1.0 - b1 if grad_averaging else _f32(1.0)
    one = _f32(1.0)
    bc1 = 1.0 - torch.pow(b1, step_t) if bias_correction else one
    bc2 = 1.0 - torch.pow(b2, step_t) if bias_correction else one
    return b1, b2, beta3, bc1, bc2


def lamb_inv_scale(g: torch.Tensor, *, max_grad_norm, global_grad_norm,
                   grad_scale, plain: bool = False, norms=None):
    """The divisor of stage 1, clip x grad_scale (:362-374): with a clip,
    a 0-d fp32 tensor on ``g``'s device computed from the (device)
    global norm — ``multi_tensor_l2norm(g)`` when none is handed in, or
    the whole model's through ``norms`` on a sharded state — and never
    read on the host; without one, ``grad_scale`` itself."""
    if not (max_grad_norm and max_grad_norm > 0):
        return grad_scale
    dev = g.device
    if global_grad_norm is None and norms is not None:
        global_grad_norm = norms.global_norm(g, plain=plain)
    elif global_grad_norm is None:
        global_grad_norm, _ = multi_tensor_l2norm(g, plain=plain)
    gs = _dev_f32(grad_scale, dev)
    norm = _dev_f32(global_grad_norm, dev) / gs
    clip = torch.maximum(norm / _dev_f32(max_grad_norm, dev),
                         _dev_f32(1.0, dev))
    return clip * gs


def fused_lamb_compute_update_term(
    p, m, v, g, *,
    beta1, beta2, beta3, eps, weight_decay, bias_correction1,
    bias_correction2, adam_w_mode, inv_scale,
    with_norm_partials=False, with_grad_partials=False,
    in_place=True, plain=False,
):
    """LAMB stage 1 (kernel ``lamb_stage1``): the update term u, m' and
    v', and from the same pass the per-subtile partial sums of squares
    of p and u (``with_norm_partials``) and of the raw g
    (``with_grad_partials``). ``inv_scale`` divides g (a 0-d tensor on
    the card stays there). With ``in_place`` m and v are overwritten.
    Returns ``((u, m', v'[, p_part, u_part][, g_part]),
    found_inf)``."""
    mode = 1.0 if adam_w_mode else 0.0
    sumsq = _STAGE1_SUMSQ[2 if with_grad_partials else 1] \
        if with_norm_partials else ()
    if with_grad_partials and not with_norm_partials:
        sumsq = (("in", 3),)
    return fused_elementwise(
        _lamb_stage1_fn, [p, m, v, g],
        scalars=[beta1, beta2, beta3, eps, weight_decay, bias_correction1,
                 bias_correction2, mode, inv_scale],
        num_outputs=3,
        out_dtypes=[torch.float32, m.dtype, v.dtype], check_finite=(3,),
        aliases={1: 1, 2: 2} if in_place else None,
        sumsq_subtiles=sumsq, kernel=False if plain else None)


def lamb_trust_ratio(w_norm, u_norm, *, weight_decay, use_nvlamb):
    """Per-tensor trust ratio (:322-328): ||p|| / ||u|| where both are
    positive, else 1; all ones unless the group decays or NVLAMB."""
    ratio = torch.where((w_norm > 0.0) & (u_norm > 0.0), w_norm / u_norm,
                        torch.ones_like(w_norm))
    if not use_nvlamb and not (weight_decay > 0.0):
        ratio = torch.ones_like(ratio)
    return ratio


def lamb_apply(p, u, ratio, *, lr, tile_ids, in_place=True, plain=False,
               sr_seed=None):
    """LAMB stage 2 (kernel ``lamb_stage2``): p' = p - lr * ratio * u,
    ``ratio`` per leaf through the subtile map ``tile_ids`` (p bf16 and
    p' stochastically rounded with ``sr_seed``)."""
    (p2,), _ = fused_elementwise(
        _lamb_stage2_fn, [p, u], scalars=[lr], per_tensor=[ratio],
        tile_ids=tile_ids, num_outputs=1, out_dtypes=[p.dtype],
        aliases={0: 0} if in_place else None,
        kernel=False if plain else None, **_sr(sr_seed))
    return p2


def fused_lamb_update(
    p, m, v, g, space: FlatSpace, *,
    lr, beta1=0.9, beta2=0.999, eps=1e-6, step=1,
    weight_decay=0.0, bias_correction=True, grad_averaging=True,
    max_grad_norm=0.0, adam_w_mode=True, use_nvlamb=False,
    global_grad_norm=None, grad_scale=1.0, with_grad_norm=False,
    in_place=True, plain=False, sr_seed=None, norms=None,
):
    """One fused LAMB step over flat fp32 buffers (p bf16 with
    ``sr_seed``: stage 1 reads it, stage 2 writes p' with stochastic
    rounding), the reference's two stages: the global-norm clip (``multi_tensor_l2norm`` of g when no
    ``global_grad_norm`` is handed in and ``max_grad_norm > 0``), stage 1
    with the p and u partials, the per-tensor norms and trust ratios,
    stage 2. ``with_grad_norm`` appends the per-tensor norms of the raw
    gradient, from the same stage-1 pass. With ``in_place`` p, m and v
    are overwritten; else new buffers are returned and the inputs left
    as they were. ``plain=True`` runs the plain versions on any device.
    ``norms`` (a ``parallel.sharded_norms.ShardedNorms``): the state is
    one rank's part, and every norm is the whole leaf's or the whole
    model's. Returns ``(p', m', v', found_inf[, grad_norm_per_tensor])``."""
    b1, b2, beta3, bc1, bc2 = lamb_scalars(
        beta1=beta1, beta2=beta2, step=step, bias_correction=bias_correction,
        grad_averaging=grad_averaging)
    inv_scale = lamb_inv_scale(g, max_grad_norm=max_grad_norm,
                               global_grad_norm=global_grad_norm,
                               grad_scale=grad_scale, plain=plain,
                               norms=norms)
    outs, found = fused_lamb_compute_update_term(
        p, m, v, g, beta1=b1, beta2=b2, beta3=beta3, eps=eps,
        weight_decay=weight_decay, bias_correction1=bc1,
        bias_correction2=bc2, adam_w_mode=adam_w_mode, inv_scale=inv_scale,
        with_norm_partials=True, with_grad_partials=with_grad_norm,
        in_place=in_place, plain=plain)
    u, m2, v2, p_part, u_part = outs[:5]
    ratio = lamb_trust_ratio(
        _norms_from_subtile_partials(p_part, space, plain, norms),
        _norms_from_subtile_partials(u_part, space, plain, norms),
        weight_decay=weight_decay, use_nvlamb=use_nvlamb)
    p2 = lamb_apply(p, u, ratio, lr=lr,
                    tile_ids=space.device_subtile_leaf_ids(p.device),
                    in_place=in_place, plain=plain, sr_seed=sr_seed)
    if with_grad_norm:
        return p2, m2, v2, found, _norms_from_subtile_partials(
            outs[5], space, plain, norms)
    return p2, m2, v2, found


def lamb_stage1_segments(p, m, v, g, outs, segs, seg_elems, *, scalars,
                         inv_scale, with_grad_partials=False, plain=False):
    """LAMB stage 1 over the listed segments only (the large leaves of a
    segmented layout, all in one launch of ``lamb_stage1``): u, m', v'
    into ``outs`` there, the rest untouched. ``segs`` is an int32 tensor
    of segment indices, ``scalars`` ``(b1, b2, beta3, eps, wd, bc1, bc2,
    mode)``. Returns ``(pp, uu, gg, found_inf)``: per-subtile sums of
    squares of p, u and (with ``with_grad_partials``, else None) g, one
    per 2048-element subtile of the whole buffer — only the listed
    segments' entries are defined."""
    n, dev = p.shape[0], p.device
    n_sub = n // _PT_TILE
    parts = [torch.empty(n_sub, dtype=torch.float32, device=dev)
             for _ in range(3 if with_grad_partials else 2)]
    if not plain and p.device.type == "cuda":
        _check_stage1((p, m, v, g), outs, dev)
        vals = [kernel_scalar(x, dev) for x in scalars]
        _host_scalars(LAMB_STAGE1_KERNEL, vals)
        inv_val, inv_ptr = scalar_pointer(kernel_scalar(inv_scale, dev))
        found = torch.zeros((), dtype=torch.float32, device=dev)
        ptrs = [t.data_ptr() for t in parts] + [None] * (3 - len(parts))
        _stage1_launch([p, m, v, g], list(outs), found, ptrs, vals, inv_val,
                       inv_ptr, segs=segs, seg_elems=seg_elems)
        return (*parts[:2], parts[2] if with_grad_partials else None, found)
    idx = segs.long()
    k, sub = idx.shape[0], seg_elems // _PT_TILE
    X = [b.view(-1, seg_elems)[idx].float() for b in (p, m, v, g)]
    found = (~torch.isfinite(X[3]).all()).to(torch.float32)
    s = [torch.as_tensor(x, dtype=torch.float32, device=dev)
         for x in (*scalars, inv_scale)]
    res = _lamb_stage1_fn(X, s, None)
    for buf, val in zip(outs, res):
        buf.view(-1, seg_elems).index_copy_(0, idx, val.to(buf.dtype))
    for part, x in zip(parts, (X[0], res[0], X[3])):
        part.zero_().view(-1, sub).index_copy_(
            0, idx, (x * x).view(k, sub, _PT_TILE).sum(-1))
    return (*parts[:2], parts[2] if with_grad_partials else None, found)


def lamb_stage2_segments(p, u, p_out, ratio, tile_ids, segs, seg_elems, *,
                         lr, seg_streams=None, sr_seed=None, plain=False):
    """LAMB stage 2 over the listed segments only (one launch of
    ``lamb_stage2``): p' = p - lr * ratio[leaf] * u there, the leaf of
    each subtile from ``tile_ids`` (the space's subtile -> leaf map on
    the device). A bf16 p takes ``sr_seed`` and ``seg_streams``, the pair
    ``(rows, leaves)`` of int64 tensors on p's device that
    ``SegmentMeta.device_large_streams`` makes: ``leaves`` the streams'
    leaf indices (at most ``STAGE2_MAX_STREAMS``), ``rows`` one ``(k,
    base)`` a listed segment, its stream and that leaf's first element.
    p' at element ``i`` takes the threefry bits of stream index ``i -
    base`` under ``fold_in(PRNGKey(sr_seed + leaves[k] + 1), 0)`` (the
    reference's large leaf, segmented.py:485-499: one stream per leaf,
    indexed within its slice)."""
    sr = seg_streams is not None
    if sr != (sr_seed is not None) or sr != (p.dtype != torch.float32):
        raise ValueError("a bf16 p takes stochastic rounding (seg_streams "
                         "and sr_seed), an fp32 one neither")
    if not plain and p.device.type == "cuda":
        dev = p.device
        for name, t in zip(("p", "u", "p_out"), (p, u, p_out)):
            check_kernel_input(name, t, (p.dtype,) if name[0] == "p"
                               else (torch.float32,), dev)
        if seg_streams is not None:
            for name, t in zip(("seg_streams rows", "seg_streams leaves"),
                               seg_streams):
                check_kernel_input(name, t, (torch.int64,), dev)
            if seg_streams[1].numel() > STAGE2_MAX_STREAMS:
                raise ValueError(
                    f"{LAMB_STAGE2_KERNEL}: {seg_streams[1].numel()} leaf "
                    f"streams, at most {STAGE2_MAX_STREAMS}")
        lr_v = kernel_scalar(lr, dev)
        _host_scalars(LAMB_STAGE2_KERNEL, [lr_v])
        _stage2_launch(p, u, p_out, ratio.float().contiguous(),
                       tile_ids.to(dev, torch.int32), lr_v, segs=segs,
                       seg_elems=seg_elems, seg_streams=seg_streams,
                       sr_seed=sr_seed)
        return p_out
    idx = segs.long()
    k, sub = idx.shape[0], seg_elems // _PT_TILE
    P = p.view(-1, seg_elems)[idx].float().view(k, sub, _PT_TILE)
    U = u.view(-1, seg_elems)[idx].float().view(k, sub, _PT_TILE)
    r = ratio[tile_ids.long().view(-1, sub)[idx]]
    lr_t = torch.as_tensor(lr, dtype=torch.float32, device=p.device)
    val = (P - lr_t * r[..., None] * U).view(k, seg_elems)
    if seg_streams is None:
        val = val.to(p_out.dtype)
    else:
        t, leaves = (x.to(p.device) for x in seg_streams)
        leaf = leaves[t[:, 0:1]]
        k0, k1 = threefry2x32(0, (int(sr_seed) + leaf + 1) & M32, 0, 0)
        pos = (idx[:, None] * seg_elems
               + torch.arange(seg_elems, device=p.device)[None, :]
               - t[:, 1:2])
        y1, y2 = threefry2x32(k0, k1, pos >> 32, pos & M32)
        val = sr_round_bits(val, y1 ^ y2)
    p_out.view(-1, seg_elems).index_copy_(0, idx, val)
    return p_out


# ---------------------------------------------------------------------------
# NovoGrad (the reference's :419-468; ref csrc/multi_tensor_novograd.cu)
# ---------------------------------------------------------------------------


def _novograd_fn(ins: Sequence[torch.Tensor], s: Sequence[torch.Tensor],
                 t: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The reference's NovoGrad functor (:451-457), one elementwise op at
    a time on fp32 0-d scalars: the gradient is divided by its leaf's
    denominator, and ``lr / bc1`` is a division too."""
    p_, m_, g_ = [x.float() for x in ins]
    lr_, b1, beta3_, wd, bc1_ = s
    (dn,) = t
    g_ = g_ / dn + wd * p_
    m2 = b1 * m_ + beta3_ * g_
    return [p_ - (lr_ / bc1_) * m2, m2]


def _novograd_kernel(inputs, outputs, scalars, found, check_finite,
                     per_tensor, tile_ids, sumsq, sr) -> None:
    """Launch ``csrc/adagrad_novograd.cu`` ``apex_novograd`` for
    :func:`_novograd_fn`: the denominators stay on the device, each
    subtile reads its leaf's."""
    if check_finite != (2,) or sumsq or len(per_tensor) != 1 \
            or tile_ids is None:
        raise NotImplementedError(
            "the NovoGrad kernel checks g (input 2), takes one per-tensor "
            "denominator through tile_ids and no sumsq partials; got "
            f"check_finite={check_finite}")
    _host_scalars(NOVOGRAD_KERNEL, scalars)
    lr, b1, beta3, wd, bc1 = scalars
    (denom,) = per_tensor
    P, L, F = _build.P, _build.L, _build.F
    _adagrad_family_launch(
        "apex_novograd", NOVOGRAD_KERNEL, (P,) * 8 + (L,) + (F,) * 5 + (P,),
        ("p", "m", "g", "p_out", "m_out"), inputs, outputs, found, sr,
        denom.data_ptr(), tile_ids.data_ptr(), inputs[0].numel(), lr, bc1, b1,
        beta3, wd)


register_kernel(_novograd_fn, _novograd_kernel)


def novograd_denominators(g_norm, v, *, beta2, eps, step, bias_correction):
    """NovoGrad's per-leaf second moment and denominator (:436-447),
    scalar work on ``g_norm``'s device: ``v' = ||g||^2`` at step 1, else
    ``b2 * v + (1 - b2) * ||g|| * ||g||``, and ``(sqrt(v') + eps) /
    sqrt(bc2)``. ``1 - b2`` is taken in Python double and rounded once,
    as the reference's Python arithmetic is. Returns ``(v', denom)``."""
    dev = g_norm.device
    if step > 1:
        v2 = (_dev_f32(beta2, dev) * v
              + _dev_f32(1.0 - beta2, dev) * g_norm * g_norm)
    else:
        v2 = g_norm * g_norm
    bc2 = (1.0 - torch.pow(_f32(beta2), _f32(float(step)))
           if bias_correction else _f32(1.0))
    denom = (sqrt_rn(v2) + _dev_f32(eps, dev)) \
        / sqrt_rn(_dev_f32(bc2, dev))
    return v2, denom


def novograd_apply(p, m, g, denom, *, lr, beta1, beta3, weight_decay, bc1,
                   tile_ids, in_place=True, plain=False, sr_seed=None):
    """The NovoGrad sweep (kernel ``fused_novograd``) given the per-leaf
    ``denom`` (read through the subtile map ``tile_ids``): returns
    ``(p', m', found_inf)`` (p bf16 and p' stochastically rounded with
    ``sr_seed``)."""
    (p2, m2), found = fused_elementwise(
        _novograd_fn, [p, m, g],
        scalars=[lr, beta1, beta3, weight_decay, bc1], per_tensor=[denom],
        tile_ids=tile_ids, num_outputs=2,
        out_dtypes=[p.dtype, m.dtype], check_finite=(2,),
        aliases={0: 0, 1: 1} if in_place else None,
        kernel=False if plain else None, **_sr(sr_seed))
    return p2, m2, found


def fused_novograd_update(
    p, m, v, g, space: FlatSpace, *,
    lr, beta1=0.95, beta2=0.98, eps=1e-8, step=1, weight_decay=0.0,
    grad_averaging=True, bias_correction=False, in_place=True, plain=False,
    sr_seed=None, norms=None,
):
    """One NovoGrad step over flat fp32 buffers (p bf16 with ``sr_seed``): the second moment ``v``
    is one fp32 scalar per leaf (``(num_leaves,)``), an EMA of the leaf's
    ||g||^2. The per-leaf norms of g (one sweep of kernel ``sumsq``), the
    denominators (:func:`novograd_denominators`, on the device), then
    the NovoGrad sweep (:func:`novograd_apply`). ``beta3`` is ``1 -
    beta1`` in Python double (or 1 without grad averaging) rounded once
    to fp32, as the reference takes it (:438); LAMB's is computed in
    fp32. With ``in_place`` p, m and v are overwritten; else new buffers
    are returned and the inputs left as they were. ``plain=True`` runs
    the plain versions on any device; ``norms``, the whole leaves' norms
    of a sharded state (``fused_lamb_update``). Returns ``(p', m', v',
    found_inf)``, ``found_inf`` covering g."""
    v2, denom = novograd_denominators(
        per_tensor_l2norm(g, space, plain=plain, norms=norms), v,
        beta2=beta2, eps=eps,
        step=step, bias_correction=bias_correction)
    bc1 = (1.0 - torch.pow(_f32(beta1), _f32(float(step)))
           if bias_correction else _f32(1.0))
    p2, m2, found = novograd_apply(
        p, m, g, denom, lr=lr, beta1=beta1,
        beta3=1.0 - beta1 if grad_averaging else 1.0,
        weight_decay=weight_decay, bc1=bc1,
        tile_ids=space.device_subtile_leaf_ids(p.device), in_place=in_place,
        plain=plain, sr_seed=sr_seed)
    if in_place:
        v2 = v.copy_(v2)
    return p2, m2, v2, found


# ---------------------------------------------------------------------------
# LARS (the reference's :471-499; ref csrc/multi_tensor_lars.cu)
# ---------------------------------------------------------------------------


def _lars_fn(ins: Sequence[torch.Tensor], s: Sequence[torch.Tensor],
             t: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The reference's LARS functor (:487-493), one elementwise op at a
    time: the per-tensor ratio scales the decayed gradient, then
    momentum SGD."""
    p_, mom_, g_ = [x.float() for x in ins]
    lr_, mu, wd, first = s
    (ratio,) = t
    g_ = (g_ + wd * p_) * ratio
    mom2 = torch.where(first > 0.5, g_, mu * mom_ + g_)
    return [p_ - lr_ * mom2, mom2]


def _lars_kernel(inputs, outputs, scalars, found, check_finite, per_tensor,
                 tile_ids, sumsq, sr) -> None:
    """Launch ``csrc/fused_sgd.cu`` ``apex_lars`` for :func:`_lars_fn`:
    the ratios stay on the device, each subtile reads its leaf's; the
    first-run flag (scalar 3) may live on the device."""
    if check_finite != (2,) or sumsq or len(per_tensor) != 1 \
            or tile_ids is None:
        raise NotImplementedError(
            "the LARS kernel checks g (input 2), takes one per-tensor "
            "ratio through tile_ids and no sumsq partials; got "
            f"check_finite={check_finite}")
    _host_scalars(LARS_KERNEL, scalars, allowed_device=(3,))
    lr, mu, wd, _ = scalars
    first_val, first_ptr = scalar_pointer(scalars[3])
    (ratio,) = per_tensor
    P, L, F, I = _build.P, _build.L, _build.F, _build.I
    _launch_sgd_family(
        "apex_lars", LARS_KERNEL, (P,) * 8 + (L,) + (F,) * 3 + (I, P, P),
        inputs, outputs, found, sr, ratio.data_ptr(), tile_ids.data_ptr(),
        inputs[0].numel(), lr, mu, wd, int(first_val > 0.5), first_ptr)


register_kernel(_lars_fn, _lars_kernel)


def lars_ratio(w_norm, g_norm, *, trust_coefficient, weight_decay, eps,
               clip):
    """Per-tensor LARS ratio (:481-485): ``trust * ||p|| / (||g|| +
    wd * ||p|| + eps)`` where both norms are positive, else 1; capped at
    1 in clip mode (LARC's, ref apex/parallel/LARC.py:91-99)."""
    adaptive = trust_coefficient * w_norm / (g_norm + weight_decay * w_norm
                                             + eps)
    adaptive = torch.where((w_norm > 0.0) & (g_norm > 0.0), adaptive,
                           torch.ones_like(adaptive))
    return torch.clamp(adaptive, max=1.0) if clip else adaptive


def lars_apply(p, mom, g, ratio, *, lr, momentum, weight_decay, tile_ids,
               first_run=False, in_place=True, plain=False, sr_seed=None):
    """The LARS sweep (kernel ``fused_lars``) given the per-leaf
    ``ratio`` (read through the subtile map ``tile_ids``): returns
    ``(p', mom', found_inf)`` (p bf16 and p' stochastically rounded with
    ``sr_seed``). ``first_run`` as for :func:`fused_sgd_update`."""
    if not isinstance(first_run, torch.Tensor):
        first_run = 1.0 if first_run else 0.0
    (p2, mom2), found = fused_elementwise(
        _lars_fn, [p, mom, g],
        scalars=[lr, momentum, weight_decay, first_run],
        per_tensor=[ratio], tile_ids=tile_ids, num_outputs=2,
        out_dtypes=[p.dtype, mom.dtype], check_finite=(2,),
        aliases={0: 0, 1: 1} if in_place else None,
        kernel=False if plain else None, **_sr(sr_seed))
    return p2, mom2, found


def fused_lars_update(
    p, mom, g, space: FlatSpace, *,
    lr, momentum=0.9, weight_decay=0.0, trust_coefficient=0.02, eps=1e-8,
    clip=True, first_run=False, in_place=True, plain=False, sr_seed=None,
    norms=None,
):
    """One LARS/LARC step over flat fp32 buffers (p bf16 with ``sr_seed``:
    its norms read it as fp32, p' stochastically rounded): the per-tensor
    norms of p and g (two sweeps of kernel ``sumsq``), the ratios
    (:func:`lars_ratio`, on the device), then the LARS sweep
    (:func:`lars_apply`). With ``in_place`` p and mom are overwritten;
    else new buffers are returned and the inputs left as they were.
    ``plain=True`` runs the plain versions on any device; ``norms``, the
    whole leaves' norms of a sharded state (``fused_lamb_update``).
    Returns ``(p', mom', found_inf)``."""
    ratio = lars_ratio(per_tensor_l2norm(p, space, plain=plain, norms=norms),
                       per_tensor_l2norm(g, space, plain=plain, norms=norms),
                       trust_coefficient=trust_coefficient,
                       weight_decay=weight_decay, eps=eps, clip=clip)
    return lars_apply(p, mom, g, ratio, lr=lr, momentum=momentum,
                      weight_decay=weight_decay, first_run=first_run,
                      tile_ids=space.device_subtile_leaf_ids(p.device),
                      in_place=in_place, plain=plain, sr_seed=sr_seed)


__all__ = ["ADAGRAD_KERNEL", "ADAM_KERNEL", "AXPBY_KERNEL",
           "LAMB_STAGE1_BF16_KERNEL", "LAMB_STAGE1_KERNEL",
           "LAMB_STAGE2_KERNEL", "LARS_KERNEL", "NOVOGRAD_KERNEL",
           "SCALE_KERNEL", "SGD_KERNEL", "SR_SUFFIX", "STAGE2_MAX_STREAMS",
           "sr_variant",
           "fused_adagrad_update", "fused_adam_update",
           "fused_lamb_compute_update_term", "fused_lamb_update",
           "fused_lars_update", "fused_novograd_update", "fused_sgd_update",
           "fused_unscale_l2norm", "lamb_apply", "lamb_inv_scale",
           "lamb_scalars", "lamb_stage1_segments", "lamb_stage2_segments",
           "lamb_trust_ratio", "lars_apply", "lars_ratio",
           "multi_tensor_axpby", "multi_tensor_l2norm", "multi_tensor_scale",
           "novograd_apply", "novograd_denominators", "per_tensor_l2norm"]
