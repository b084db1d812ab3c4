"""Fused LayerNorm / RMSNorm, forward and backward.

Counterpart of ``apex_tpu/ops/layer_norm.py``. On a CUDA tensor the
forward and the backward run the hand-written kernels in
``csrc/layer_norm.cu`` (the ports of the Pallas ``_fwd_kernel`` and
``_bwd_kernel``); on a CPU tensor they run :func:`_fwd_torch` and
:func:`_bwd_torch`, the plain PyTorch versions that mirror the
reference's ``_fwd_xla`` and ``_bwd_xla`` line for line. Compute is fp32
and the output takes ``x``'s dtype (fp32, bf16 or fp16), so bf16 or fp16
``x`` with fp32 weights (the reference's ``MixedFusedLayerNorm``) works
as is. fp16 launches count as ``layer_norm_fwd_fp16`` and
``layer_norm_bwd_fp16`` (:func:`kernel_name`).

A call that autograd has to differentiate goes through ``_NormFn``, the
counterpart of the reference's ``custom_vjp``: the forward saves
``(x, w, mean, rstd)`` and the backward computes dx, dw and db from
them. Other calls run the forward alone.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from apex_tpu_torch import _build
from apex_tpu_torch._backend import check_kernel_input, uses_kernel

KERNEL = "layer_norm_fwd"
BWD_KERNEL = "layer_norm_bwd"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def kernel_name(base: str, dtype: torch.dtype) -> str:
    """The launch counter of ``base`` (``KERNEL`` or ``BWD_KERNEL``) at
    ``dtype``: fp16 launches count apart, as ``<base>_fp16``."""
    return base + "_fp16" if dtype == torch.float16 else base


def _fwd_torch(x2: torch.Tensor, w: Optional[torch.Tensor],
               b: Optional[torch.Tensor], eps: float, rms: bool
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version on (rows, h): returns ``(y, mean, rstd)`` with fp32
    ``(rows, 1)`` statistics, like the reference's ``_fwd_xla``."""
    x = x2.float()
    if rms:
        mean = torch.zeros((x.shape[0], 1), dtype=torch.float32,
                           device=x.device)
        var = torch.mean(x * x, dim=-1, keepdim=True)
    else:
        mean = torch.mean(x, dim=-1, keepdim=True)
        var = torch.mean((x - mean) ** 2, dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = (x - mean) * rstd
    if w is not None:
        y = y * w.float().reshape(1, -1)
        if b is not None:
            y = y + b.float().reshape(1, -1)
    return y.to(x2.dtype), mean, rstd


def _fwd_cuda(x2: torch.Tensor, w: Optional[torch.Tensor],
              b: Optional[torch.Tensor], eps: float, rms: bool
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel on (rows, h): returns ``(y, mean, rstd)`` like the
    reference's ``_fwd_pallas``."""
    dev = x2.device
    check_kernel_input("x", x2, tuple(_DTYPE_CODES), dev)
    w = None if w is None else w.float().contiguous()
    b = None if b is None else b.float().contiguous()
    check_kernel_input("weight", w, (torch.float32,), dev)
    check_kernel_input("bias", b, (torch.float32,), dev)
    rows, h = x2.shape
    y = torch.empty_like(x2)
    mean = torch.empty((rows, 1), dtype=torch.float32, device=dev)
    rstd = torch.empty((rows, 1), dtype=torch.float32, device=dev)
    lib = _library()
    # the ctypes call launches on the current device: make it x's
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.apex_ln_fwd(
            x2.data_ptr(), None if w is None else w.data_ptr(),
            None if b is None else b.data_ptr(), y.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), rows, h, float(eps), int(rms),
            _DTYPE_CODES[x2.dtype], stream)
    if err:
        raise RuntimeError(f"{KERNEL}: CUDA error {err} at launch: "
                           f"{lib.apex_ln_error_string(err).decode()}")
    _build.count_launch(kernel_name(KERNEL, x2.dtype))
    return y, mean, rstd


def _bwd_torch(x2: torch.Tensor, w: Optional[torch.Tensor],
               mean: torch.Tensor, rstd: torch.Tensor, g2: torch.Tensor,
               rms: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward on (rows, h): returns ``(dx, dw,
    db)``, dx in x's dtype and the fp32 (h,) sums over rows — the
    reference's ``_bwd_xla``."""
    x = x2.float()
    g = g2.float()
    xhat = (x - mean) * rstd
    wg = g * w.float().reshape(1, -1) if w is not None else g
    c2 = torch.mean(wg * xhat, dim=-1, keepdim=True)
    if rms:
        dx = rstd * (wg - xhat * c2)
    else:
        c1 = torch.mean(wg, dim=-1, keepdim=True)
        dx = rstd * (wg - c1 - xhat * c2)
    return dx.to(x2.dtype), torch.sum(g * xhat, dim=0), torch.sum(g, dim=0)


def _bwd_cuda(x2: torch.Tensor, w: Optional[torch.Tensor],
              mean: torch.Tensor, rstd: torch.Tensor, g2: torch.Tensor,
              rms: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernel on (rows, h): dx plus per-block fp32 dw/db
    partials, summed here as the reference sums its per-tile partials
    in XLA (``_bwd_pallas`` :152)."""
    dev = x2.device
    check_kernel_input("x", x2, tuple(_DTYPE_CODES), dev)
    g2 = g2.contiguous()
    check_kernel_input("grad", g2, (x2.dtype,), dev)
    w = None if w is None else w.float().contiguous()
    check_kernel_input("weight", w, (torch.float32,), dev)
    for name, t in (("mean", mean), ("rstd", rstd)):
        check_kernel_input(name, t, (torch.float32,), dev)
    rows, h = x2.shape
    dx = torch.empty_like(x2)
    if rows == 0:
        zero = torch.zeros(h, dtype=torch.float32, device=dev)
        return dx, zero, zero.clone()
    lib = _library("apex_ln_bwd_grid", (_build.I, _build.I, _build.I))
    code = _DTYPE_CODES[x2.dtype]
    with torch.cuda.device(dev):
        blocks = lib.apex_ln_bwd_grid(rows, h, code)
        if blocks <= 0:
            raise RuntimeError(f"{BWD_KERNEL}: no launch for rows={rows} "
                               f"h={h}: " + lib.apex_ln_error_string(
                                   -blocks).decode())
        dw_part = torch.empty((blocks, h), dtype=torch.float32, device=dev)
        db_part = torch.empty((blocks, h), dtype=torch.float32, device=dev)
        P, I = _build.P, _build.I
        lib = _library("apex_ln_bwd", (P, P, P, P, P, P, P, P, I, I, I, I, I,
                                       P))
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.apex_ln_bwd(
            x2.data_ptr(), g2.data_ptr(), None if w is None else w.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), dx.data_ptr(),
            dw_part.data_ptr(), db_part.data_ptr(), blocks, rows, h,
            int(rms), code, stream)
    if err:
        raise RuntimeError(f"{BWD_KERNEL}: CUDA error {err} at launch: "
                           f"{lib.apex_ln_error_string(err).decode()}")
    _build.count_launch(kernel_name(BWD_KERNEL, x2.dtype))
    return dx, dw_part.sum(dim=0), db_part.sum(dim=0)


def _library(launcher: str = "apex_ln_fwd", argtypes=None) -> ctypes.CDLL:
    P, I, F = _build.P, _build.I, _build.F
    if argtypes is None:
        argtypes = (P, P, P, P, P, P, I, I, F, I, I, P)
    return _build.library("layer_norm", launcher, argtypes,
                          "apex_ln_error_string")


class _NormFn(torch.autograd.Function):
    """The reference's ``custom_vjp`` around the norm (``_norm`` :200):
    the kernels on CUDA tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, x2, w, b, eps, rms, kernel):
        y, mean, rstd = (_fwd_cuda if kernel else _fwd_torch)(x2, w, b, eps,
                                                             rms)
        ctx.save_for_backward(x2, w, mean, rstd)
        ctx.rms, ctx.kernel = rms, kernel
        ctx.b_dtype = None if b is None else b.dtype
        return y

    @staticmethod
    def backward(ctx, gy):
        x2, w, mean, rstd = ctx.saved_tensors
        dx, dw, db = (_bwd_cuda if ctx.kernel else _bwd_torch)(
            x2, w, mean, rstd, gy, ctx.rms)
        dw = dw.to(w.dtype) if w is not None else None
        db = None if ctx.b_dtype is None else db.to(ctx.b_dtype)
        return dx, dw, db, None, None, None


def _norm(x, weight, bias, eps, rms, kernel) -> torch.Tensor:
    """Flatten to (rows, hidden) over the dims ``weight`` covers, run the
    norm (through ``_NormFn`` when autograd needs its gradient), and
    restore the shape."""
    ndim = weight.ndim if weight is not None else 1
    hidden = 1
    for d in x.shape[x.ndim - ndim:]:
        hidden *= d
    x2 = x.reshape(-1, hidden).contiguous()
    w = None if weight is None else weight.reshape(-1)
    b = None if bias is None else bias.reshape(-1)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x2, w, b)):
        y = _NormFn.apply(x2, w, b, eps, rms, kernel)
    else:
        y, _, _ = (_fwd_cuda if kernel else _fwd_torch)(x2, w, b, eps, rms)
    return y.reshape(x.shape)


def fused_layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None, *,
                     eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the trailing dims covered by ``weight`` (the last
    dim when ``weight`` is None). fp32 compute, output in ``x``'s
    dtype."""
    return _norm(x, weight, bias, eps, False, uses_kernel(x))


def fused_rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
                   *, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the trailing dims covered by ``weight``."""
    return _norm(x, weight, None, eps, True, uses_kernel(x))


def layer_norm_plain(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
                     bias: Optional[torch.Tensor] = None, *,
                     eps: float = 1e-5) -> torch.Tensor:
    """:func:`fused_layer_norm` through the plain versions on any device
    — the yardstick the kernels are held against on the card."""
    return _norm(x, weight, bias, eps, False, False)


__all__ = ["fused_layer_norm", "fused_rms_norm", "layer_norm_plain"]
