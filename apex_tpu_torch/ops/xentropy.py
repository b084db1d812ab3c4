"""Fused softmax cross-entropy with label smoothing, forward and backward.

Counterpart of ``apex_tpu/ops/xentropy.py``::

    loss_i = lse_i - (1 - s) * x_i[y_i] - s * mean_j(x_ij)
    dx_ij  = g_i * (exp(x_ij - lse_i) - (1 - s) * [j == y_i] - s / K)

On a CUDA tensor the forward and the backward run the hand-written
kernels in ``csrc/xentropy.cu`` (the ports of the Pallas ``_fwd_kernel``
and ``_bwd_kernel``); on a CPU tensor they run :func:`_fwd_torch` and
:func:`_bwd_torch`, op for op the reference's XLA branches of
``_fwd_impl`` and ``_bwd_impl``. Logits are fp32, bf16 or fp16; the math
and the losses are fp32, dx takes the logits' dtype.

A label outside [0, K) takes the Pallas kernels' rule: x[y] is 0 and the
one-hot row is all zeros. (The reference's XLA forward wraps a label in
[-K, 0) and gives NaN for the others; its backward's one-hot is zeros for
all of them.)

A call that autograd has to differentiate goes through ``_XentropyFn``,
the counterpart of the reference's ``custom_vjp``: the forward saves only
the logits, the labels and the per-row lse — not the softmax, the
reference's memory trick — and the backward recomputes the
probabilities; labels get no gradient. Other calls run the forward
alone.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from apex_tpu_torch import _build
from apex_tpu_torch._backend import check_kernel_input, uses_kernel

FWD_KERNEL = "xentropy_fwd"
BWD_KERNEL = "xentropy_bwd"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


# -- plain versions -----------------------------------------------------------


def _pick(x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """x[y] per row of (T, K) ``x``, 0 where y lies outside [0, K)."""
    k = x.shape[-1]
    y = labels.long()[:, None]
    inside = (y >= 0) & (y < k)
    return torch.where(inside, torch.gather(x, -1, y.clamp(0, k - 1)), 0.0)


# On the CPU the row lse and the probabilities' exp are taken in fp64 (numpy,
# single-threaded) and rounded once to fp32, so the plain path is within
# half an ulp of the exact value. PyTorch's fp32 CPU kernels are an ulp or
# two off on some rows, which rows depending on the vector kernels the CPU
# dispatches to: the lse's rounding moves every probability of its row, and
# with the reference's fp32 lse an ulp off on other rows the port's fp32
# gradients sat 7.2e-7 from the reference's against the tests' 1e-6. A
# CUDA tensor keeps PyTorch's ops (the kernels are held against them
# bitwise).
def _logsumexp_rn(x: torch.Tensor) -> torch.Tensor:
    """fp32 logsumexp over the last dim of (T, K) ``x``, kept as (T, 1)."""
    if x.device.type != "cpu":
        return torch.logsumexp(x, dim=-1, keepdim=True)
    xd = x.detach().numpy().astype(np.float64)
    m = xd.max(axis=-1, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)   # all -inf rows give -inf
    with np.errstate(divide="ignore"):
        lse = np.log(np.exp(xd - m).sum(axis=-1, keepdims=True)) + m
    return torch.from_numpy(lse.astype(np.float32))


def logsumexp_diff(x: torch.Tensor) -> torch.Tensor:
    """Differentiable logsumexp over the last dim, with logsumexp's own
    gradient; on the CPU in fp32 its value is ``_logsumexp_rn``'s."""
    lse = torch.logsumexp(x, dim=-1)
    if x.device.type != "cpu" or x.dtype != torch.float32:
        return lse
    rn = _logsumexp_rn(x.detach().reshape(-1, x.shape[-1]))
    return lse + (rn.reshape(lse.shape) - lse).detach()


def _exp_rn(x: torch.Tensor) -> torch.Tensor:
    """fp32 exp, correctly rounded on the CPU (see above)."""
    if x.device.type != "cpu":
        return torch.exp(x)
    return torch.from_numpy(
        np.exp(x.detach().numpy().astype(np.float64)).astype(np.float32))


def _fwd_torch(logits2: torch.Tensor, labels: torch.Tensor, smoothing: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain forward on (T, K) logits and (T,) labels: ``(loss, lse)``,
    both (T,) fp32 (the reference's XLA branch of ``_fwd_impl``)."""
    x = logits2.float()
    lse = _logsumexp_rn(x)
    loss = lse - (1.0 - smoothing) * _pick(x, labels)
    if smoothing > 0.0:
        loss = loss - smoothing * torch.mean(x, dim=-1, keepdim=True)
    return loss[:, 0], lse[:, 0]


def _bwd_torch(logits2: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor,
               g: torch.Tensor, smoothing: float) -> torch.Tensor:
    """Plain backward: dx (T, K) in the logits' dtype from the saved (T,)
    lse and the (T,) fp32 cotangent (the XLA branch of ``_bwd_impl``)."""
    x = logits2.float()
    k = x.shape[-1]
    p = _exp_rn(x - lse[:, None])
    cols = torch.arange(k, device=x.device)
    onehot = (cols[None, :] == labels.long()[:, None]).float()
    dx = g[:, None] * (p - (1.0 - smoothing) * onehot - smoothing / k)
    return dx.to(logits2.dtype)


# -- kernels ------------------------------------------------------------------


def _library(launcher: str, argtypes) -> ctypes.CDLL:
    return _build.library("xentropy", launcher, argtypes,
                          "apex_xentropy_error_string")


def _check_labels(labels: torch.Tensor, rows: int, dev) -> None:
    check_kernel_input("labels", labels, (torch.int32,), dev)
    if labels.shape != (rows,):
        raise ValueError(f"labels {tuple(labels.shape)} do not match "
                         f"{rows} rows of logits")


def _raise_on(err: int, lib, counter: str) -> None:
    if err:
        raise RuntimeError(f"{counter}: CUDA error {err} at launch: "
                           f"{lib.apex_xentropy_error_string(err).decode()}")


def _fwd_cuda(logits2: torch.Tensor, labels: torch.Tensor, smoothing: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward kernel on the same arguments as :func:`_fwd_torch`."""
    dev = logits2.device
    check_kernel_input("logits", logits2, tuple(_DTYPE_CODES), dev)
    rows, k = logits2.shape
    _check_labels(labels, rows, dev)
    loss = torch.empty(rows, dtype=torch.float32, device=dev)
    lse = torch.empty(rows, dtype=torch.float32, device=dev)
    if rows == 0:
        return loss, lse
    if k == 0:
        raise ValueError("logits have no classes")
    P, I, L, F = _build.P, _build.I, _build.L, _build.F
    lib = _library("apex_xentropy_fwd", (P, P, P, P, L, I, F, F, I, I, P))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.apex_xentropy_fwd(
            logits2.data_ptr(), labels.data_ptr(), loss.data_ptr(),
            lse.data_ptr(), rows, k, 1.0 - smoothing, smoothing,
            int(smoothing > 0.0), _DTYPE_CODES[logits2.dtype], stream)
    _raise_on(err, lib, FWD_KERNEL)
    _build.count_launch(FWD_KERNEL)
    return loss, lse


def _bwd_cuda(logits2: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor,
              g: torch.Tensor, smoothing: float) -> torch.Tensor:
    """The backward kernel on the same arguments as :func:`_bwd_torch`.
    ``1 - s`` and ``s / K`` are Python doubles rounded to fp32 once, as
    PyTorch rounds a Python scalar for an fp32 tensor."""
    dev = logits2.device
    check_kernel_input("logits", logits2, tuple(_DTYPE_CODES), dev)
    rows, k = logits2.shape
    _check_labels(labels, rows, dev)
    for name, t in (("lse", lse), ("grad", g)):
        check_kernel_input(name, t, (torch.float32,), dev)
        if t.shape != (rows,):
            raise ValueError(f"{name} {tuple(t.shape)} does not match "
                             f"{rows} rows of logits")
    dx = torch.empty_like(logits2)
    if logits2.numel() == 0:
        return dx
    P, I, L, F = _build.P, _build.I, _build.L, _build.F
    lib = _library("apex_xentropy_bwd", (P, P, P, P, P, L, I, F, F, I, P))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.apex_xentropy_bwd(
            logits2.data_ptr(), labels.data_ptr(), lse.data_ptr(),
            g.data_ptr(), dx.data_ptr(), rows, k, 1.0 - smoothing,
            smoothing / k, _DTYPE_CODES[logits2.dtype], stream)
    _raise_on(err, lib, BWD_KERNEL)
    _build.count_launch(BWD_KERNEL)
    return dx


class _XentropyFn(torch.autograd.Function):
    """The reference's ``custom_vjp``: the kernels on CUDA tensors, the
    plain versions on CPU tensors; saves logits, labels and lse."""

    @staticmethod
    def forward(ctx, logits2, labels, smoothing, kernel):
        loss, lse = (_fwd_cuda if kernel else _fwd_torch)(
            logits2, labels, smoothing)
        ctx.save_for_backward(logits2, labels, lse)
        ctx.smoothing, ctx.kernel = smoothing, kernel
        return loss

    @staticmethod
    def backward(ctx, g):
        logits2, labels, lse = ctx.saved_tensors
        g = g.float().contiguous()
        dx = (_bwd_cuda if ctx.kernel else _bwd_torch)(
            logits2, labels, lse, g, ctx.smoothing)
        return dx, None, None, None


def softmax_cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                               smoothing: float = 0.0) -> torch.Tensor:
    """Per-example fused cross entropy (the reference's
    ``softmax_cross_entropy_loss``): ``logits`` (..., K) fp32, bf16 or
    fp16; ``labels`` (...) int. Returns fp32 losses shaped like
    ``labels``. On a CUDA device the logits must be contiguous."""
    if labels.dtype.is_floating_point or labels.dtype == torch.bool:
        raise TypeError(f"labels must be integers, not {labels.dtype}")
    if logits.shape[:-1] != labels.shape:
        raise ValueError(f"logits {tuple(logits.shape)} do not match "
                         f"labels {tuple(labels.shape)}")
    kernel = uses_kernel(logits)
    if kernel and not logits.is_contiguous():
        raise ValueError("logits must be contiguous")
    smoothing = float(smoothing)
    logits2 = logits.reshape(-1, logits.shape[-1])
    labels1 = labels.reshape(-1).to(torch.int32)
    if torch.is_grad_enabled() and logits.requires_grad:
        loss = _XentropyFn.apply(logits2, labels1, smoothing, kernel)
    else:
        loss = (_fwd_cuda if kernel else _fwd_torch)(
            logits2, labels1, smoothing)[0]
    return loss.reshape(labels.shape)


__all__ = ["softmax_cross_entropy_loss"]
