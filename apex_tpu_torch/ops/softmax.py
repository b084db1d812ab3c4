"""Fused scaled / causal / masked softmax, forward and backward.

Counterpart of ``apex_tpu/ops/softmax.py``. Every variant computes
softmax(scale * x [+ fill]) over the last dim in fp32 and returns x's
dtype; the backward uses only the saved output, dx = scale * y * (g -
sum(g * y)). On a CUDA tensor the forward runs the hand-written kernel
in ``csrc/softmax.cu`` (one template with three mask modes, the ports of
the Pallas ``_scaled_kernel``, ``_causal_kernel`` and ``_masked_kernel``)
and the backward its shared backward kernel (``_bwd_kernel``); on a CPU
tensor they run :func:`_fwd_torch` and :func:`_bwd_torch`, the plain
versions, op for op the reference's ``_softmax_rows`` and the XLA branch
of ``_bwd_any`` in fp32. The masked kernel reads its mask through a batch
and a query stride (:func:`mask_layout`), so a (b, 1, 1, sk) or (1, 1,
sq, sk) mask is not copied: one call, one kernel.

The fills are the reference's: the masked variants *add* ``MASK_FILL``
(-10000) to ``scale * x`` where the mask is True, so a row whose keys
are all masked comes out as the softmax of the shifted scores, neither
zeros nor uniform; the causal variant adds ``CAUSAL_FILL`` (-1e30) past
the diagonal (key j > query i, no offset for sk != sq), whose ``exp`` is
exactly 0, so the kernel neither reads those scores nor sums them and
writes 0 there.

A call that autograd has to differentiate goes through ``_SoftmaxFn``,
the counterpart of the reference's ``custom_vjp``: the forward saves
only ``y``, the backward returns no gradient for the mask. Other calls
run the forward alone. The reference falls back to XLA where its row
tiling finds no tile; the kernel takes any row count and width, so
nothing here falls back: a CUDA tensor of another dtype than fp32, bf16
or fp16 raises. fp16 launches count apart (:func:`kernel_name`); the
fills are added in fp32 before the output is rounded, so -1e30 is never
stored in fp16.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from apex_tpu_torch import _build
from apex_tpu_torch._backend import uses_kernel

MASK_FILL = -10000.0   # the reference's fill for masked logits (added)
CAUSAL_FILL = -1e30    # past the diagonal (added; exp gives exactly 0)

SCALED_KERNEL = "softmax_scaled_fwd"
CAUSAL_KERNEL = "softmax_causal_fwd"
MASKED_KERNEL = "softmax_masked_fwd"
BWD_KERNEL = "softmax_bwd"
# mask mode -> (the kernel's mode code, its launch counter)
_MODES = {"scaled": (0, SCALED_KERNEL), "causal": (1, CAUSAL_KERNEL),
          "masked": (2, MASKED_KERNEL)}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def kernel_name(base: str, dtype: torch.dtype) -> str:
    """The launch counter of ``base`` (a forward mode's or
    ``BWD_KERNEL``) at ``dtype``: fp16 launches count apart, as
    ``<base>_fp16``."""
    return base + "_fp16" if dtype == torch.float16 else base


# -- plain versions -----------------------------------------------------------


def _softmax_rows(x: torch.Tensor, scale: float,
                  extra: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fp32 softmax of scale*x + extra over the last dim (the reference's
    ``_softmax_rows`` :38)."""
    s = x.float() * scale
    if extra is not None:
        s = s + extra
    m = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - m)
    return e / torch.sum(e, dim=-1, keepdim=True)


def _causal_extra(sq: int, sk: int, device) -> torch.Tensor:
    row = torch.arange(sq, device=device).reshape(sq, 1)
    col = torch.arange(sk, device=device).reshape(1, sk)
    return torch.where(col > row, CAUSAL_FILL, 0.0)


def _fwd_torch(x: torch.Tensor, mask: Optional[torch.Tensor], scale: float,
               mode: str) -> torch.Tensor:
    """Plain forward of ``mode``: x (..., sk) for "scaled", (a, sq, sk)
    for "causal", (b, h, sq, sk) with a bool mask (mb, 1, sq, sk) for
    "masked"."""
    if mode == "scaled":
        extra = None
    elif mode == "causal":
        extra = _causal_extra(x.shape[-2], x.shape[-1], x.device)
    else:
        extra = torch.where(mask, MASK_FILL, 0.0)
    return _softmax_rows(x, scale, extra).to(x.dtype)


def _bwd_torch(y: torch.Tensor, g: torch.Tensor, scale: float
               ) -> torch.Tensor:
    """Plain backward: the XLA branch of the reference's ``_bwd_any``
    (:100-104)."""
    yf, gf = y.float(), g.float()
    dot = torch.sum(yf * gf, dim=-1, keepdim=True)
    return (scale * yf * (gf - dot)).to(y.dtype)


# -- kernels ------------------------------------------------------------------


def _library(launcher: str, argtypes) -> ctypes.CDLL:
    return _build.library("softmax", launcher, argtypes,
                          "apex_softmax_error_string")


def _check(name: str, t: torch.Tensor, dtypes, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name} has dtype {t.dtype}; the softmax kernel "
                        f"takes {', '.join(str(d) for d in dtypes)}")


def _check_mask_shape(x: torch.Tensor, mask: torch.Tensor) -> None:
    if x.ndim != 4 or mask.ndim != 4:
        raise ValueError(f"expected x (b, h, sq, sk) and a 4-D mask, got "
                         f"{tuple(x.shape)} and {tuple(mask.shape)}")
    b, _, sq, sk = x.shape
    mb, one, mq, mk = mask.shape
    if mb not in (1, b) or one != 1 or mq not in (1, sq) or mk not in (1,
                                                                       sk):
        raise ValueError(f"mask {tuple(mask.shape)} does not broadcast as "
                         f"(b or 1, 1, sq, sk) over x {tuple(x.shape)}")


def mask_layout(x: torch.Tensor, mask: torch.Tensor):
    """How the masked kernel reads ``mask`` for (b, h, sq, sk) scores
    ``x``: ``(mask, batch_stride, query_stride)``, ``mask`` a bool tensor
    of shape (mb, 1, sq or 1, sk) (mb 1 or b) whose keys lie at unit
    stride, and the strides (in elements, which are bytes) of its batch
    and query dims, 0 where it broadcasts over them. A (b, 1, 1, sk), (1,
    1, sq, sk) or (b, 1, sq, sk) mask, or any expanded view of one, comes
    back as it is; a non-bool mask is compared with 0, and one broadcast
    along the keys (or strided there) is copied to unit stride. Raises
    ValueError where the mask does not broadcast as (b or 1, 1, sq, sk)
    over x."""
    _check_mask_shape(x, mask)
    mb, _, mq, mk = mask.shape
    sk = x.shape[-1]
    if mask.dtype != torch.bool:
        mask = mask != 0
    if mk != sk or (sk > 1 and mask.stride(3) != 1):
        mask = mask.expand(mb, 1, mq, sk).contiguous()
    return (mask, mask.stride(0) if mb > 1 else 0,
            mask.stride(2) if mq > 1 else 0)


def _fwd_args(x: torch.Tensor, mask: Optional[torch.Tensor], mode: str):
    """The kernel's arguments for x (contiguous) and the mask of ``mode``:
    rows, sq, sk, heads, the mask (or None) and its two strides."""
    sk = x.shape[-1]
    sq = x.shape[-2] if x.ndim >= 2 else 1
    if mode != "masked":
        return x.numel() // max(sk, 1), sq, sk, 1, None, 0, 0
    mask, mbs, mqs = mask_layout(x, mask)
    return x.numel() // max(sk, 1), sq, sk, x.shape[1], mask, mbs, mqs


def _fwd_cuda(x: torch.Tensor, mask: Optional[torch.Tensor], scale: float,
              mode: str) -> torch.Tensor:
    """The forward kernel of ``mode`` on the same shapes as
    :func:`_fwd_torch`: one launch, the mask read where it lies
    (:func:`mask_layout`). Rows whose width does not divide into 16-byte
    packs, or tensors that are not 16-byte aligned, take the kernel's
    one-element loads."""
    dev = x.device
    _check("x", x, tuple(_DTYPE_CODES), dev)
    if mode == "masked":
        _check("mask", mask, (torch.bool,), dev)
    x = x.contiguous()
    code, counter = _MODES[mode]
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    rows, sq, sk, heads, mask, mbs, mqs = _fwd_args(x, mask, mode)
    P, I, L, F = _build.P, _build.I, _build.L, _build.F
    lib = _library("apex_softmax_fwd", (P, P, P, L, I, I, I, L, L, F, I, I,
                                        P))
    # the ctypes call launches on the current device: make it x's
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.apex_softmax_fwd(
            x.data_ptr(), None if mask is None else mask.data_ptr(),
            y.data_ptr(), rows, sq, sk, heads, mbs, mqs, float(scale), code,
            _DTYPE_CODES[x.dtype], stream)
    if err:
        raise RuntimeError(f"{counter}: CUDA error {err} at launch: "
                           f"{lib.apex_softmax_error_string(err).decode()}")
    _build.count_launch(kernel_name(counter, x.dtype))
    return y


ROUTE_KEYS = ("lanes", "slots", "threads", "blocks", "resident_blocks",
              "registers", "spill_bytes")


def fwd_route(x: torch.Tensor, mask: Optional[torch.Tensor],
              mode: str) -> dict:
    """How :func:`_fwd_cuda` runs these arguments on x's device: lanes a
    row (0 on the block path of rows past 1024 columns), 16-byte slots (or
    elements) a lane, threads a block, blocks, blocks resident at once, and
    the instance's registers and spilled bytes a thread. Launches
    nothing."""
    x = x.contiguous()
    if mode == "masked":
        _check("mask", mask, (torch.bool,), x.device)
    rows, sq, sk, _, mask, mbs, mqs = _fwd_args(x, mask, mode)
    P, I, L = _build.P, _build.I, _build.L
    lib = _library("apex_softmax_fwd_route", (P, P, P, L, I, I, L, L, I, I,
                                              P))
    out = (ctypes.c_int * len(ROUTE_KEYS))()
    with torch.cuda.device(x.device):
        err = lib.apex_softmax_fwd_route(
            x.data_ptr(), None if mask is None else mask.data_ptr(),
            x.data_ptr(), rows, sq, sk, mbs, mqs, _MODES[mode][0],
            _DTYPE_CODES[x.dtype], ctypes.addressof(out))
    if err:
        raise RuntimeError(f"softmax route: CUDA error {err}: "
                           f"{lib.apex_softmax_error_string(err).decode()}")
    return dict(zip(ROUTE_KEYS, out))


def _bwd_cuda(y: torch.Tensor, g: torch.Tensor, scale: float
              ) -> torch.Tensor:
    """The shared backward kernel: dx in y's dtype."""
    dev = y.device
    _check("y", y, tuple(_DTYPE_CODES), dev)
    _check("grad", g, (y.dtype,), dev)
    y, g = y.contiguous(), g.contiguous()
    if g.shape != y.shape:
        raise ValueError(f"grad {tuple(g.shape)} does not match y "
                         f"{tuple(y.shape)}")
    dx = torch.empty_like(y)
    if y.numel() == 0:
        return dx
    sk = y.shape[-1]
    P, I, L, F = _build.P, _build.I, _build.L, _build.F
    lib = _library("apex_softmax_bwd", (P, P, P, L, I, F, I, P))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.apex_softmax_bwd(
            y.data_ptr(), g.data_ptr(), dx.data_ptr(), y.numel() // sk, sk,
            float(scale), _DTYPE_CODES[y.dtype], stream)
    if err:
        raise RuntimeError(f"{BWD_KERNEL}: CUDA error {err} at launch: "
                           f"{lib.apex_softmax_error_string(err).decode()}")
    _build.count_launch(kernel_name(BWD_KERNEL, y.dtype))
    return dx


class _SoftmaxFn(torch.autograd.Function):
    """The reference's ``custom_vjp`` around each variant: the kernels on
    CUDA tensors, the plain versions on CPU tensors; saves only y."""

    @staticmethod
    def forward(ctx, x, mask, scale, mode, kernel):
        y = (_fwd_cuda if kernel else _fwd_torch)(x, mask, scale, mode)
        ctx.save_for_backward(y)
        ctx.scale, ctx.kernel = scale, kernel
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        g = g.to(y.dtype)
        dx = (_bwd_cuda if ctx.kernel else _bwd_torch)(y, g, ctx.scale)
        return dx, None, None, None, None


def _softmax(x, mask, scale, mode, kernel) -> torch.Tensor:
    if torch.is_grad_enabled() and x.requires_grad:
        return _SoftmaxFn.apply(x, mask, scale, mode, kernel)
    return (_fwd_cuda if kernel else _fwd_torch)(x, mask, scale, mode)


def _masked_args(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Validate (b, h, sq, sk) x and its (mb, 1, sq | 1, sk | 1) mask
    (mb 1 or b); return the mask as a (mb, 1, sq, sk) bool view (stride 0
    where it broadcasts: the kernel reads it through its strides)."""
    _check_mask_shape(x, mask)
    if mask.dtype != torch.bool:
        mask = mask != 0
    return mask.expand(mask.shape[0], 1, *x.shape[2:])


def scaled_softmax(x: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
    """softmax(scale * x) over the last dim, any leading dims."""
    return _softmax(x, None, scale, "scaled", uses_kernel(x))


def scaled_upper_triang_masked_softmax(x: torch.Tensor,
                                       scale: float = 1.0) -> torch.Tensor:
    """Causal softmax over (attn_batches, sq, sk): key j > query i is
    masked out."""
    if x.ndim != 3:
        raise ValueError(f"expected (attn_batches, sq, sk), got "
                         f"{tuple(x.shape)}")
    return _softmax(x, None, scale, "causal", uses_kernel(x))


def scaled_masked_softmax(x: torch.Tensor, mask: torch.Tensor,
                          scale: float = 1.0) -> torch.Tensor:
    """softmax(scale * x + MASK_FILL where mask) for x (b, h, sq, sk) and
    a boolean mask (b or 1, 1, sq, sk), True masking out."""
    mask = _masked_args(x, mask)
    return _softmax(x, mask, scale, "masked", uses_kernel(x))


def generic_scaled_masked_softmax(x: torch.Tensor, mask: torch.Tensor,
                                  scale: float = 1.0) -> torch.Tensor:
    """Masked softmax with any mask that broadcasts against x. The
    standard (b or 1, 1, sq, sk) layout goes to
    :func:`scaled_masked_softmax` as it is; any other is broadcast to the
    full shape, one mask row per score row, and takes the same kernel
    (the reference runs such masks through XLA)."""
    if (x.ndim == 4 and mask.ndim == 4 and mask.shape[1] == 1
            and tuple(mask.shape[2:]) == tuple(x.shape[2:])
            and mask.shape[0] in (1, x.shape[0])):
        return scaled_masked_softmax(x, mask, scale)
    shape = torch.broadcast_shapes(x.shape, mask.shape)
    sq = shape[-2] if len(shape) >= 2 else 1
    flat = (-1, 1, sq, shape[-1])
    x4 = x.expand(shape).reshape(flat)
    m4 = mask.expand(shape).reshape(flat)
    return scaled_masked_softmax(x4, m4, scale).reshape(shape)


def softmax_plain(x: torch.Tensor, mask: Optional[torch.Tensor] = None, *,
                  causal: bool = False, scale: float = 1.0) -> torch.Tensor:
    """The plain version of the variant the dispatcher picks for (b, h,
    sq, sk) scores — causal, masked, or neither — on any device: the
    yardstick the kernels are held against on the card. Differentiable
    through the plain backward."""
    b, h, sq, sk = x.shape
    if causal:
        return _softmax(x.reshape(-1, sq, sk), None, scale, "causal",
                        False).reshape(b, h, sq, sk)
    if mask is not None:
        return _softmax(x, _masked_args(x, mask), scale, "masked", False)
    return _softmax(x, None, scale, "scaled", False)


__all__ = ["CAUSAL_FILL", "MASK_FILL", "generic_scaled_masked_softmax",
           "scaled_masked_softmax", "scaled_softmax",
           "scaled_upper_triang_masked_softmax", "softmax_plain"]
