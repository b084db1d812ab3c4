"""Fused rotary positional embedding — the reference's four RoPE variants.

Counterpart of ``apex_tpu/ops/rope.py``. The rotation, in fp32 on the
first ``rot = cos.shape[-1]`` channels of ``t`` (the halves split, not
interleaved), the remaining channels passed through and the result
rounded to ``t``'s dtype::

    out = t_rot * cos + rotate_half(t_rot) * sin,  rotate_half(t) = [-t2, t1]

On a CUDA tensor the sbhd, cached and thd variants run the hand-written
kernel in ``csrc/rope.cu`` (the port of the Pallas ``_rope_kernel``); on
a CPU tensor they run :func:`_apply_torch`, the reference's ``_apply``
op for op. The kernel reads cos and sin through their element strides,
so tables that vary along any dimension of ``t`` (per batch, per head)
run on it as well as the position-only ``(n, 1..., rot)`` layouts (the
reference's ``rows_only`` kernel path; it sends the others to XLA).

A call that autograd has to differentiate goes through ``_RopeFn``, the
counterpart of the reference's ``custom_vjp``: it saves only cos and sin,
and its backward is the same rotation with -sin (``_rope_cached_bwd``),
the kernel with its negate flag on a CUDA tensor. cos, sin and freqs get
no gradient. Layouts follow the reference:

- sbhd: ``t (s, b, h, d)``, ``freqs (s, 1, 1, rot)`` of angles;
- cached: precomputed ``cos``/``sin (s, 1, 1, rot)``;
- thd: packed varlen ``t (tokens, h, d)`` with ``cu_seqlens`` (positions
  restart at each boundary);
- 2d: ``t (b, h*w, heads, d)``, rows rotated by their row position on
  the first half of d and by their column on the second.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from apex_tpu_torch import _build
from apex_tpu_torch._backend import check_kernel_input, uses_kernel

KERNEL = "rope"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


# -- plain version ------------------------------------------------------------


def _rotate_half(t: torch.Tensor) -> torch.Tensor:
    d = t.shape[-1] // 2
    return torch.cat([-t[..., d:], t[..., :d]], dim=-1)


def _apply_torch(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
                 ) -> torch.Tensor:
    """Rotate the leading rot channels of t by fp32 cos/sin (broadcast
    against them); pass the rest through (the reference's ``_apply``)."""
    rot = cos.shape[-1]
    t_rot, t_pass = t[..., :rot], t[..., rot:]
    out = t_rot.float() * cos + _rotate_half(t_rot).float() * sin
    out = out.to(t.dtype)
    if t_pass.shape[-1]:
        out = torch.cat([out, t_pass], dim=-1)
    return out


def _thd_positions(cu_seqlens: torch.Tensor, tokens: int,
                   table_rows: int) -> torch.Tensor:
    """Each token's position in its sequence (the reference's
    searchsorted, :171-174), as a JAX gather reads it: a negative index
    wraps once, then every index is clamped into the table."""
    idx = torch.arange(tokens, device=cu_seqlens.device,
                       dtype=cu_seqlens.dtype)
    seq = torch.searchsorted(cu_seqlens, idx, right=True) - 1
    pos = (idx - cu_seqlens[seq]).long()
    pos = torch.where(pos < 0, pos + table_rows, pos)
    return pos.clamp(0, table_rows - 1)


# -- kernel -------------------------------------------------------------------


def _table_strides(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                   thd: bool):
    """The kernel's view of the tables: ``(cos, sin, tsn, mids)``, the
    tables with a contiguous channel axis (one layout for both), the
    element stride along positions and ``(size, stride)`` of each middle
    dimension of ``t``, 0 where the table broadcasts. A 2-D table (rows,
    rot) broadcasts over every middle dimension; otherwise it has t's
    rank, each dimension 1 or t's (the position axis: t's, 1, or, for
    thd, any number of rows that positions index). Raises on any other
    shape."""
    n, rot = t.shape[0], cos.shape[-1]
    mid = tuple(t.shape[1:-1])
    if cos.ndim == 2:
        cos, sin = (x.reshape(x.shape[0], *([1] * len(mid)), rot)
                    for x in (cos, sin))
    ok = cos.ndim == t.ndim and all(
        c in (1, m) for c, m in zip(cos.shape[1:-1], mid))
    if not thd:
        ok = ok and cos.shape[0] in (1, n)
    if not ok:
        raise ValueError(
            f"cos/sin {tuple(cos.shape)} do not broadcast against t "
            f"{tuple(t.shape)}: each dimension must be 1 or t's (the "
            f"position axis t's or 1), the last the rotated width")
    if len(mid) > 3:
        raise ValueError(f"t {tuple(t.shape)}: the kernel takes at most "
                         f"three dimensions between positions and channels")
    if cos.stride() != sin.stride() or cos.stride(-1) != 1:
        cos, sin = cos.contiguous(), sin.contiguous()
    tsn = 0 if cos.shape[0] == 1 else cos.stride(0)
    mids = [(m, 0 if c == 1 else st) for m, c, st in
            zip(mid, cos.shape[1:-1], cos.stride()[1:-1])]
    return cos, sin, tsn, mids


def _rope_cuda(t: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               cu_seqlens: Optional[torch.Tensor] = None,
               negate: bool = False) -> torch.Tensor:
    """The kernel: ``t`` (n, ..., d); ``cos``/``sin`` the fp32 tables of
    one shape, broadcasting against t (each dimension 1 or t's, the last
    the rotated width ``rot``; a 2-D (rows, rot) table broadcasts over
    every middle dimension) and read through their element strides, or,
    with ``cu_seqlens`` (thd), tables whose rows each token indexes by
    its position in its sequence. ``negate`` rotates by -sin (the
    backward)."""
    dev = t.device
    check_kernel_input("t", t, tuple(_DTYPE_CODES), dev)
    n, d = t.shape[0], t.shape[-1]
    rot = cos.shape[-1]
    if rot % 2 or rot > d:
        raise ValueError(f"the rotated width {rot} must be even and at "
                         f"most the head width {d}")
    for name, tab in (("cos", cos), ("sin", sin)):
        if tab.device != dev:
            raise ValueError(f"{name} is on {tab.device}, expected {dev}")
        if tab.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {tab.dtype}; the kernel "
                            "takes torch.float32")
        if tab.shape != cos.shape:
            raise ValueError(f"{name} {tuple(tab.shape)} does not match "
                             f"cos {tuple(cos.shape)}")
    cos, sin, tsn, mids = _table_strides(t, cos, sin, cu_seqlens is not None)
    for name, tab in (("cos", cos), ("sin", sin)):
        if tab.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    table_rows = cos.shape[0]
    nseq = 0
    if cu_seqlens is not None:
        check_kernel_input("cu_seqlens", cu_seqlens, (torch.int32,), dev)
        nseq = cu_seqlens.numel() - 1
        if cu_seqlens.ndim != 1 or nseq < 0:
            raise ValueError("cu_seqlens must be a 1-D (nseq + 1,) tensor")
    out = torch.empty_like(t)
    rows = t.numel() // max(n * d, 1)
    if t.numel() == 0:
        return out
    if table_rows == 0:
        raise ValueError("empty cos/sin tables")
    # only the middle dimensions a table varies along need an offset
    sizes = [m for m, _ in mids] + [1] * (3 - len(mids))
    strides = [st for _, st in mids] + [0] * (3 - len(mids))
    nmid = len(mids) if any(strides) else 0
    P, I, L = _build.P, _build.I, _build.L
    lib = _build.library("rope", "apex_rope",
                         (P, P, P, P, I, I, L, I, I, I, I, L, L, L, P, L, I,
                          I, I, I, I, P),
                         "apex_rope_error_string")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.apex_rope(
            t.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            None if cu_seqlens is None else cu_seqlens.data_ptr(), nseq,
            table_rows, tsn, nmid, *sizes, *strides, out.data_ptr(), n,
            rows, d, rot, int(negate), _DTYPE_CODES[t.dtype], stream)
    if err:
        raise RuntimeError(f"{KERNEL}: CUDA error {err} at launch: "
                           f"{lib.apex_rope_error_string(err).decode()}")
    _build.count_launch(KERNEL)
    return out


def _run(t, cos, sin, cu_seqlens, kernel, negate=False):
    if kernel:
        return _rope_cuda(t, cos, sin, cu_seqlens, negate)
    return _apply_torch(t, cos, -sin if negate else sin)


class _RopeFn(torch.autograd.Function):
    """The reference's ``custom_vjp`` around the rotation: saves only the
    tables (and thd's ``cu_seqlens``); the backward rotates by -sin."""

    @staticmethod
    def forward(ctx, t, cos, sin, cu_seqlens, kernel):
        ctx.save_for_backward(cos, sin, cu_seqlens)
        ctx.kernel = kernel
        return _run(t, cos, sin, cu_seqlens, kernel)

    @staticmethod
    def backward(ctx, g):
        cos, sin, cu_seqlens = ctx.saved_tensors
        if ctx.kernel:
            g = g.contiguous()
        return _run(g, cos, sin, cu_seqlens, ctx.kernel, negate=True), \
            None, None, None, None


def _rope(t, cos, sin, cu_seqlens, kernel) -> torch.Tensor:
    cos, sin = cos.detach(), sin.detach()
    if torch.is_grad_enabled() and t.requires_grad:
        return _RopeFn.apply(t, cos, sin, cu_seqlens, kernel)
    return _run(t, cos, sin, cu_seqlens, kernel)


def fused_apply_rotary_pos_emb(t: torch.Tensor, freqs: torch.Tensor,
                               transpose_output_memory: bool = False
                               ) -> torch.Tensor:
    """sbhd variant: ``t`` (s, b, h, d), ``freqs`` (s, 1, 1, rot) of
    angles; cos and sin are taken here, in freqs' dtype, then cast to
    fp32. ``transpose_output_memory`` is accepted and ignored, as in the
    reference (the output is contiguous like ``t``)."""
    del transpose_output_memory
    cos = torch.cos(freqs).float()
    sin = torch.sin(freqs).float()
    return _rope(t, cos, sin, None, uses_kernel(t))


def fused_apply_rotary_pos_emb_cached(
        t: torch.Tensor, cos_: torch.Tensor, sin_: torch.Tensor,
        transpose_output_memory: bool = False) -> torch.Tensor:
    """Cached variant: precomputed ``cos_``/``sin_`` (s, 1, 1, rot), taken
    in fp32."""
    del transpose_output_memory
    return _rope(t, cos_.float(), sin_.float(), None, uses_kernel(t))


def fused_apply_rotary_pos_emb_thd(t: torch.Tensor, cu_seqlens: torch.Tensor,
                                   freqs: torch.Tensor) -> torch.Tensor:
    """Packed varlen variant: ``t`` (tokens, h, d); ``cu_seqlens``
    (nseq + 1,) cumulative sequence boundaries; ``freqs`` (s_max, 1, 1,
    rot). Each sequence's positions restart at 0. The (s_max, rot) cos
    and sin tables are taken once; on a CUDA tensor the kernel reads their
    rows by each token's position (no (tokens, rot) table), on the CPU the
    plain version indexes them by position first. Both equal the
    reference's cos and sin of the gathered angles: cos is elementwise."""
    angles = freqs.reshape(freqs.shape[0], -1)
    cos = torch.cos(angles).float()
    sin = torch.sin(angles).float()
    if uses_kernel(t):
        return _rope(t, cos, sin, cu_seqlens.to(torch.int32), True)
    pos = _thd_positions(cu_seqlens, t.shape[0], angles.shape[0])
    return _rope(t, cos[pos][:, None, :], sin[pos][:, None, :], None, False)


def fused_apply_rotary_pos_emb_2d(
        t: torch.Tensor, img_h: int, img_w: int,
        cos_h: torch.Tensor, sin_h: torch.Tensor,
        cos_w: torch.Tensor, sin_w: torch.Tensor) -> torch.Tensor:
    """2D image variant: ``t`` (b, img_h * img_w, heads, d); the first
    half of d is rotated by each pixel's row (``cos_h``/``sin_h``, img_h
    rows of d/2), the second half by its column (``cos_w``/``sin_w``).

    Plain PyTorch on every device, by design: the reference keeps this
    variant on XLA in every impl (its cos/sin broadcast along interior
    dims, which the row kernel does not take). Its gradient is the
    reference's -sin rotation, like the other variants'."""
    b, hw, heads, d = t.shape
    if hw != img_h * img_w:
        raise ValueError(f"t has {hw} pixels, not {img_h} x {img_w}")
    half = d // 2
    th = t[..., :half].reshape(b, img_h, img_w, heads, half)
    tw = t[..., half:].reshape(b, img_h, img_w, heads, half)
    ch = cos_h.reshape(1, img_h, 1, 1, half).float()
    sh = sin_h.reshape(1, img_h, 1, 1, half).float()
    cw = cos_w.reshape(1, 1, img_w, 1, half).float()
    sw = sin_w.reshape(1, 1, img_w, 1, half).float()
    oh = _rope(th, ch, sh, None, False)
    ow = _rope(tw, cw, sw, None, False)
    return torch.cat([oh, ow], dim=-1).reshape(b, hw, heads, d)


__all__ = ["fused_apply_rotary_pos_emb", "fused_apply_rotary_pos_emb_2d",
           "fused_apply_rotary_pos_emb_cached",
           "fused_apply_rotary_pos_emb_thd"]
