"""Flash attention over (batch, heads, seq, head_dim), forward and
backward.

Counterpart of ``flash_attention`` in ``apex_tpu/ops/attention.py``. On
a CUDA tensor the forward runs the hand-written kernel in
``csrc/flash_fwd.cu`` (the port of the Pallas ``_fwd_kernel``) and the
backward the two kernels in ``csrc/flash_bwd.cu`` (``_bwd_dq_kernel`` and
``_bwd_dkv_kernel``); on a CPU tensor they run :func:`_attention_torch`
and :func:`_flash_bwd_torch`, the plain PyTorch versions. A call that
autograd has to differentiate goes through ``_FlashFn``, the counterpart
of the reference's ``custom_vjp`` (``_flash_fwd_rule`` /
``_flash_bwd_rule``): the forward saves ``(q, k, v, out, lse)``, the
backward forms ``delta = rowsum(out * dO)`` in PyTorch (the reference
leaves it to XLA, :828) and recomputes the probabilities from the lse.

The kernels cover causal masking with the ``sk - sq`` offset (chunked
prefill), GQA, segment ids (packed batches and the decode context mask)
and the sliding window, with bf16 inputs and head_dim 32, 64 or 128. An
additive ``bias``, attention dropout, ``q_positions``/``kv_positions``
(ring attention) and the gradient of a returned lse stay in the plain
version for now, which differentiates them by ordinary autograd: on a
CUDA tensor they raise ``NotImplementedError``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from apex_tpu_torch import _build
from apex_tpu_torch._backend import check_kernel_input, uses_kernel

NEG_INF = -1e30
KERNEL = "flash_fwd"
BWD_DQ_KERNEL = "flash_bwd_dq"
BWD_DKV_KERNEL = "flash_bwd_dkv"
HEAD_DIMS = (32, 64, 128)


def _mask_full(sq: int, sk: int, causal: bool, window: Optional[int],
               q_pos, k_pos, device) -> torch.Tensor:
    """fp32 additive (sq, sk) mask — the reference's ``_mask_block`` for
    one block covering the whole matrix."""
    if q_pos is not None:
        # global positions (ring/blockwise chunks) replace the geometry
        row = torch.as_tensor(q_pos, device=device).reshape(sq, 1).long()
        col = torch.as_tensor(k_pos, device=device).reshape(1, sk).long()
        off = 0
    else:
        row = torch.arange(sq, device=device).reshape(sq, 1)
        col = torch.arange(sk, device=device).reshape(1, sk)
        off = sk - sq
    neg = torch.zeros((sq, sk), dtype=torch.float32, device=device)
    if causal:
        # query i attends to keys j <= i + (sk - sq)
        neg = torch.where(col > row + off, NEG_INF, neg)
    if window is not None:
        neg = torch.where(col <= row + off - window, NEG_INF, neg)
    return neg


_M32 = 0xFFFFFFFF


def _dropout_keep(seed: int, bh, row, col, rate: float) -> torch.Tensor:
    """The reference's counter-based keep mask (murmur3 finaliser of
    (seed, batch*head, row, col)), in uint32 arithmetic carried in
    int64 — bit-identical to ``_dropout_keep`` in
    ``apex_tpu/ops/attention.py``
    for the same uint32 seed."""
    x = ((row * 0x9E3779B1) & _M32) ^ ((col * 0x85EBCA77) & _M32)
    x = x ^ ((bh * 0xC2B2AE3D) & _M32)
    x = x ^ (int(seed) & _M32)
    x = x ^ (x >> 16)
    x = (x * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = (x * 0xC2B2AE35) & _M32
    x = x ^ (x >> 16)
    return x >= min(int(rate * 2.0 ** 32), 2 ** 32 - 1)


def _attention_torch(q, k, v, bias, q_seg, k_seg, scale, causal,
                     window=None, dropout_rate=0.0, dropout_seed=None,
                     return_lse=False, q_pos=None, k_pos=None):
    """Plain version: the whole (sq, sk) score matrix in fp32."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    hk = k.shape[1]
    if hk != h:
        # GQA over a kv-head-group axis — K/V are never repeated
        group = h // hk
        s = torch.einsum(
            "bkgqd,bkcd->bkgqc",
            (q.float() * scale).reshape(b, hk, group, sq, d),
            k.float()).reshape(b, h, sq, sk)
    else:
        s = torch.einsum("bhqd,bhkd->bhqk", q.float() * scale, k.float())
    if bias is not None:
        s = s + bias.float()
    if causal or window is not None:
        s = s + _mask_full(sq, sk, causal, window, q_pos, k_pos,
                           q.device)[None, None]
    if q_seg is not None:
        seg = q_seg[:, None, :, None] != k_seg[:, None, None, :]
        s = torch.where(seg, NEG_INF, s)
    m = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = torch.sum(e, dim=-1, keepdim=True)
    p = e / torch.where(l > 0.0, l, 1.0)
    # fully-masked rows emit 0 (the kernel's guard)
    p = torch.where(m > NEG_INF * 0.5, p, 0.0)
    if dropout_rate > 0.0:
        bh = torch.arange(b * h, device=q.device).reshape(b, h, 1, 1)
        row = torch.arange(sq, device=q.device).reshape(1, 1, sq, 1)
        col = torch.arange(sk, device=q.device).reshape(1, 1, 1, sk)
        keep = _dropout_keep(dropout_seed, bh, row, col, dropout_rate)
        p = torch.where(keep, p / (1.0 - dropout_rate), 0.0)
    if hk != h:
        out = torch.einsum(
            "bkgqc,bkcd->bkgqd", p.reshape(b, hk, h // hk, sq, sk),
            v.float()).reshape(b, h, sq, d)
    else:
        out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    if return_lse:
        m0, l0 = m[..., 0], l[..., 0]
        lse = torch.where(m0 > NEG_INF * 0.5,
                          m0 + torch.log(torch.where(l0 > 0.0, l0, 1.0)),
                          NEG_INF)
        return out.to(q.dtype), lse
    return out.to(q.dtype)


def _flash_bwd_torch(q, k, v, lse, dout, delta, q_seg, k_seg, scale,
                     causal, window):
    """Plain version of the two backward kernels: ``(dq, dk, dv)`` from
    the whole (sq, sk) matrix in fp32, with the kernels' arithmetic —
    P recomputed from the lse (clamped at NEG_INF / 2), dS rounded to
    the input dtype before its products, P rounded for dV (the
    reference's ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``). GQA sums dk
    and dv over each kv head's group."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    group = h // hk
    qg = q.float().reshape(b, hk, group, sq, d)
    og = dout.float().reshape(b, hk, group, sq, d)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bkgqd,bkcd->bkgqc", qg, kf) * scale
    neg = torch.zeros((b, sq, sk), dtype=torch.float32, device=q.device)
    if causal or window is not None:
        neg = neg + _mask_full(sq, sk, causal, window, None, None,
                               q.device)[None]
    if q_seg is not None:
        neg = torch.where(q_seg[:, :, None] != k_seg[:, None, :], NEG_INF,
                          neg)
    s = s + neg[:, None, None]
    lse_c = torch.clamp(lse, min=NEG_INF * 0.5).reshape(b, hk, group, sq, 1)
    p = torch.exp(s - lse_c)
    dp = torch.einsum("bkgqd,bkcd->bkgqc", og, vf)
    ds = p * (dp - delta.reshape(b, hk, group, sq, 1))
    ds = ds.to(q.dtype).float()
    dq = torch.einsum("bkgqc,bkcd->bkgqd", ds, kf) * scale
    dk = torch.einsum("bkgqc,bkgqd->bkcd", ds, qg) * scale
    dv = torch.einsum("bkgqc,bkgqd->bkcd", p.to(dout.dtype).float(), og)
    return (dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def _check_kernel_args(q, k, v, q_seg, k_seg):
    """Raise on what the kernels do not take; returns the segment ids as
    contiguous int32 (or None)."""
    dev = q.device
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_kernel_input(name, t, (torch.bfloat16,), dev)
    b, d = q.shape[0], q.shape[3]
    if d not in HEAD_DIMS:
        raise NotImplementedError(
            f"head_dim {d}: the kernel is built for {HEAD_DIMS}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if q_seg is not None:
        q_seg = q_seg.to(torch.int32).contiguous()
        k_seg = k_seg.to(torch.int32).contiguous()
        check_kernel_input("segment_ids", q_seg, (torch.int32,), dev)
        check_kernel_input("kv_segment_ids", k_seg, (torch.int32,), dev)
    return q_seg, k_seg


def _flash_bwd_cuda(q, k, v, lse, dout, delta, q_seg, k_seg, scale,
                    causal, window, kernels=(BWD_DQ_KERNEL, BWD_DKV_KERNEL)):
    """The dq kernel and the dk/dv kernel: returns ``(dq, dk, dv)`` like
    ``_flash_bwd_pallas``. ``kernels`` names the ones to launch (both by
    default; one alone to time it); a kernel left out returns None for
    its outputs."""
    q_seg, k_seg = _check_kernel_args(q, k, v, q_seg, k_seg)
    dev = q.device
    dout = dout.contiguous()
    check_kernel_input("grad", dout, (torch.bfloat16,), dev)
    for name, t in (("lse", lse), ("delta", delta)):
        check_kernel_input(name, t, (torch.float32,), dev)
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    dq = torch.empty_like(q) if BWD_DQ_KERNEL in kernels else None
    dk, dv = ((torch.empty_like(k), torch.empty_like(v))
              if BWD_DKV_KERNEL in kernels else (None, None))
    P, I, F = _build.P, _build.I, _build.F
    lib = _build.library(
        "flash_bwd", "apex_flash_bwd",
        (P,) * 11 + (I,) * 6 + (F, I, I, P), "apex_flash_bwd_error_string")
    segs = (None if q_seg is None else q_seg.data_ptr(),
            None if k_seg is None else k_seg.data_ptr())
    launches = ((BWD_DQ_KERNEL, (dq, None, None)),
                (BWD_DKV_KERNEL, (None, dk, dv)))
    for kernel, outs in launches:
        if kernel not in kernels:
            continue
        outs = [None if t is None else t.data_ptr() for t in outs]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.apex_flash_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), *segs, *outs, b, h, hk,
                sq, sk, d, float(scale), int(causal),
                0 if window is None else int(window), stream)
        if err:
            raise RuntimeError(
                f"{kernel}: CUDA error {err} at launch: "
                f"{lib.apex_flash_bwd_error_string(err).decode()}")
        _build.count_launch(kernel)
    return dq, dk, dv


class _FlashFn(torch.autograd.Function):
    """The reference's ``custom_vjp`` around flash attention: the
    kernels on CUDA tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, k_seg, scale, causal, window, kernel):
        if kernel:
            out, lse = _flash_cuda(q, k, v, q_seg, k_seg, scale, causal,
                                   window)
        else:
            out, lse = _attention_torch(q, k, v, None, q_seg, k_seg, scale,
                                        causal, window, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, q_seg, k_seg)
        ctx.args = (scale, causal, window, kernel)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, q_seg, k_seg = ctx.saved_tensors
        scale, causal, window, kernel = ctx.args
        delta = torch.sum(out.float() * dout.float(), dim=-1)
        dq, dk, dv = (_flash_bwd_cuda if kernel else _flash_bwd_torch)(
            q, k, v, lse, dout, delta, q_seg, k_seg, scale, causal, window)
        return dq, dk, dv, None, None, None, None, None, None


def _library() -> ctypes.CDLL:
    P, I, F = _build.P, _build.I, _build.F
    return _build.library(
        "flash_fwd", "apex_flash_fwd",
        (P, P, P, P, P, P, P, I, I, I, I, I, I, F, I, I, P),
        "apex_flash_error_string")


def _flash_cuda(q, k, v, q_seg, k_seg, scale, causal, window):
    """The kernel: returns ``(out, lse)`` like ``_flash_fwd_pallas``."""
    q_seg, k_seg = _check_kernel_args(q, k, v, q_seg, k_seg)
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    dev = q.device
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    lib = _library()
    # the ctypes call launches on the current device: make it q's
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.apex_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if q_seg is None else q_seg.data_ptr(),
            None if k_seg is None else k_seg.data_ptr(),
            out.data_ptr(), lse.data_ptr(), b, h, hk, sq, sk, d,
            float(scale), int(causal), 0 if window is None else int(window),
            stream)
    if err:
        raise RuntimeError(f"{KERNEL}: CUDA error {err} at launch: "
                           f"{lib.apex_flash_error_string(err).decode()}")
    _build.count_launch(KERNEL)
    return out, lse


def _prepare(q, k, v, bias, segment_ids, kv_segment_ids, causal,
             window_size, softmax_scale, dropout_rate, dropout_rng,
             q_positions, kv_positions):
    """Validate the arguments and apply the reference's defaults
    (``flash_attention`` :995-1050); returns (scale, q_seg, k_seg,
    seed)."""
    if bias is not None:
        b, h, sq, sk = q.shape[0], q.shape[1], q.shape[2], k.shape[2]
        ok = (bias.ndim == 4
              and bias.shape[0] in (1, b) and bias.shape[1] in (1, h)
              and bias.shape[2] in (1, sq) and bias.shape[3] in (1, sk))
        if not ok:
            raise ValueError(
                f"bias must be 4-D with each dim 1 or full "
                f"({(b, h, sq, sk)}); got shape {tuple(bias.shape)}")
    if q.shape[1] % k.shape[1] or k.shape[1] != v.shape[1]:
        raise ValueError(
            f"kv heads ({k.shape[1]}/{v.shape[1]}) must be equal and "
            f"divide q heads ({q.shape[1]})")
    if (q_positions is None) != (kv_positions is None):
        raise ValueError("q_positions and kv_positions must be given together")
    if q_positions is not None and not causal:
        raise ValueError("positions only affect causal/window masking; "
                         "pass causal=True")
    if q_positions is not None and dropout_rate > 0.0:
        raise ValueError(
            "dropout_rate > 0 with q_positions/kv_positions is not "
            "supported: the dropout mask is keyed on local indices and "
            "would not match across chunked and unchunked calls")
    if window_size is not None:
        if not causal:
            raise ValueError("window_size requires causal=True")
        if window_size < 1:
            raise ValueError(f"window_size must be >= 1, got {window_size}")
    if softmax_scale is None:
        softmax_scale = q.shape[-1] ** -0.5
    if segment_ids is not None and kv_segment_ids is None:
        kv_segment_ids = segment_ids
    elif kv_segment_ids is not None and segment_ids is None:
        # key-side-only masking: queries are all segment 0 and attend
        # only to segment-0 keys
        segment_ids = torch.zeros((q.shape[0], q.shape[2]),
                                  dtype=kv_segment_ids.dtype,
                                  device=kv_segment_ids.device)
    if not (0.0 <= dropout_rate < 1.0):
        raise ValueError(f"dropout_rate must be in [0, 1), got {dropout_rate}")
    if dropout_rate > 0.0 and dropout_rng is None:
        raise ValueError("dropout_rate > 0 requires dropout_rng")
    return softmax_scale, segment_ids, kv_segment_ids, dropout_rng


def _attention(q, k, v, kernel: bool, *, bias=None, segment_ids=None,
               kv_segment_ids=None, causal=False, window_size=None,
               softmax_scale=None, dropout_rate=0.0, dropout_rng=None,
               return_lse=False, q_positions=None, kv_positions=None):
    scale, q_seg, k_seg, seed = _prepare(
        q, k, v, bias, segment_ids, kv_segment_ids, causal, window_size,
        softmax_scale, dropout_rate, dropout_rng, q_positions, kv_positions)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    unported = [name for name, on in (
        ("bias", bias is not None), ("dropout", dropout_rate > 0.0),
        ("q_positions/kv_positions", q_positions is not None),
        ("the gradient of a returned lse", grad and return_lse)) if on]
    if kernel and unported:
        raise NotImplementedError(
            f"flash_attention with {', '.join(unported)} has no CUDA "
            "kernel yet (dropout and ring-attention slices of the port); "
            "it runs only on CPU tensors")
    if grad and not unported:
        return _FlashFn.apply(q, k, v, q_seg, k_seg, scale, causal,
                              window_size, kernel)
    if kernel:
        out, lse = _flash_cuda(q, k, v, q_seg, k_seg, scale, causal,
                               window_size)
        return (out, lse) if return_lse else out
    return _attention_torch(q, k, v, bias, q_seg, k_seg, scale, causal,
                            window_size, dropout_rate, seed,
                            return_lse=return_lse, q_pos=q_positions,
                            k_pos=kv_positions)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    bias: Optional[torch.Tensor] = None,
                    segment_ids: Optional[torch.Tensor] = None,
                    kv_segment_ids: Optional[torch.Tensor] = None,
                    causal: bool = False,
                    window_size: Optional[int] = None,
                    softmax_scale: Optional[float] = None,
                    dropout_rate: float = 0.0,
                    dropout_rng: Optional[int] = None,
                    return_lse: bool = False,
                    q_positions: Optional[torch.Tensor] = None,
                    kv_positions: Optional[torch.Tensor] = None):
    """Attention over q (b, h, sq, d) and k, v (b, hk, sk, d), hk
    dividing h (GQA shares each kv head across its group of q heads).

    ``segment_ids`` (b, sq) / ``kv_segment_ids`` (b, sk): a query sees
    only keys of its own segment (either defaults from the other, as in
    the reference). ``causal`` lets query i see keys j <= i + (sk - sq);
    ``window_size=w`` further restricts it to its last ``w`` keys.
    ``return_lse=True`` also returns the fp32 (b, h, sq) log-sum-exp
    (``NEG_INF`` on fully-masked rows). ``dropout_rng`` is the uint32
    seed of the counter-based dropout mask (plain version only)."""
    return _attention(
        q, k, v, uses_kernel(q), bias=bias, segment_ids=segment_ids,
        kv_segment_ids=kv_segment_ids, causal=causal,
        window_size=window_size, softmax_scale=softmax_scale,
        dropout_rate=dropout_rate, dropout_rng=dropout_rng,
        return_lse=return_lse, q_positions=q_positions,
        kv_positions=kv_positions)


def attention_plain(q, k, v, **kw):
    """:func:`flash_attention` through the plain versions on any device
    — the yardstick the kernels are held against on the card. Takes the
    same keywords."""
    return _attention(q, k, v, False, **kw)


__all__ = ["NEG_INF", "attention_plain", "flash_attention"]
