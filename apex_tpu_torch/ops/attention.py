"""Flash attention over (batch, heads, seq, head_dim), forward and
backward.

Counterpart of ``flash_attention`` in ``apex_tpu/ops/attention.py``. On
a CUDA tensor the forward runs the hand-written kernel in
``csrc/flash_fwd.cu`` (the port of the Pallas ``_fwd_kernel``) and the
backward the two kernels in ``csrc/flash_bwd.cu`` (``_bwd_dq_kernel`` and
``_bwd_dkv_kernel``; one library a dtype); on a CPU tensor they run
:func:`_attention_torch` and :func:`_flash_bwd_torch`, the plain PyTorch
versions. A call that
autograd has to differentiate goes through ``_FlashFn``, the counterpart
of the reference's ``custom_vjp`` (``_flash_fwd_rule`` /
``_flash_bwd_rule``, and with ``return_lse=True`` ``_flash_lse_fwd_rule``
/ ``_flash_lse_bwd_rule``): the forward saves ``(q, k, v, out, lse)``
(and in fp32 the bf16 part planes of q, k and v its kernel read), the
backward forms ``delta = rowsum(out * dO)`` in PyTorch (the reference
leaves it to XLA, :828), recomputes the probabilities from the lse and
passes the lse's cotangent ``glse`` to the kernels; the bias's gradient
is recomputed in PyTorch (:func:`_dbias`, the reference's ``_finish_bwd``
:835-892, which runs outside any ``pallas_call``).

The kernels cover causal masking with the ``sk - sq`` offset (chunked
prefill), GQA, segment ids (packed batches and the decode context mask),
the sliding window, an additive bias (each dimension full or broadcast,
fp32, bf16 or fp16), global ``q_positions``/``kv_positions`` (ring and
blockwise chunks: the causal and window tests compare positions, and
tiles are skipped by their position bounds) and attention dropout, with
bf16, fp16 or fp32 inputs and any head_dim >= 1. Up to 256 in bf16 and
fp16 and up to 128 in fp32 the wgmma/TMA kernels run (zero-padded inside
the kernels to the next built width, :data:`BUILT_WIDTHS`); past those
widths (:func:`wide_route`, by dtype and head_dim alone) the three kernels
of ``csrc/flash_wide.cu`` run instead: fp32 arithmetic on the CUDA cores
over D in 64-column chunks, the same feature set, launches counted under
``flash_fwd_wide``, ``flash_bwd_dq_wide`` and ``flash_bwd_dkv_wide``.
The bf16 and fp16 forward and backward are the wgmma/TMA designs of
``csrc/flash_fwd_sm90.cuh`` and ``csrc/flash_bwd_sm90.cuh``, whose tiles
TMA copies (a head_dim off :func:`tma_width` is padded with zero columns
on the way in and cut on the way out, :func:`pad_head_dim`). The fp32
forward and backward are the wgmma/TMA designs of
``csrc/flash_fwd32_sm90.cuh`` and ``csrc/flash_bwd32_sm90.cuh``: exact
products from three bf16 parts a value, which a split pass
(:func:`_split3_cuda`, ``csrc/flash_split3.cu``, its own launch and
counter) writes as bf16 planes already padded to :func:`tma_width`; a
differentiated fp32 call splits q, k and v once, in the forward, and dO
in the backward. Launch counts are kept
per dtype: bf16 under the kernel's name, fp16 and fp32 with a ``_fp16`` /
``_fp32`` suffix
(:func:`kernel_name`). Dropout is the reference's
counter-based mask (:func:`_dropout_keep`, the murmur3 finaliser of the
seed, the flat q-head index and the global query row and key column),
regenerated in the forward and both backward kernels from one uint32
seed: the forward's normaliser sums the undropped probabilities and only
``P V`` takes ``keep ? P / (1 - rate) : 0``; the backward drops ``dP``
and the ``P`` of ``dV``.
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
# the fp32 kernels' split pass (fp32 only: no dtype suffix)
SPLIT_KERNEL = "flash_split3"
# the wide route's kernels (csrc/flash_wide.cu), per-dtype suffixes as above
WIDE_KERNEL = "flash_fwd_wide"
WIDE_DQ_KERNEL = "flash_bwd_dq_wide"
WIDE_DKV_KERNEL = "flash_bwd_dkv_wide"
# head widths the wgmma kernels are built for; a narrower head_dim is
# zero-padded in shared memory to the next one. fp32 stops at 128: its three
# bf16 part tiles take 96 KB each at 256, so the dk/dv kernel's four would
# need 384 KB of shared memory against the card's 227 KB. Wider heads take
# the wide route.
BUILT_WIDTHS = (32, 64, 96, 128, 256)
MAX_HEAD_DIM = BUILT_WIDTHS[-1]
FP32_MAX_HEAD_DIM = 128
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SUFFIX = {torch.bfloat16: "", torch.float16: "_fp16",
           torch.float32: "_fp32"}


# the C signatures of the forward entries (`apex_flash_fwd`,
# `apex_flash_wide_fwd`) and of the backward ones (`apex_flash_bwd`,
# `apex_flash_wide_bwd`): pointers and the stream as c_void_p
_P, _I, _L, _U, _F = _build.P, _build.I, _build.L, _build.U, _build.F
FWD_ARGTYPES = ((_P,) * 8 + (_I, _L, _L, _L, _L) + (_P, _P) + (_I,) * 7
                + (_F, _I, _I, _I, _U, _U, _F, _P))
BWD_ARGTYPES = ((_P,) * 12 + (_I, _L, _L, _L, _L) + (_P,) * 3 + (_I,) * 7
                + (_F, _I, _I, _I, _U, _U, _F, _P))


def kernel_name(base: str, dtype: torch.dtype) -> str:
    """The launch counter of kernel ``base`` (``KERNEL``,
    ``BWD_DQ_KERNEL``, ``BWD_DKV_KERNEL``) at ``dtype``."""
    return base + _SUFFIX[dtype]


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
    return x >= _dropout_thresh(rate)


def _dropout_thresh(rate: float) -> int:
    return min(int(rate * 2.0 ** 32), 2 ** 32 - 1)


def _keep_divisor(rate: float, device) -> torch.Tensor:
    """``1 - rate`` in fp32 as a 0-d tensor on ``device``: the
    reference divides by it (a CUDA tensor divided by a host number is
    multiplied by its reciprocal instead)."""
    return torch.full((), 1.0 - rate, dtype=torch.float32, device=device)


def dropout_seed(dropout_rng) -> int:
    """The uint32 seed of the dropout mask, as the reference folds it
    (``flash_attention`` :1043-1050): a key's two words xor-ed (a (2,)
    tensor, array or pair), or a one-word seed (an int) as it is."""
    if isinstance(dropout_rng, int):
        return dropout_rng & _M32
    if isinstance(dropout_rng, torch.Tensor):
        words = dropout_rng.reshape(-1).tolist()
    elif hasattr(dropout_rng, "ravel"):
        words = dropout_rng.ravel().tolist()
    else:
        words = list(dropout_rng)
    if len(words) not in (1, 2):
        raise ValueError(f"dropout_rng must be a seed or a key of two "
                         f"words, got {len(words)} words")
    seed = int(words[0]) & _M32
    return seed ^ (int(words[1]) & _M32) if len(words) == 2 else seed


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
        p = torch.where(keep, p / _keep_divisor(dropout_rate, q.device),
                        0.0)
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


def _bias5(bias, hk: int, group: int) -> torch.Tensor:
    """``bias`` (b_b, h_b, sq_b, sk_b) in fp32, viewed over (batch, kv
    head, q head of the group, sq, sk) for broadcasting."""
    b_b, h_b, sq_b, sk_b = bias.shape
    if h_b == 1:
        return bias.float().reshape(b_b, 1, 1, sq_b, sk_b)
    return bias.float().reshape(b_b, hk, group, sq_b, sk_b)


def _ds_torch(q, k, v, lse, dout, delta, q_seg, k_seg, scale, causal,
              window, rate, seed, bias, glse, q_pos, k_pos, b0=0):
    """The backward's fp32 probabilities over (b, kv head, q head of the
    group, sq, sk): ``(p_v, ds)`` with ``p_v`` what multiplied V (the
    dropped P) and ``ds = P (dP - delta) + P glse`` (undropped P). ``b0``
    is the first batch row of this slice, for the dropout hash."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    group = h // hk
    qg = q.float().reshape(b, hk, group, sq, d)
    og = dout.float().reshape(b, hk, group, sq, d)
    s = torch.einsum("bkgqd,bkcd->bkgqc", qg, k.float()) * scale
    if bias is not None:
        s = s + _bias5(bias, hk, group)
    neg = torch.zeros((b, sq, sk), dtype=torch.float32, device=q.device)
    if causal or window is not None:
        neg = neg + _mask_full(sq, sk, causal, window, q_pos, k_pos,
                               q.device)[None]
    if q_seg is not None:
        neg = torch.where(q_seg[:, :, None] != k_seg[:, None, :], NEG_INF,
                          neg)
    s = s + neg[:, None, None]
    lse_c = torch.clamp(lse, min=NEG_INF * 0.5).reshape(b, hk, group, sq, 1)
    p = torch.exp(s - lse_c)
    dp = torch.einsum("bkgqd,bkcd->bkgqc", og, v.float())
    p_v = p
    if rate > 0.0:
        # flat q-head index b * h + kv head * group + g, global indices
        bh = torch.arange(b0 * h, (b0 + b) * h,
                          device=q.device).reshape(b, hk, group, 1, 1)
        row = torch.arange(sq, device=q.device).reshape(sq, 1)
        col = torch.arange(sk, device=q.device).reshape(1, sk)
        keep = _dropout_keep(seed, bh, row, col, rate)
        div = _keep_divisor(rate, q.device)
        p_v = torch.where(keep, p / div, 0.0)
        dp = torch.where(keep, dp / div, 0.0)
    ds = p * (dp - delta.reshape(b, hk, group, sq, 1))
    if glse is not None:
        # lse is an output too: dlse_i / ds_ij = p_ij, undropped
        ds = ds + p * glse.float().reshape(b, hk, group, sq, 1)
    return p_v, ds


def _flash_bwd_torch(q, k, v, lse, dout, delta, q_seg, k_seg, scale,
                     causal, window, rate=0.0, seed=None, *, bias=None,
                     glse=None, q_pos=None, k_pos=None):
    """Plain version of the two backward kernels: ``(dq, dk, dv)`` from
    the whole (sq, sk) matrix in fp32, with the kernels' arithmetic —
    P recomputed from the lse (clamped at NEG_INF / 2), dS rounded to
    the input dtype before its products, P rounded for dV (the
    reference's ``_bwd_dq_kernel`` / ``_bwd_dkv_kernel``). GQA sums dk
    and dv over each kv head's group. With dropout (the reference's
    ``_finish_bwd`` :876-880 and the kernels): ``dP`` and the ``P`` of
    ``dV`` become ``keep ? x / (1 - rate) : 0``, ``dS`` keeps the
    undropped ``P``. ``bias`` and the positions mask the scores as in
    the forward; ``glse``, the cotangent of the lse, adds ``P glse`` to
    ``dS``."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    group = h // hk
    p_v, ds = _ds_torch(q, k, v, lse, dout, delta, q_seg, k_seg, scale,
                        causal, window, rate, seed, bias, glse, q_pos, k_pos)
    ds = ds.to(q.dtype).float()
    qg = q.float().reshape(b, hk, group, sq, d)
    og = dout.float().reshape(b, hk, group, sq, d)
    dq = torch.einsum("bkgqc,bkcd->bkgqd", ds, k.float()) * scale
    dk = torch.einsum("bkgqc,bkgqd->bkcd", ds, qg) * scale
    dv = torch.einsum("bkgqc,bkgqd->bkcd", p_v.to(dout.dtype).float(), og)
    return (dq.reshape(b, h, sq, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


# fp32 scores one slice of the bias gradient's recompute may hold
DBIAS_CHUNK_ELEMS = 1 << 26


def _dbias(q, k, v, bias, lse, dout, delta, q_seg, k_seg, scale, causal,
           window, rate, seed, glse, q_pos, k_pos) -> torch.Tensor:
    """The bias's gradient, in its own (broadcast) shape and dtype: fp32
    ``dS`` recomputed a slice of batch rows at a time (at most
    ``DBIAS_CHUNK_ELEMS`` scores live) and summed over every dimension
    the bias broadcasts. The reference's ``_finish_bwd`` (:835-892)
    recomputes it per (batch, head) slice in XLA, outside any
    ``pallas_call``; it is not a kernel of the port either."""
    b, h, sq, _ = q.shape
    sk = k.shape[2]
    b_b, h_b, sq_b, sk_b = bias.shape
    acc = torch.zeros(bias.shape, dtype=torch.float32, device=q.device)
    dims = [i for i, n in enumerate((h_b, sq_b, sk_b), 1) if n == 1]
    step = max(1, DBIAS_CHUNK_ELEMS // (h * sq * sk))
    for b0 in range(0, b, step):
        sl = slice(b0, min(b, b0 + step))
        bias_sl = bias[sl] if b_b > 1 else bias
        _, ds = _ds_torch(
            q[sl], k[sl], v[sl], lse[sl], dout[sl], delta[sl],
            None if q_seg is None else q_seg[sl],
            None if k_seg is None else k_seg[sl], scale, causal, window,
            rate, seed, bias_sl, None if glse is None else glse[sl],
            q_pos, k_pos, b0=b0)
        ds = ds.reshape(ds.shape[0], h, sq, sk)
        if dims:
            ds = ds.sum(dim=dims, keepdim=True)
        if b_b == 1:
            acc += ds.sum(dim=0, keepdim=True)
        else:
            acc[sl] += ds
    return acc.to(bias.dtype)


def check_head_dim(d: int, dtype: torch.dtype) -> None:
    """Raise unless head_dim ``d`` is at least 1: every width has a kernel
    (the wgmma ones to 256 in bf16 and fp16 and to 128 in fp32, the wide
    route past them)."""
    if d < 1:
        raise ValueError(f"head_dim {d}: the kernels take head_dim >= 1")


def wide_route(d: int, dtype: torch.dtype) -> bool:
    """Whether head_dim ``d`` at ``dtype`` runs the wide route
    (``csrc/flash_wide.cu``): fp32 past 128, bf16 and fp16 past 256 — the
    widths no wgmma kernel is built for. Decided by width and dtype alone:
    no call takes this route because another kernel failed."""
    limit = FP32_MAX_HEAD_DIM if dtype == torch.float32 else MAX_HEAD_DIM
    return d > limit


def tma_width(d: int) -> int:
    """The head width the bf16/fp16 kernels read: ``d`` rounded up to a
    multiple of 8 and at least 32 (TMA copies need 16-byte row strides;
    narrower boxes are zero-filled)."""
    return max(32, -(-d // 8) * 8)


def kernel_width(d: int, dtype: torch.dtype) -> int:
    """The head width the kernels of ``dtype`` read: ``d`` itself on the
    wide route, else :func:`tma_width`: bf16's and fp16's wrappers pad q,
    k, v (and dO) to it (:func:`pad_head_dim`), fp32's split pass writes its
    planes at it while the fp32 tensors and outputs keep ``d``."""
    return d if wide_route(d, dtype) else tma_width(d)


def pad_head_dim(tensors, width: int):
    """Each tensor (None passes through) with zero columns appended to
    ``width``: they add nothing to q.k, and the output and gradient
    columns they give are cut again."""
    return [t if t is None or t.shape[-1] == width else
            torch.nn.functional.pad(t, (0, width - t.shape[-1]))
            for t in tensors]


def _split3_torch(x: torch.Tensor, width: int) -> torch.Tensor:
    """Plain version of the split pass: fp32 ``x`` (..., d) as its three
    bf16 parts (3, ..., width), ``x = hi + mid + lo`` with ``hi`` and
    ``mid`` the round-to-nearest bf16 of ``x`` and of ``x - hi``, ``lo``
    that of ``(x - hi) - mid`` (``split3`` in ``csrc/flash_common.cuh``);
    columns d .. width - 1 zero."""
    x = x.float()
    hi = x.bfloat16().float()
    r = x - hi
    mid = r.bfloat16().float()
    planes = torch.stack([hi, mid, r - mid]).bfloat16()
    return torch.nn.functional.pad(planes, (0, width - x.shape[-1]))


def _split3_cuda(ts, width: int):
    """The split pass over up to four fp32 CUDA tensors in one launch:
    each tensor's planes, as :func:`_split3_torch` returns them."""
    dev = ts[0].device
    for i, t in enumerate(ts):
        check_kernel_input(f"split input {i}", t, (torch.float32,), dev)
    d = ts[0].shape[-1]
    if any(t.shape[-1] != d for t in ts) or not 1 <= len(ts) <= 4:
        raise ValueError("the split pass takes one to four tensors of one "
                         "head_dim")
    planes = [torch.empty((3, *t.shape[:-1], width), dtype=torch.bfloat16,
                          device=dev) for t in ts]
    P, I, L = _build.P, _build.I, _build.L
    lib = _build.library("flash_split3", "apex_flash_split3",
                         (P,) * 8 + (L,) * 4 + (I, I, P),
                         "apex_flash_split3_error_string")
    pad = [None] * (4 - len(ts))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.apex_flash_split3(
            *[t.data_ptr() for t in ts], *pad,
            *[p.data_ptr() for p in planes], *pad,
            *[t.numel() // d for t in ts], *([0] * len(pad)), d, width,
            stream)
    if err:
        raise RuntimeError(
            f"{SPLIT_KERNEL}: CUDA error {err} at launch: "
            f"{lib.apex_flash_split3_error_string(err).decode()}")
    _build.count_launch(SPLIT_KERNEL)
    return planes


def _check_planes(planes, ts, width: int) -> None:
    """Raise unless ``planes`` are what :func:`_split3_cuda` gives for
    ``ts`` at ``width``: one contiguous bf16 (3, ..., width) tensor a
    tensor, on its device, that the kernels' tensor maps may read."""
    if len(planes) != len(ts):
        raise ValueError(f"{len(planes)} planes for {len(ts)} tensors")
    for i, (p, t) in enumerate(zip(planes, ts)):
        check_kernel_input(f"planes {i}", p, (torch.bfloat16,), t.device)
        want = (3, *t.shape[:-1], width)
        if tuple(p.shape) != want:
            raise ValueError(f"planes {i} have shape {tuple(p.shape)}, "
                             f"expected {want}")


def _check_kernel_args(q, k, v, q_seg, k_seg):
    """Raise on what the kernels do not take; returns the segment ids as
    contiguous int32 (or None)."""
    dev = q.device
    check_kernel_input("q", q, tuple(DTYPE_CODES), dev)
    for name, t in (("k", k), ("v", v)):
        check_kernel_input(name, t, (q.dtype,), dev)
    b, d = q.shape[0], q.shape[3]
    check_head_dim(d, q.dtype)
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if q_seg is not None:
        q_seg = q_seg.to(torch.int32).contiguous()
        k_seg = k_seg.to(torch.int32).contiguous()
        check_kernel_input("segment_ids", q_seg, (torch.int32,), dev)
        check_kernel_input("kv_segment_ids", k_seg, (torch.int32,), dev)
    return q_seg, k_seg


def _extra_args(q, bias, q_pos, k_pos):
    """The kernels' position and bias arguments: ``(q_pos, k_pos, bias,
    bias_dtype, sb, sh, sq, sk)``, pointers or None. The bias is read
    through its own element strides, 0 on each dimension of size 1, so a
    broadcast or expanded bias is never copied."""
    dev = q.device
    pos = []
    for name, t in (("q_positions", q_pos), ("kv_positions", k_pos)):
        if t is not None:
            check_kernel_input(name, t, (torch.int32,), dev)
        pos.append(None if t is None else t.data_ptr())
    if bias is None:
        return (*pos, None, 0, 0, 0, 0, 0)
    if bias.device != dev:
        raise ValueError(f"bias is on {bias.device}, expected {dev}")
    if bias.dtype not in DTYPE_CODES:
        raise TypeError(f"bias has dtype {bias.dtype}; the kernels take "
                        f"{', '.join(str(d) for d in DTYPE_CODES)}")
    strides = [0 if n == 1 else st for n, st in zip(bias.shape,
                                                    bias.stride())]
    return (*pos, bias.data_ptr(), DTYPE_CODES[bias.dtype], *strides)


def _dropout_args(rate: float, seed):
    """The kernels' dropout arguments: (on, seed, thresh, keep)."""
    if rate <= 0.0:
        return 0, 0, 0, 1.0
    keep = torch.tensor(1.0 - rate, dtype=torch.float32).item()
    return 1, int(seed) & _M32, _dropout_thresh(rate), keep


def _flash_bwd_cuda(q, k, v, lse, dout, delta, q_seg, k_seg, scale,
                    causal, window, rate=0.0, seed=None,
                    kernels=(BWD_DQ_KERNEL, BWD_DKV_KERNEL), *, bias=None,
                    glse=None, q_pos=None, k_pos=None, planes=None):
    """The dq kernel and the dk/dv kernel: returns ``(dq, dk, dv)`` like
    ``_flash_bwd_pallas``. ``kernels`` names the ones to launch (both by
    default; one alone to time it); a kernel left out returns None for
    its outputs. ``glse`` (fp32, like lse) is the cotangent of the lse.
    bf16 and fp16 run the wgmma/TMA kernels (``csrc/flash_bwd_sm90.cuh``),
    whose tiles TMA copies: a head_dim off :func:`tma_width` is padded
    with zero columns on the way in and cut on the way out. fp32 runs
    ``csrc/flash_bwd32_sm90.cuh`` on the bf16 part planes of q, k, v and
    dO: ``planes`` gives those of q, k and v (the forward's; dO is then
    split alone, one launch) or of all four, as :func:`_split3_cuda`
    returns them; without it the split pass writes all four (one
    launch)."""
    q_seg, k_seg = _check_kernel_args(q, k, v, q_seg, k_seg)
    dev = q.device
    dout = dout.contiguous()
    check_kernel_input("grad", dout, (q.dtype,), dev)
    for name, t in (("lse", lse), ("delta", delta), ("glse", glse)):
        check_kernel_input(name, t, (torch.float32,), dev)
    extra = _extra_args(q, bias, q_pos, k_pos)
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    if wide_route(d, q.dtype):
        if planes is not None:
            raise ValueError("the wide route reads q, k, v themselves, no "
                             "part planes")
        return _flash_wide_bwd_cuda(q, k, v, lse, dout, delta, q_seg, k_seg,
                                    scale, causal, window, rate, seed,
                                    kernels, extra, glse)
    width = kernel_width(d, q.dtype)
    if q.dtype == torch.float32:
        # the kernels read the bf16 parts, rows padded to TMA's width; the
        # fp32 tensors and gradients keep d
        if planes is None:
            planes = _split3_cuda((q, k, v, dout), width)
        else:
            planes = list(planes)
            if len(planes) == 3:
                planes += _split3_cuda((dout,), width)
            _check_planes(planes, (q, k, v, dout), width)
        ins = [t.data_ptr() for t in planes]
        width = d
    else:
        q, k, v, dout = pad_head_dim((q, k, v, dout), width)
        ins = [t.data_ptr() for t in (q, k, v, dout)]
    dq = torch.empty_like(q) if BWD_DQ_KERNEL in kernels else None
    dk, dv = ((torch.empty_like(k), torch.empty_like(v))
              if BWD_DKV_KERNEL in kernels else (None, None))
    lib = _build.library("flash_bwd" + _SUFFIX[q.dtype], "apex_flash_bwd",
                         BWD_ARGTYPES, "apex_flash_bwd_error_string")
    segs = (None if q_seg is None else q_seg.data_ptr(),
            None if k_seg is None else k_seg.data_ptr())
    gl = None if glse is None else glse.data_ptr()
    drop = _dropout_args(rate, seed)
    launches = ((BWD_DQ_KERNEL, (dq, None, None)),
                (BWD_DKV_KERNEL, (None, dk, dv)))
    for kernel, outs in launches:
        if kernel not in kernels:
            continue
        outs = [None if t is None else t.data_ptr() for t in outs]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.apex_flash_bwd(
                *ins, lse.data_ptr(), delta.data_ptr(), *segs, *extra[:2], gl,
                *extra[2:], *outs, b, h, hk, sq, sk, width,
                DTYPE_CODES[q.dtype], float(scale),
                int(causal), 0 if window is None else int(window), *drop,
                stream)
        if err:
            raise RuntimeError(
                f"{kernel}: CUDA error {err} at launch: "
                f"{lib.apex_flash_bwd_error_string(err).decode()}")
        _build.count_launch(kernel_name(kernel, q.dtype))
    if width != d:
        dq, dk, dv = (None if t is None else t[..., :d].contiguous()
                      for t in (dq, dk, dv))
    return dq, dk, dv


def _wide_library() -> ctypes.CDLL:
    """The wide route's library (``csrc/flash_wide.cu``, every dtype):
    its two C entries take the arguments of ``apex_flash_fwd`` and
    ``apex_flash_bwd``."""
    _build.library("flash_wide", "apex_flash_wide_fwd", FWD_ARGTYPES,
                   "apex_flash_wide_error_string")
    return _build.library("flash_wide", "apex_flash_wide_bwd", BWD_ARGTYPES,
                          "apex_flash_wide_error_string")


def _flash_wide_cuda(q, k, v, q_seg, k_seg, scale, causal, window, rate,
                     seed, extra):
    """The wide route's forward (``flash_wide_fwd``): ``(out, lse)`` at
    q's own head_dim, no padding."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    dev = q.device
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    lib = _wide_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.apex_flash_wide_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if q_seg is None else q_seg.data_ptr(),
            None if k_seg is None else k_seg.data_ptr(), *extra,
            out.data_ptr(), lse.data_ptr(), b, h, hk, sq, sk, d,
            DTYPE_CODES[q.dtype], float(scale), int(causal),
            0 if window is None else int(window),
            *_dropout_args(rate, seed), stream)
    if err:
        raise RuntimeError(
            f"{WIDE_KERNEL}: CUDA error {err} at launch: "
            f"{lib.apex_flash_wide_error_string(err).decode()}")
    _build.count_launch(kernel_name(WIDE_KERNEL, q.dtype))
    return out, lse


def _flash_wide_bwd_cuda(q, k, v, lse, dout, delta, q_seg, k_seg, scale,
                         causal, window, rate, seed, kernels, extra, glse):
    """The wide route's dq and dk/dv kernels (``flash_wide_dq``,
    ``flash_wide_dkv``): ``kernels`` names them as for
    :func:`_flash_bwd_cuda` (``BWD_DQ_KERNEL``, ``BWD_DKV_KERNEL``); each
    launch counts under its wide name."""
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    dev = q.device
    dq = torch.empty_like(q) if BWD_DQ_KERNEL in kernels else None
    dk, dv = ((torch.empty_like(k), torch.empty_like(v))
              if BWD_DKV_KERNEL in kernels else (None, None))
    lib = _wide_library()
    segs = (None if q_seg is None else q_seg.data_ptr(),
            None if k_seg is None else k_seg.data_ptr())
    gl = None if glse is None else glse.data_ptr()
    drop = _dropout_args(rate, seed)
    launches = ((BWD_DQ_KERNEL, WIDE_DQ_KERNEL, (dq, None, None)),
                (BWD_DKV_KERNEL, WIDE_DKV_KERNEL, (None, dk, dv)))
    for kernel, counter, outs in launches:
        if kernel not in kernels:
            continue
        outs = [None if t is None else t.data_ptr() for t in outs]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.apex_flash_wide_bwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), delta.data_ptr(), *segs, *extra[:2], gl,
                *extra[2:], *outs, b, h, hk, sq, sk, d,
                DTYPE_CODES[q.dtype], float(scale), int(causal),
                0 if window is None else int(window), *drop, stream)
        if err:
            raise RuntimeError(
                f"{counter}: CUDA error {err} at launch: "
                f"{lib.apex_flash_wide_error_string(err).decode()}")
        _build.count_launch(kernel_name(counter, q.dtype))
    return dq, dk, dv


class _FlashFn(torch.autograd.Function):
    """The reference's ``custom_vjp`` around flash attention: the
    kernels on CUDA tensors, the plain versions on CPU tensors. With
    ``with_lse`` it returns ``(out, lse)``, both differentiable
    (``_flash_with_lse``); the lse's cotangent reaches the kernels as
    ``glse``, and the bias's gradient is recomputed (:func:`_dbias`)
    when the bias requires one."""

    @staticmethod
    def forward(ctx, q, k, v, bias, q_seg, k_seg, q_pos, k_pos, scale,
                causal, window, rate, seed, kernel, with_lse):
        ctx.planes = None
        if kernel:
            if q.dtype == torch.float32 and not wide_route(q.shape[-1],
                                                             q.dtype):
                # q, k and v split once: the forward's planes are the
                # backward's too
                ctx.planes = _split3_cuda((q, k, v), tma_width(q.shape[-1]))
            out, lse = _flash_cuda(q, k, v, q_seg, k_seg, scale, causal,
                                   window, rate, seed, bias=bias,
                                   q_pos=q_pos, k_pos=k_pos,
                                   planes=ctx.planes)
        else:
            out, lse = _attention_torch(q, k, v, bias, q_seg, k_seg, scale,
                                        causal, window, rate, seed,
                                        return_lse=True, q_pos=q_pos,
                                        k_pos=k_pos)
        ctx.save_for_backward(q, k, v, bias, out, lse, q_seg, k_seg, q_pos,
                              k_pos)
        ctx.args = (scale, causal, window, rate, seed, kernel)
        ctx.set_materialize_grads(False)
        return (out, lse) if with_lse else out

    @staticmethod
    def backward(ctx, dout, glse=None):
        q, k, v, bias, out, lse, q_seg, k_seg, q_pos, k_pos = \
            ctx.saved_tensors
        scale, causal, window, rate, seed, kernel = ctx.args
        if dout is None:
            dout = torch.zeros_like(out)
        # delta = rowsum(dO * O) whatever the dropout: the 1 / (1 - rate)
        # of the kept probabilities cancels in rowsum(P * dP)
        delta = torch.sum(out.float() * dout.float(), dim=-1)
        if glse is not None:
            glse = glse.float().contiguous()
        pos = dict(q_pos=q_pos, k_pos=k_pos)
        # the kernels take the forward's planes (fp32)
        kw = dict(pos, planes=ctx.planes) if kernel else pos
        dq, dk, dv = (_flash_bwd_cuda if kernel else _flash_bwd_torch)(
            q, k, v, lse, dout, delta, q_seg, k_seg, scale, causal, window,
            rate, seed, bias=bias, glse=glse, **kw)
        dbias = None
        if bias is not None and ctx.needs_input_grad[3]:
            dbias = _dbias(q, k, v, bias, lse, dout, delta, q_seg, k_seg,
                           scale, causal, window, rate, seed, glse, **pos)
        return (dq, dk, dv, dbias) + (None,) * 11


def _library(dtype: torch.dtype) -> ctypes.CDLL:
    """The forward's library for ``dtype``: one a dtype
    (``csrc/flash_fwd.cu``, ``flash_fwd_fp16.cu``, ``flash_fwd_fp32.cu``),
    built in parallel."""
    return _build.library("flash_fwd" + _SUFFIX[dtype], "apex_flash_fwd",
                          FWD_ARGTYPES, "apex_flash_error_string")


def _flash_cuda(q, k, v, q_seg, k_seg, scale, causal, window, rate=0.0,
                seed=None, *, bias=None, q_pos=None, k_pos=None,
                planes=None):
    """The kernel: returns ``(out, lse)`` like ``_flash_fwd_pallas``.
    bf16 and fp16 run the wgmma/TMA kernel (``csrc/flash_fwd_sm90.cuh``):
    a head_dim off :func:`tma_width` is padded with zero columns on the
    way in and the output cut on the way out. fp32 runs
    ``csrc/flash_fwd32_sm90.cuh`` on the bf16 part planes of q, k and v:
    ``planes`` gives them (as :func:`_split3_cuda` returns them), else the
    split pass writes them first (one launch); the output keeps d."""
    q_seg, k_seg = _check_kernel_args(q, k, v, q_seg, k_seg)
    extra = _extra_args(q, bias, q_pos, k_pos)
    b, h, sq, d = q.shape
    hk, sk = k.shape[1], k.shape[2]
    dev = q.device
    if wide_route(d, q.dtype):
        if planes is not None:
            raise ValueError("the wide route reads q, k, v themselves, no "
                             "part planes")
        return _flash_wide_cuda(q, k, v, q_seg, k_seg, scale, causal, window,
                                rate, seed, extra)
    width = kernel_width(d, q.dtype)
    if q.dtype == torch.float32:
        if planes is None:
            planes = _split3_cuda((q, k, v), width)
        else:
            _check_planes(planes, (q, k, v), width)
        ins = [t.data_ptr() for t in planes]
        width = d
    else:
        q, k, v = pad_head_dim((q, k, v), width)
        ins = [t.data_ptr() for t in (q, k, v)]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev)
    lib = _library(q.dtype)
    # the ctypes call launches on the current device: make it q's
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.apex_flash_fwd(
            *ins, None if q_seg is None else q_seg.data_ptr(),
            None if k_seg is None else k_seg.data_ptr(), *extra,
            out.data_ptr(), lse.data_ptr(), b, h, hk, sq, sk, width,
            DTYPE_CODES[q.dtype], float(scale), int(causal),
            0 if window is None else int(window),
            *_dropout_args(rate, seed), stream)
    if err:
        raise RuntimeError(f"{KERNEL}: CUDA error {err} at launch: "
                           f"{lib.apex_flash_error_string(err).decode()}")
    _build.count_launch(kernel_name(KERNEL, q.dtype))
    if width != d:
        out = out[..., :d].contiguous()
    return out, lse


def as_positions(t, device) -> torch.Tensor:
    """Token positions (a tensor, array or sequence) as the contiguous
    int32 vector on ``device`` that the kernels read."""
    return torch.as_tensor(t, device=device).reshape(-1).to(
        torch.int32).contiguous()


def _prepare(q, k, v, bias, segment_ids, kv_segment_ids, causal,
             window_size, softmax_scale, dropout_rate, dropout_rng,
             q_positions, kv_positions):
    """Validate the arguments and apply the reference's defaults
    (``flash_attention`` :995-1050); returns (scale, q_seg, k_seg,
    seed, q_pos, k_pos), the positions as int32 tensors on q's
    device."""
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
    seed = None
    if dropout_rate > 0.0:
        if dropout_rng is None:
            raise ValueError("dropout_rate > 0 requires dropout_rng")
        seed = dropout_seed(dropout_rng)
    q_pos = k_pos = None
    if q_positions is not None:
        q_pos, k_pos = (as_positions(t, q.device)
                        for t in (q_positions, kv_positions))
        if q_pos.numel() != q.shape[2] or k_pos.numel() != k.shape[2]:
            raise ValueError(
                f"positions of {q_pos.numel()} queries and {k_pos.numel()} "
                f"keys for sq={q.shape[2]}, sk={k.shape[2]}")
    return softmax_scale, segment_ids, kv_segment_ids, seed, q_pos, k_pos


def _attention(q, k, v, kernel: bool, *, bias=None, segment_ids=None,
               kv_segment_ids=None, causal=False, window_size=None,
               softmax_scale=None, dropout_rate=0.0, dropout_rng=None,
               return_lse=False, q_positions=None, kv_positions=None):
    scale, q_seg, k_seg, seed, q_pos, k_pos = _prepare(
        q, k, v, bias, segment_ids, kv_segment_ids, causal, window_size,
        softmax_scale, dropout_rate, dropout_rng, q_positions, kv_positions)
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (q, k, v, bias))
    if grad:
        return _FlashFn.apply(q, k, v, bias, q_seg, k_seg, q_pos, k_pos,
                              scale, causal, window_size, dropout_rate, seed,
                              kernel, return_lse)
    if kernel:
        out, lse = _flash_cuda(q, k, v, q_seg, k_seg, scale, causal,
                               window_size, dropout_rate, seed, bias=bias,
                               q_pos=q_pos, k_pos=k_pos)
        return (out, lse) if return_lse else out
    return _attention_torch(q, k, v, bias, q_seg, k_seg, scale, causal,
                            window_size, dropout_rate, seed,
                            return_lse=return_lse, q_pos=q_pos, k_pos=k_pos)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    bias: Optional[torch.Tensor] = None,
                    segment_ids: Optional[torch.Tensor] = None,
                    kv_segment_ids: Optional[torch.Tensor] = None,
                    causal: bool = False,
                    window_size: Optional[int] = None,
                    softmax_scale: Optional[float] = None,
                    dropout_rate: float = 0.0,
                    dropout_rng=None,
                    return_lse: bool = False,
                    q_positions: Optional[torch.Tensor] = None,
                    kv_positions: Optional[torch.Tensor] = None):
    """Attention over q (b, h, sq, d) and k, v (b, hk, sk, d), hk
    dividing h (GQA shares each kv head across its group of q heads).

    ``segment_ids`` (b, sq) / ``kv_segment_ids`` (b, sk): a query sees
    only keys of its own segment (either defaults from the other, as in
    the reference). ``causal`` lets query i see keys j <= i + (sk - sq);
    ``window_size=w`` further restricts it to its last ``w`` keys.
    ``q_positions`` (sq,) / ``kv_positions`` (sk,) give global token
    positions (ring and blockwise chunks): the causal and window tests
    then compare positions, with no offset. ``bias`` is an additive fp32,
    bf16 or fp16 logit bias, 4-D with each dimension 1 or full (b, h, sq,
    sk); its gradient comes back in its own shape.
    ``return_lse=True`` also returns the fp32 (b, h, sq) log-sum-exp
    (``NEG_INF`` on fully-masked rows), differentiable: chunk results
    merge exactly through ``logaddexp``. ``dropout_rate`` drops the
    attention probabilities with the counter-based mask of
    ``dropout_rng``: a key (its two uint32 words, xor-ed into the seed
    as the reference folds it) or a uint32 seed."""
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


__all__ = ["NEG_INF", "attention_plain", "dropout_seed", "flash_attention",
           "kernel_name", "wide_route"]
