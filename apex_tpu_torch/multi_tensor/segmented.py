"""One-pass LAMB over a segmented flat layout.

Counterpart of ``apex_tpu/multi_tensor/segmented.py``. The two-stage
LAMB (``ops.fused_lamb_update``) writes the update term u in stage 1 and
reads it back with p in stage 2: 10 memory accesses an element. Over
the layout of ``flat_buffer.segmented_space`` every small leaf lives
inside one segment, so its norms are segment-local, and one kernel
(``_small_segment_pass``, ``csrc/lamb_segment.cu``) runs both stages
per segment with u (and p) held on chip: 7 accesses an element, 8
without the p stash. Where the reference holds a segment in one TPU
core's VMEM, the port holds it across the shared memory of a
thread-block cluster of 16 blocks (the source's note says how). Leaves
larger than a segment take the two stages over their own segments: one
launch of ``lamb_stage1`` and one of ``lamb_stage2`` over the list of
every large leaf's segments (the reference runs the two stages leaf by
leaf), the per-leaf norms summed per segment, then per leaf, in a fixed
order.

On CPU tensors (or with ``plain=True``) the segment pass runs its plain
version, which follows the reference kernel's arithmetic (per-subtile
sums, per-slot sums, trust ratios, p') and the CUDA kernel's order of
the sums (:func:`_slot_sums`), so the two agree bit for bit.

A bf16 master (``sr_seed``) follows the reference's kernel schedule
(its ``impl="pallas"``/``"interpret"`` path): the segment pass writes p'
with stochastic rounding through the reference's murmur3 hash of each
element's global flat index (:235-261), and each large leaf's stage 2
through its own threefry stream, ``fold_in(PRNGKey(sr_seed + leaf + 1),
0)`` over the element's index within the leaf's slice (:485-499), the
leaf being its index in this space. Both streams are keyed by the
layout: they match the reference's bit for bit only on a tree laid out
as the port lays it out. ``u_dtype=torch.bfloat16`` stashes the update
term in bf16 (the reference's ``u_dtype``, :105-109), half the shared
memory, at ~2^-9 relative error in u.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from apex_tpu_torch import _build
from apex_tpu_torch._backend import check_kernel_input, uses_kernel
from apex_tpu_torch.multi_tensor.engine import (
    kernel_scalar,
    leaf_sums,
    murmur_bits,
    scalar_pointer,
    sqrt_rn,
    sr_round_bits,
)
from apex_tpu_torch.multi_tensor.flat_buffer import (
    BLOCK_SMEM_BYTES,
    CHUNK,
    CHUNK_ROWS,
    CLUSTER_BLOCKS,
    DEFAULT_ALIGN,
    SEG_WARP_ELEMS,
    FlatSpace,
    SegmentMeta,
    segment_smem_bytes,
)
from apex_tpu_torch.multi_tensor.ops import (
    _lamb_stage1_fn,
    lamb_inv_scale,
    lamb_scalars,
    lamb_stage1_segments,
    lamb_stage2_segments,
    lamb_trust_ratio,
)

SEGMENT_KERNEL = "lamb_segment"
SEGMENT_SR_KERNEL = "lamb_segment_sr"      # a bf16 master's, counted apart

_stage1_math = _lamb_stage1_fn      # the reference's _stage1_math (:57)

_LANE_VECS = SEG_WARP_ELEMS // 128      # float4s of a lane's round


def _slot_sums(x: torch.Tensor, slot: torch.Tensor,
               max_slots: int) -> torch.Tensor:
    """(n_small, max_slots) per-slot sums of x^2 over the small segments
    (``x`` (n_small, seg_elems) fp32, ``slot`` their (n_small, subtiles)
    slot map, -1 for padding), in the segment kernel's order: a segment
    is ``CLUSTER_BLOCKS`` blocks' slices, each in warp rounds of
    ``SEG_WARP_ELEMS`` elements, lane l's four float4s at 128 j + 4 l;
    a lane adds its 16 squares in order from +0, the warp adds its lanes
    by the xor butterfly (16, 8, 4, 2, 1), a subtile's sum is ((w0 + w1)
    + w2) + w3 over its four warps, a block adds its subtiles into its
    per-slot sums in subtile order from +0, and the segment adds its
    blocks' per-slot sums in block order from +0. Every step an fp32
    add, so the result is bitwise the kernel's."""
    n_small, se = x.shape
    blocks = CLUSTER_BLOCKS
    chunks = se // blocks // SEG_WARP_ELEMS     # a block's warp rounds
    sq = (x * x).view(n_small, blocks, chunks, _LANE_VECS, 32, 4)
    lane = torch.zeros(n_small, blocks, chunks, 32, dtype=torch.float32,
                       device=x.device)
    for j in range(_LANE_VECS):
        for c in range(4):
            lane = lane + sq[:, :, :, j, :, c]
    ar = torch.arange(32, device=x.device)
    for off in (16, 8, 4, 2, 1):
        lane = lane + lane[..., ar ^ off]
    w = lane[..., 0].reshape(n_small, blocks, -1,
                             DEFAULT_ALIGN // SEG_WARP_ELEMS)
    sub = w[..., 0]
    for k in range(1, w.shape[-1]):
        sub = sub + w[..., k]
    ids = slot.long().view(n_small, blocks, -1)
    ids = torch.where(ids >= 0, ids, max_slots)
    per_block = torch.zeros(n_small, blocks, max_slots + 1,
                            dtype=torch.float32, device=x.device)
    for t in range(ids.shape[-1]):      # one add a row: order-free
        per_block.scatter_add_(2, ids[..., t:t + 1], sub[..., t:t + 1])
    total = torch.zeros(n_small, max_slots + 1, dtype=torch.float32,
                        device=x.device)
    for r in range(blocks):
        total = total + per_block[:, r]
    return total[:, :max_slots]


def _small_segment_pass(p, m, v, g, outs, *, meta: SegmentMeta, scalars,
                        inv_scale, lr, use_nvlamb: bool, wd_is_zero: bool,
                        stash_p: bool = True, with_grad_norm: bool = False,
                        sr_seed=None, u_dtype=torch.float32,
                        plain: bool = False
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Both LAMB stages over the small segments of ``meta``, writing
    p', m', v' into ``outs`` (which may be p, m, v themselves); the
    other segments are neither read nor written. ``scalars`` are
    ``(b1, b2, beta3, eps, wd, bc1, bc2, mode)``. With ``sr_seed`` p is
    bf16 and p' is written with stochastic rounding (the murmur3 bits of
    the global flat index); ``u_dtype`` is the update term's stash (fp32,
    or bf16 rounded to nearest). Returns ``(found_inf, gg)``, ``gg`` the
    ``(n_small, max_slots)`` per-slot sums of the raw g^2 with
    ``with_grad_norm``, else None."""
    if meta.seg_elems % CHUNK:
        raise ValueError(f"seg_elems {meta.seg_elems} must be a multiple "
                         f"of the chunk {CHUNK}")
    if u_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"u_dtype must be float32 or bfloat16, got "
                         f"{u_dtype}")
    if (sr_seed is not None) != (p.dtype == torch.bfloat16):
        raise ValueError("stochastic rounding (sr_seed) writes a bf16 p', "
                         f"and a bf16 p needs it; p is {p.dtype}")
    if not plain and uses_kernel(p):
        return _segment_cuda(p, m, v, g, outs, meta, scalars, inv_scale, lr,
                             use_nvlamb, wd_is_zero, stash_p, with_grad_norm,
                             sr_seed, u_dtype)
    dev = p.device
    se, ms = meta.seg_elems, meta.max_slots
    segs, slot = (t.long() for t in meta.device_maps(dev))
    n_small, sub = slot.shape
    views = [b.view(meta.n_segments, se) for b in (p, m, v, g)]
    P, M, V, G = (x[segs].float() for x in views)
    found = (~torch.isfinite(G).all()).to(torch.float32)
    s = [torch.as_tensor(x, dtype=torch.float32, device=dev)
         for x in (*scalars, inv_scale)]
    u, m2, v2 = _stage1_math([P, M, V, G], s, None)

    wn = sqrt_rn(_slot_sums(P, slot, ms))
    un = sqrt_rn(_slot_sums(u, slot, ms))
    ratio = torch.where((wn > 0.0) & (un > 0.0), wn / un,
                        torch.ones_like(wn))
    if not use_nvlamb and wd_is_zero:
        ratio = torch.ones_like(ratio)
    rr = torch.where(slot >= 0, ratio.gather(1, slot.clamp_min(0)),
                     torch.zeros((), device=dev))
    lr_t = torch.as_tensor(lr, dtype=torch.float32, device=dev)
    u_st = u.to(u_dtype).float()
    p2 = (P.view(n_small, sub, DEFAULT_ALIGN)
          - lr_t * rr[..., None] * u_st.view(n_small, sub, DEFAULT_ALIGN))
    if sr_seed is not None:
        idx = segs[:, None] * se + torch.arange(se, device=dev)[None, :]
        p2 = sr_round_bits(p2.reshape(n_small, se), murmur_bits(sr_seed, idx))
    for buf, val in zip(outs, (p2, m2, v2)):
        buf.view(meta.n_segments, se).index_copy_(
            0, segs, val.reshape(n_small, se).to(buf.dtype))
    return found, _slot_sums(G, slot, ms) if with_grad_norm else None


def _segment_cuda(p, m, v, g, outs, meta, scalars, inv_scale, lr,
                  use_nvlamb, wd_is_zero, stash_p, with_grad_norm, sr_seed,
                  u_dtype):
    dev = p.device
    for name, t, src in zip(("p", "m", "v", "g", "p_out", "m_out", "v_out"),
                            (p, m, v, g, *outs), (None,) * 4 + (p, m, v)):
        if t is src:                    # in place: checked as the input
            continue
        check_kernel_input(name, t, (p.dtype,) if name[0] == "p"
                           else (torch.float32,), dev)
        if t.shape[0] != meta.n_segments * meta.seg_elems:
            raise ValueError(f"{name} does not cover the segmented space")
    u_bf16 = u_dtype == torch.bfloat16
    smem = segment_smem_bytes(meta.seg_elems, meta.max_slots, stash_p,
                              u_bytes=2 if u_bf16 else 4)
    if smem > BLOCK_SMEM_BYTES:
        raise ValueError(
            f"seg_elems={meta.seg_elems} (stash_p={stash_p}, u {u_dtype}) "
            f"needs {smem} bytes of shared memory a block; a block has "
            f"{BLOCK_SMEM_BYTES}")
    vals = [kernel_scalar(x, dev) for x in (*scalars, lr)]
    if any(isinstance(x, torch.Tensor) for x in vals):
        raise NotImplementedError(
            f"{SEGMENT_KERNEL}: only the gradient divisor may live on the "
            "device")
    inv_val, inv_ptr = scalar_pointer(kernel_scalar(inv_scale, dev))
    b1, b2, beta3, eps, wd, bc1, bc2, mode, lr_f = vals
    segs, slot = meta.device_maps(dev)
    n_small = len(meta.small_segments)
    found = torch.zeros((), dtype=torch.float32, device=dev)
    gg = (torch.empty(n_small, meta.max_slots, dtype=torch.float32,
                      device=dev) if with_grad_norm else None)
    P, L, F, I, U = _build.P, _build.L, _build.F, _build.I, _build.U
    lib = _build.library("lamb_segment", "apex_lamb_segment",
                         (P,) * 11 + (I, L, I) + (F,) * 9
                         + (P, I, I, I, I, I, I, U, P),
                         "apex_lamb_segment_error_string")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.apex_lamb_segment(
            *(t.data_ptr() for t in (p, m, v, g, *outs)), found.data_ptr(),
            None if gg is None else gg.data_ptr(), segs.data_ptr(),
            slot.data_ptr(), n_small, meta.seg_elems, meta.max_slots,
            b1, b2, beta3, eps, wd, bc1, bc2, lr_f, inv_val, inv_ptr,
            int(mode > 0.5), int(use_nvlamb), int(wd_is_zero), int(stash_p),
            int(sr_seed is not None), int(u_bf16),
            0 if sr_seed is None else int(sr_seed) & 0xFFFFFFFF, stream)
    if err:
        msg = lib.apex_lamb_segment_error_string(err).decode()
        raise RuntimeError(f"{SEGMENT_KERNEL}: CUDA error {err} at launch: "
                           f"{msg}")
    _build.count_launch(SEGMENT_KERNEL if sr_seed is None
                        else SEGMENT_SR_KERNEL)
    return found, gg


def segment_route(meta: SegmentMeta, *, stash_p: bool, p_dtype, u_dtype,
                  device) -> dict:
    """How the segment kernel runs ``meta``'s small segments on
    ``device`` (a CUDA device): blocks a cluster (one cluster a
    segment), clusters the card holds at once (all ``n_small`` in one
    wave when at least ``n_small``), blocks an SM, the kernel's
    registers and spilled bytes a thread, and its shared bytes a
    block."""
    u_bf16 = u_dtype == torch.bfloat16
    out = (ctypes.c_int * 6)()
    lib = _build.library("lamb_segment", "apex_lamb_segment_route",
                         (_build.L,) + (_build.I,) * 4 + (_build.P,),
                         "apex_lamb_segment_error_string")
    with torch.cuda.device(device):
        err = lib.apex_lamb_segment_route(
            meta.seg_elems, meta.max_slots, int(stash_p),
            int(p_dtype == torch.bfloat16), int(u_bf16),
            ctypes.addressof(out))
    if err:
        msg = lib.apex_lamb_segment_error_string(err).decode()
        raise RuntimeError(f"{SEGMENT_KERNEL}: CUDA error {err}: {msg}")
    n_small = len(meta.small_segments)
    keys = ("cluster_blocks", "resident_clusters", "blocks_per_sm",
            "registers", "spill_bytes", "smem_bytes")
    return {**dict(zip(keys, out)), "clusters": n_small,
            "blocks": n_small * out[0],
            "one_wave": out[1] >= n_small}


def fused_lamb_segmented_update(
    p, m, v, g, space: FlatSpace, meta: SegmentMeta, *,
    lr, beta1=0.9, beta2=0.999, eps=1e-6, step=1,
    weight_decay=0.0, bias_correction=True, grad_averaging=True,
    max_grad_norm=0.0, adam_w_mode=True, use_nvlamb=False,
    global_grad_norm=None, grad_scale=1.0, stash_p=None, u_dtype=None,
    with_grad_norm=False, in_place=True, plain=False, sr_seed=None,
    norms=None,
):
    """LAMB step over a segment-aligned flat space (the reference's
    ``fused_lamb_segmented_update``, :350): the one-pass kernel over the
    small segments, then the two stages over the large leaves' segments.
    The math is ``ops.fused_lamb_update``'s; only the schedule differs.
    ``with_grad_norm`` appends the per-tensor norms of the raw gradient,
    from the segment pass's slot sums and the large leaves' stage-1
    partials. With ``in_place`` p, m and v are overwritten; else new
    buffers are returned (every segment is written: the small ones by
    the segment pass, the large leaves' by their stages) and the inputs
    left as they were. ``sr_seed`` (a bf16 p): p' written with stochastic
    rounding, the streams of the module docstring; ``u_dtype`` (default
    the meta's) the segment pass's update-term stash. ``norms`` (a
    ``parallel.sharded_norms.ShardedNorms``): the state is one rank's
    part; the global norm is the whole model's and a large leaf's norms
    the whole leaf's. A segment computes its leaves' norms inside the
    kernel, so a leaf split over ranks must lie outside the small
    segments (``FusedLAMB.layout(..., split=...)``). Returns ``(p', m',
    v', found_inf[, grad_norm_per_tensor])``."""
    if meta.n_segments * meta.seg_elems != space.total:
        raise ValueError(
            f"SegmentMeta (n_segments={meta.n_segments}, seg_elems="
            f"{meta.seg_elems}) does not cover the space (total="
            f"{space.total}): it was built for another layout")
    if norms is not None and norms.splits_any:
        large = {idx for idx, _, _ in meta.large}
        inside = [space.names[i] for i, split in enumerate(norms.split)
                  if split and i not in large]
        if inside:
            raise ValueError(
                f"leaves split over ranks lie in the small segments "
                f"({inside[:3]}...): their norms cannot be summed across "
                "ranks inside the segment kernel; lay the state out with "
                "FusedLAMB.layout(params, split=...)")
    stash_p = meta.stash_p if stash_p is None else bool(stash_p)
    if u_dtype is None:
        u_dtype = getattr(torch, meta.u_dtype_name)
    if sr_seed is not None and p.dtype != torch.bfloat16:
        # the truncation targets the bf16 mantissa boundary; another
        # dtype would quantize silently (the reference's :392-399)
        raise ValueError("stochastic rounding targets bfloat16 params; got "
                         f"{p.dtype}")
    dev = p.device
    b1, b2, beta3, bc1, bc2 = lamb_scalars(
        beta1=beta1, beta2=beta2, step=step, bias_correction=bias_correction,
        grad_averaging=grad_averaging)
    inv_scale = lamb_inv_scale(g, max_grad_norm=max_grad_norm,
                               global_grad_norm=global_grad_norm,
                               grad_scale=grad_scale, plain=plain,
                               norms=norms)
    mode = 1.0 if adam_w_mode else 0.0
    outs = ((p, m, v) if in_place else
            tuple(torch.empty_like(b) for b in (p, m, v)))
    found = None                      # the first pass's flag, else zeros
    nl = space.num_leaves
    leaf_gg = (torch.zeros(nl, dtype=torch.float32, device=dev)
               if with_grad_norm else None)
    if meta.small_segments:
        found, gg = _small_segment_pass(
            p, m, v, g, outs, meta=meta,
            scalars=(b1, b2, beta3, eps, weight_decay, bc1, bc2, mode),
            inv_scale=inv_scale, lr=lr, use_nvlamb=use_nvlamb,
            wd_is_zero=not (weight_decay > 0.0), stash_p=stash_p,
            with_grad_norm=with_grad_norm, sr_seed=sr_seed, u_dtype=u_dtype,
            plain=plain)
        if with_grad_norm:
            leaf_gg = torch.zeros(nl + 1, dtype=torch.float32,
                                  device=dev).index_add_(
                0, meta.device_slot_leaf(dev, nl), gg.reshape(-1))[:nl]

    if meta.large:
        # the two stages over every large leaf's segments, one launch
        # each; the per-leaf norms from the per-subtile partials (a sum
        # per segment, then per leaf over its segments, in a fixed order)
        segs, leaves, gather = meta.device_large(dev)
        u = torch.empty_like(p, dtype=torch.float32)
        pp, uu, gg, f = lamb_stage1_segments(
            p, m, v, g, (u, outs[1], outs[2]), segs, meta.seg_elems,
            scalars=(b1, b2, beta3, eps, weight_decay, bc1, bc2, mode),
            inv_scale=inv_scale, with_grad_partials=with_grad_norm,
            plain=plain)
        found = f if found is None else torch.maximum(found, f)
        sub = meta.seg_elems // DEFAULT_ALIGN

        def per_leaf(part):
            if norms is None:
                per_seg = part.view(-1, sub)[segs.long()].sum(-1)
                return torch.cat([per_seg, per_seg.new_zeros(1)])[
                    gather].sum(-1)
            # a state across ranks: by leaf in the space's fixed order
            # (the same bits for a leaf two pipe stages hold, whatever
            # segment size each chose), then over the ranks
            return norms.leaf_sumsq(leaf_sums(part.reshape(-1), space,
                                              plain=plain))[leaves]

        ratio = torch.ones(nl, dtype=torch.float32, device=dev)
        ratio.index_copy_(0, leaves, lamb_trust_ratio(
            sqrt_rn(per_leaf(pp)), sqrt_rn(per_leaf(uu)),
            weight_decay=weight_decay, use_nvlamb=use_nvlamb))
        lamb_stage2_segments(
            p, u, outs[0], ratio, space.device_subtile_leaf_ids(dev), segs,
            meta.seg_elems, lr=lr, plain=plain, sr_seed=sr_seed,
            seg_streams=None if sr_seed is None
            else meta.device_large_streams(dev))
        if with_grad_norm:
            leaf_gg = leaf_gg.index_add_(0, leaves, per_leaf(gg))
    if found is None:
        found = torch.zeros((), dtype=torch.float32, device=dev)
    p2, m2, v2 = outs
    if with_grad_norm:
        return p2, m2, v2, found, sqrt_rn(leaf_gg)
    return p2, m2, v2, found


__all__ = ["CHUNK", "CHUNK_ROWS", "SEGMENT_KERNEL", "SEGMENT_SR_KERNEL",
           "fused_lamb_segmented_update", "segment_route"]
