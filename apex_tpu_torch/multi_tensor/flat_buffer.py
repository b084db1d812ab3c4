"""Flat parameter space.

Counterpart of ``apex_tpu/multi_tensor/flat_buffer.py``. A set of named
tensors (a module's ``named_parameters()``) is laid out in one 1-D
buffer, each tensor padded to ``DEFAULT_ALIGN`` elements, so one fused
kernel updates every parameter in a single sweep. Leaves keep the order
they are given in (module order); the reference's tree is ordered by
its own sorted keys, so the two layouts are compared per parameter
name, never index for index.

Where the reference differentiates with respect to the flat master
(``grad_fn`` over ``unpack``), the port makes each parameter a view
into the flat master (fp32, or bf16 for a master-free bf16 optimizer)
and each ``.grad`` a view into one flat gradient buffer of the master's
dtype (PyTorch keeps a gradient in its parameter's dtype; the
reference's ``jax.grad`` of a bf16 master is bf16 too) that autograd
accumulates into in place
(:meth:`FlatSpace.bind`, :meth:`FlatSpace.leaves`): an in-place update
of the master is the weight update, and the gradients arrive already
flat. This is the contiguous-buffer layout of Megatron-LM's optimizer.

``segmented_space`` gives the segment-aligned layout of the one-pass
LAMB (``multi_tensor/segmented.py``) with its :class:`SegmentMeta`, the
reference's layout for the same leaves in the same order. A segment
there is sized to the TPU's VMEM; here to a budget of shared memory
across the thread-block cluster that holds it
(:data:`DEFAULT_SEG_SMEM_BUDGET`).

The small index maps the kernels read (the subtile -> leaf map, the
segment and slot maps) are copied to a device once per layout and kept
(:meth:`FlatSpace.device_subtile_leaf_ids`, :meth:`SegmentMeta.device_maps`),
not once a step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

# Per-leaf alignment in elements, the reference's (16 x 128).
DEFAULT_ALIGN = 2048


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class FlatSpace:
    """Static layout of named tensors flattened into one aligned 1-D
    buffer."""

    names: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]
    padded_sizes: Tuple[int, ...]
    total: int
    align: int
    # device -> int32 subtile -> leaf map on that device; ("leaf_runs",
    # device) -> the per-leaf sum's runs and kernel tables there
    _device_ids: Dict[Any, Any] = dataclasses.field(
        default_factory=dict, compare=False, repr=False, hash=False)

    @classmethod
    def create(cls, tensors: Mapping[str, torch.Tensor],
               align: int = DEFAULT_ALIGN) -> "FlatSpace":
        names, shapes, dtypes, offsets, sizes, padded = [], [], [], [], [], []
        off = 0
        for name, t in tensors.items():
            size = t.numel()
            psize = _round_up(max(size, 1), align)
            names.append(name)
            shapes.append(tuple(t.shape))
            dtypes.append(t.dtype)
            offsets.append(off)
            sizes.append(size)
            padded.append(psize)
            off += psize
        return cls(names=tuple(names), shapes=tuple(shapes),
                   dtypes=tuple(dtypes), offsets=tuple(offsets),
                   sizes=tuple(sizes), padded_sizes=tuple(padded),
                   total=off, align=align)

    @property
    def num_leaves(self) -> int:
        return len(self.names)

    def pack(self, tensors: Mapping[str, torch.Tensor],
             dtype: Optional[torch.dtype] = None,
             device=None) -> torch.Tensor:
        """One 1-D buffer holding ``tensors`` (by name), optionally cast;
        padding elements are zero."""
        first = tensors[self.names[0]]
        buf = torch.zeros(self.total, dtype=dtype or first.dtype,
                          device=device if device is not None
                          else first.device)
        self.pack_into(buf, tensors)
        return buf

    def pack_into(self, buf: torch.Tensor,
                  tensors: Mapping[str, torch.Tensor]) -> None:
        """Copy ``tensors`` (by name) into their slots of ``buf`` in
        place; the padding is left as it is."""
        with torch.no_grad():
            for name, off, size in zip(self.names, self.offsets, self.sizes):
                buf[off:off + size].copy_(tensors[name].reshape(-1))

    def unpack(self, buf: torch.Tensor,
               dtype: str = "original") -> Dict[str, torch.Tensor]:
        """Inverse of :meth:`pack`: views into ``buf`` shaped like each
        leaf. ``dtype='original'`` casts a leaf back to its recorded
        dtype where that differs from the buffer's (a copy);
        ``dtype='buffer'`` keeps the buffer's dtype (always views)."""
        out = {}
        for name, shape, ldt, off, size in zip(
                self.names, self.shapes, self.dtypes, self.offsets,
                self.sizes):
            leaf = buf[off:off + size].view(shape)
            if dtype == "original" and leaf.dtype != ldt:
                leaf = leaf.to(ldt)
            out[name] = leaf
        return out

    def leaves(self, master: torch.Tensor,
               grad: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Leaf tensors that are views into ``master`` and whose
        ``.grad`` is the matching view into ``grad``: a backward pass
        through them accumulates straight into the flat ``grad``."""
        views = self.unpack(master.detach(), "buffer")
        grads = self.unpack(grad, "buffer")
        for name, leaf in views.items():
            leaf.requires_grad_(True)
            leaf.grad = grads[name]
        return views

    def bind(self, module: nn.Module, master: torch.Tensor,
             grad: torch.Tensor) -> None:
        """Point every parameter of ``module`` (by name) at its view of
        ``master``, and its ``.grad`` at its view of ``grad``. Autograd
        then accumulates into ``grad`` in place (zero it before each
        backward), and an in-place update of ``master`` updates the
        module's weights. ``master`` is fp32 or bf16, ``grad`` and every
        parameter of the master's dtype."""
        params = dict(module.named_parameters())
        if set(params) != set(self.names):
            raise ValueError(
                "the module's parameters do not match the flat space: "
                f"missing {sorted(set(self.names) - set(params))}, "
                f"unexpected {sorted(set(params) - set(self.names))}")
        if master.dtype not in (torch.float32, torch.bfloat16) \
                or grad.dtype != master.dtype:
            raise TypeError(
                f"bind needs an fp32 or bf16 master and a gradient buffer "
                f"of its dtype; got {master.dtype} and {grad.dtype}")
        for name, off, size, shape in zip(self.names, self.offsets,
                                          self.sizes, self.shapes):
            p = params[name]
            if p.dtype != master.dtype:
                raise TypeError(f"{name} is {p.dtype}; the flat master "
                                f"holds {master.dtype} parameters")
            p.data = master[off:off + size].view(shape)
            p.grad = grad[off:off + size].view(shape)

    def grad_fn(self, loss_fn: Callable, *, with_value: bool = False):
        """Differentiate a loss over the named leaves straight into this
        space: the returned ``fn(master, *args, **kwargs)`` calls
        ``loss_fn(leaves, *args, **kwargs)`` on views of ``master`` and
        returns the flat gradient in the master's dtype (with the loss
        first when ``with_value``)."""
        def flat(master, *args, **kwargs):
            grad = torch.zeros_like(master)
            loss = loss_fn(self.leaves(master, grad), *args, **kwargs)
            loss.backward()
            return (loss.detach(), grad) if with_value else grad

        return flat

    def tile_leaf_ids(self, tile_elems: int) -> np.ndarray:
        """int32 map from tile index to leaf index; ``tile_elems`` must
        divide the alignment, so no tile straddles two leaves."""
        if self.align % tile_elems:
            raise ValueError(
                f"tile_elems={tile_elems} must divide align={self.align} "
                "for per-tensor fused ops")
        ids = np.empty((self.total // tile_elems,), dtype=np.int32)
        for i, (off, psize) in enumerate(zip(self.offsets,
                                             self.padded_sizes)):
            ids[off // tile_elems:(off + psize) // tile_elems] = i
        return ids

    def device_subtile_leaf_ids(self, device) -> torch.Tensor:
        """:meth:`tile_leaf_ids` at the per-tensor subtile (2048
        elements), as an int32 tensor on ``device``, made once per
        space and device."""
        dev = torch.device(device)
        ids = self._device_ids.get(dev)
        if ids is None:
            ids = torch.as_tensor(self.tile_leaf_ids(DEFAULT_ALIGN)).to(dev)
            self._device_ids[dev] = ids
        return ids


# ---------------------------------------------------------------------------
# Segmented layout (the one-pass LAMB)
# ---------------------------------------------------------------------------

# elements per kernel chunk (512 rows x 128 lanes): segments are whole
# chunks, as in the reference (apex_tpu/multi_tensor/segmented.py:53-54)
CHUNK_ROWS = 512
CHUNK = CHUNK_ROWS * 128
# The segment kernel (csrc/lamb_segment.cu) runs one thread-block cluster
# of CLUSTER_BLOCKS blocks per segment, each holding a sixteenth of the
# segment in shared memory (227 KB a block on an H100), in rounds of
# SEG_WARP_ELEMS elements a warp. A block also keeps its per-slot sums (6
# KB at 512 slots), its warps' sums and a ratio a subtile.
CLUSTER_BLOCKS = 16
SEG_WARP_ELEMS = 512            # 32 lanes x 4 float4s
BLOCK_SMEM_BYTES = 232448
# The stash's budget across a segment, which sizes the segments
# (default_seg_elems, FusedLAMB's choice): eight blocks' shared memory
# less 16 KB each. It is held apart from CLUSTER_BLOCKS so that the
# layout, and the SR streams keyed by it, do not move with the kernel's
# cluster size; at sixteen blocks a cluster every segment it allows
# leaves a block under half an SM's shared memory (two blocks an SM).
DEFAULT_SEG_SMEM_BUDGET = 8 * (BLOCK_SMEM_BYTES - 16384)


def segment_smem_bytes(seg_elems: int, max_slots: int, stash_p: bool,
                       u_bytes: int = 4) -> int:
    """Shared memory one block of the segment kernel takes: its share of
    u (``u_bytes`` an element: 4 for fp32, 2 for a bf16 stash) and of p
    with ``stash_p`` (fp32), its per-slot sums, its warps' sums and a
    ratio a subtile (``segment_smem`` in the source)."""
    e = seg_elems // CLUSTER_BLOCKS
    return (u_bytes * e + (4 * e if stash_p else 0)
            + 4 * (3 * max_slots + 3 * (e // SEG_WARP_ELEMS)
                   + e // DEFAULT_ALIGN))


@dataclasses.dataclass(frozen=True, eq=False)
class SegmentMeta:
    """Static companion of a segment-aligned :class:`FlatSpace` (the
    reference's ``SegmentMeta``). A *segment* is ``seg_elems``
    consecutive elements. Every leaf either lives inside one segment
    ("small", with a slot there: ``slot_ids`` gives the slot of each
    2048-element subtile, -1 for padding, and ``slot_leaf`` the leaf of
    each slot) or starts at a segment boundary and owns whole segments
    ("large", listed in ``large`` as ``(leaf, start, padded_elems)``).
    ``stash_p`` and ``u_dtype_name`` are the kernel schedule's knobs,
    resolved at ``FusedLAMB.init``."""

    seg_elems: int
    n_segments: int
    small_segments: Tuple[int, ...]
    slot_ids: np.ndarray               # (n_small, seg_elems // align)
    slot_leaf: np.ndarray              # (n_small, max_slots)
    max_slots: int
    large: Tuple[Tuple[int, int, int], ...]
    stash_p: bool = True
    u_dtype_name: str = "float32"
    # the index maps on each device (device_maps, device_slot_leaf,
    # device_large, device_large_streams)
    _device: Dict[Any, Any] = dataclasses.field(
        default_factory=dict, compare=False, repr=False)

    def device_maps(self, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(small_segments, slot_ids)`` as int32 tensors on
        ``device``, made once per meta and device."""
        dev = torch.device(device)
        maps = self._device.get(dev)
        if maps is None:
            maps = (torch.as_tensor(np.asarray(self.small_segments,
                                               np.int32)).to(dev),
                    torch.as_tensor(np.ascontiguousarray(
                        self.slot_ids, np.int32)).to(dev))
            self._device[dev] = maps
        return maps

    def device_slot_leaf(self, device, num_leaves: int) -> torch.Tensor:
        """``slot_leaf`` flattened as an int64 tensor on ``device``, an
        empty slot mapped to ``num_leaves`` (a row past the last leaf),
        made once per meta and device."""
        dev = torch.device(device)
        key = ("slot_leaf", dev, num_leaves)
        ids = self._device.get(key)
        if ids is None:
            sl = np.asarray(self.slot_leaf, np.int64).reshape(-1)
            ids = torch.as_tensor(np.where(sl >= 0, sl, num_leaves)).to(dev)
            self._device[key] = ids
        return ids

    def device_large(self, device) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
        """The large leaves' maps on ``device``, made once: the int32
        indices of their segments (leaf by leaf, in order), their leaf
        indices, and an index matrix (one row per large leaf, one column
        per segment of the longest) into the segments' list, padded with
        the list's length (a zero appended there sums to nothing)."""
        dev = torch.device(device)
        key = ("large", dev)
        maps = self._device.get(key)
        if maps is None:
            segs, rows = [], []
            for _, start, plen in self.large:
                first = start // self.seg_elems
                k = plen // self.seg_elems
                rows.append(list(range(len(segs), len(segs) + k)))
                segs.extend(range(first, first + k))
            width = max((len(r) for r in rows), default=0)
            gather = np.full((len(rows), width), len(segs), np.int64)
            for i, r in enumerate(rows):
                gather[i, :len(r)] = r
            maps = (torch.as_tensor(np.asarray(segs, np.int32)).to(dev),
                    torch.as_tensor(np.asarray([l_ for l_, _, _ in self.large],
                                               np.int64)).to(dev),
                    torch.as_tensor(gather).to(dev))
            self._device[key] = maps
        return maps

    def device_large_streams(self, device) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
        """The large leaves' stochastic-rounding streams on ``device``,
        made once, as ``lamb_stage2_segments`` takes them: one int64 row
        per segment of ``device_large`` (leaf by leaf), the ordinal of the
        segment's leaf in ``large`` and that leaf's first element, and the
        large leaves' indices (``device_large``'s). The step's seed is
        all that changes from step to step."""
        dev = torch.device(device)
        key = ("large_streams", dev)
        rows = self._device.get(key)
        if rows is None:
            rows = [(k, start) for k, (_, start, plen) in enumerate(self.large)
                    for _ in range(plen // self.seg_elems)]
            rows = torch.as_tensor(np.asarray(rows, np.int64).reshape(-1, 2)
                                   ).to(dev)
            self._device[key] = rows
        return rows, self.device_large(dev)[1]


def default_seg_elems(total_estimate: int, cap: Optional[int] = None,
                      chunk: int = CHUNK,
                      scratch_bytes_per_elem: int = 8) -> int:
    """Segment size for a buffer of about ``total_estimate`` elements:
    ~1/8 of it, clamped to [1 chunk, cap] and rounded up to a chunk
    multiple (the reference's rule). The default cap is the most whole
    chunks the cluster's shared memory holds at
    ``scratch_bytes_per_elem`` (8 for the fp32 u + p stash pair)."""
    if cap is None:
        cap = (DEFAULT_SEG_SMEM_BUDGET // max(scratch_bytes_per_elem, 1)
               // chunk * chunk)
    want = max(chunk, min(cap, total_estimate // 8))
    return _round_up(want, chunk)


def segmented_space(tensors: Mapping[str, torch.Tensor],
                    seg_elems: Optional[int] = None, max_slots: int = 512,
                    align: int = DEFAULT_ALIGN, large: Sequence[str] = ()
                    ) -> Tuple[FlatSpace, SegmentMeta]:
    """A :class:`FlatSpace` whose leaf padding is segment-aware, plus its
    :class:`SegmentMeta` (the reference's ``segmented_space``, :269).

    Leaves keep the order they are given in. Padding grows where a small
    leaf would straddle a segment boundary, where a segment would pass
    ``max_slots`` leaves, and around a large leaf, which owns whole
    segments; each gap is absorbed into the previous leaf's padding.
    The leaves named in ``large`` are laid out as large ones whatever
    their size (a leaf whose norms are summed across ranks, which the
    segment kernel cannot wait for)."""
    large = frozenset(large)
    sizes_in = [(name, t.numel(), tuple(t.shape), t.dtype)
                for name, t in tensors.items()]
    if seg_elems is None:
        seg_elems = default_seg_elems(
            sum(_round_up(max(sz, 1), align) for _, sz, _, _ in sizes_in))
    if seg_elems % align:
        raise ValueError(f"seg_elems {seg_elems} must be a multiple of "
                         f"the alignment {align}")
    names, shapes, dtypes, offsets, sizes, padded = [], [], [], [], [], []
    small_places, large_places = [], []
    off = 0
    seg_fill_slots = 0
    for idx, (name, size, shape, dtype) in enumerate(sizes_in):
        base_pad = _round_up(max(size, 1), align)
        if base_pad > seg_elems or name in large:
            start = _round_up(off, seg_elems)
            psize = _round_up(base_pad, seg_elems)
            large_places.append((idx, start, psize))
            seg_fill_slots = max_slots        # a fresh segment next
        else:
            start = off
            seg_room = seg_elems - (start % seg_elems)
            if base_pad > seg_room or seg_fill_slots >= max_slots:
                start = _round_up(off, seg_elems)
                seg_fill_slots = 0
            if start % seg_elems == 0:
                seg_fill_slots = 0
            small_places.append((start // seg_elems, start, base_pad, idx))
            seg_fill_slots += 1
            psize = base_pad
        if offsets and start != off:
            padded[-1] += start - off
        names.append(name)
        shapes.append(shape)
        dtypes.append(dtype)
        offsets.append(start)
        sizes.append(size)
        padded.append(psize)
        off = start + psize
    total = _round_up(off, seg_elems)
    if padded:
        padded[-1] += total - off
    space = FlatSpace(names=tuple(names), shapes=tuple(shapes),
                      dtypes=tuple(dtypes), offsets=tuple(offsets),
                      sizes=tuple(sizes), padded_sizes=tuple(padded),
                      total=total, align=align)

    n_segments = total // seg_elems
    sub_per_seg = seg_elems // align
    large_segs = set()
    for _, start, psize in large_places:
        large_segs.update(range(start // seg_elems,
                                (start + psize) // seg_elems))
    small_segments = tuple(s for s in range(n_segments)
                           if s not in large_segs)
    seg_pos = {s: i for i, s in enumerate(small_segments)}
    slot_ids = np.full((len(small_segments), sub_per_seg), -1, np.int32)
    slot_leaf = np.full((len(small_segments), max_slots), -1, np.int32)
    next_slot: Dict[int, int] = {}
    for seg, start, psize, idx in small_places:
        row = seg_pos[seg]
        slot = next_slot.get(seg, 0)
        next_slot[seg] = slot + 1
        slot_leaf[row, slot] = idx
        lo = (start % seg_elems) // align
        slot_ids[row, lo:lo + psize // align] = slot
    used = max(next_slot.values(), default=1)
    ms = max(8, _round_up(used, 8))
    meta = SegmentMeta(seg_elems=seg_elems, n_segments=n_segments,
                       small_segments=small_segments, slot_ids=slot_ids,
                       slot_leaf=slot_leaf[:, :ms], max_slots=ms,
                       large=tuple(large_places))
    return space, meta


__all__ = ["CHUNK", "CHUNK_ROWS", "CLUSTER_BLOCKS", "DEFAULT_ALIGN",
           "DEFAULT_SEG_SMEM_BUDGET", "FlatSpace", "SEG_WARP_ELEMS",
           "SegmentMeta",
           "default_seg_elems", "segment_smem_bytes", "segmented_space"]
