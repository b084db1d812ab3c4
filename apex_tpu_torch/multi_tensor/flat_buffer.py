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
into the flat fp32 master and each ``.grad`` a view into one flat fp32
gradient buffer that autograd accumulates into in place
(:meth:`FlatSpace.bind`, :meth:`FlatSpace.leaves`): an in-place update
of the master is the weight update, and the gradients arrive already
flat. This is the contiguous-buffer layout of Megatron-LM's optimizer.

``segmented_space`` (the segment-aligned layout of the one-pass LAMB)
waits for the LAMB kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

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
        module's weights."""
        params = dict(module.named_parameters())
        if set(params) != set(self.names):
            raise ValueError(
                "the module's parameters do not match the flat space: "
                f"missing {sorted(set(self.names) - set(params))}, "
                f"unexpected {sorted(set(params) - set(self.names))}")
        if master.dtype != torch.float32 or grad.dtype != torch.float32:
            raise TypeError("bind needs fp32 master and grad buffers")
        for name, off, size, shape in zip(self.names, self.offsets,
                                          self.sizes, self.shapes):
            p = params[name]
            if p.dtype != torch.float32:
                raise TypeError(f"{name} is {p.dtype}; the flat master "
                                "holds fp32 parameters")
            p.data = master[off:off + size].view(shape)
            p.grad = grad[off:off + size].view(shape)

    def grad_fn(self, loss_fn: Callable, *, with_value: bool = False):
        """Differentiate a loss over the named leaves straight into this
        space: the returned ``fn(master, *args, **kwargs)`` calls
        ``loss_fn(leaves, *args, **kwargs)`` on views of ``master`` and
        returns the flat fp32 gradient (with the loss first when
        ``with_value``)."""
        def flat(master, *args, **kwargs):
            grad = torch.zeros_like(master, dtype=torch.float32)
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


__all__ = ["DEFAULT_ALIGN", "FlatSpace"]
