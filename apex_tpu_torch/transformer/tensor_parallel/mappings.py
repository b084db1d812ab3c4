"""The tensor-parallel and sequence-parallel mapping ops, with Megatron's
backward passes, over the tensor axis's process group.

Counterpart of ``apex_tpu/transformer/tensor_parallel/mappings.py``
(:65-192), whose ops are ``jax.custom_vjp`` functions over ``lax``
collectives inside ``shard_map``. Here each is a
``torch.autograd.Function`` over the group of the ``tensor`` axis of
``transformer.parallel_state`` (``ps.axis_group``); the pairs are the
same:

  copy            identity    / all-reduce
  reduce          all-reduce  / identity
  scatter (last)  split       / all-gather
  gather  (last)  all-gather  / split
  scatter_to_sequence_parallel   split (first) / all-gather (first)
  gather_from_sequence_parallel  all-gather (first) / reduce-scatter, or a
                                 split with tensor_parallel_output_grad=False
  reduce_scatter_to_sequence_parallel  reduce-scatter (first) / all-gather

With one rank in the axis (no topology, or a tensor axis of size 1)
every op returns its input. ``axis`` is an axis name or a resolved
:class:`TensorAxis` (a layer resolves its axis once, when it is built).

The collectives are ``torch.distributed``'s on the caller's tensor: over
NCCL a CUDA tensor stays on the card; over gloo, which takes CUDA
tensors too, it crosses host memory inside the collective and comes
back to the card, so the caller's work stays where it was. A
reduce-scatter is an all-reduce followed by this rank's chunk: the same
sum (gloo has no reduce-scatter of CUDA tensors), twice the bytes. The
all-gather gathers into a list of chunks and concatenates them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.distributed as dist

from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.parallel_state import TENSOR_AXIS


class TensorAxis(NamedTuple):
    """One rank's view of an axis: its process group (None for a group
    of one) and the group's ranks in axis order."""

    group: Optional[object]
    ranks: Tuple[int, ...]
    index: int

    @property
    def size(self) -> int:
        return len(self.ranks)


AxisLike = Union[str, TensorAxis]


def tensor_axis(axis: Optional[AxisLike] = TENSOR_AXIS) -> TensorAxis:
    """``axis`` resolved on this rank: the axis's group of the live
    topology, or a group of one without one (and for ``axis=None``,
    whatever the topology: a whole, dense layer)."""
    if isinstance(axis, TensorAxis):
        return axis
    me = dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0
    if axis is None:
        return TensorAxis(None, (me,), 0)
    group, ranks = ps.axis_group(axis)
    ranks = tuple(int(r) for r in ranks)
    return TensorAxis(group, ranks, ranks.index(me) if me in ranks else 0)


# -- the raw collectives ------------------------------------------------------


def _all_reduce(x: torch.Tensor, ax: TensorAxis,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, op=op, group=ax.group)
    return y


def _all_gather(x: torch.Tensor, dim: int, ax: TensorAxis) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(ax.size)]
    dist.all_gather(parts, x, group=ax.group)
    return torch.cat(parts, dim=dim)


def _split(x: torch.Tensor, dim: int, ax: TensorAxis) -> torch.Tensor:
    n = x.shape[dim]
    if n % ax.size:
        raise ValueError(f"dim {dim} of size {n} does not split over "
                         f"{ax.size} ranks")
    chunk = n // ax.size
    return x.narrow(dim, ax.index * chunk, chunk).contiguous()


def _reduce_scatter(x: torch.Tensor, dim: int, ax: TensorAxis
                    ) -> torch.Tensor:
    return _split(_all_reduce(x, ax), dim, ax)


# -- the seven ops ------------------------------------------------------------


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.ax), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return _all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _split(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.ax), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim, reduce_grad):
        ctx.ax, ctx.dim, ctx.reduce_grad = ax, dim, reduce_grad
        return _all_gather(x, dim, ax)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce_grad:
            return _reduce_scatter(g, ctx.dim, ctx.ax), None, None, None
        return _split(g, ctx.dim, ctx.ax), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _reduce_scatter(x, 0, ax)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, 0, ctx.ax), None


def copy_to_tensor_model_parallel_region(x: torch.Tensor,
                                         axis: AxisLike = TENSOR_AXIS):
    """Identity forward; the gradient all-reduced (the entry of a
    column-parallel block: each rank contributes a partial gradient)."""
    ax = tensor_axis(axis)
    return x if ax.size == 1 else _Copy.apply(x, ax)


def reduce_from_tensor_model_parallel_region(x: torch.Tensor,
                                             axis: AxisLike = TENSOR_AXIS):
    """All-reduce forward; identity gradient (the exit of a row-parallel
    product)."""
    ax = tensor_axis(axis)
    return x if ax.size == 1 else _Reduce.apply(x, ax)


def scatter_to_tensor_model_parallel_region(x: torch.Tensor,
                                            axis: AxisLike = TENSOR_AXIS):
    """This rank's chunk of the last dim; the gradient all-gathered."""
    ax = tensor_axis(axis)
    return x if ax.size == 1 else _Scatter.apply(x, ax, x.ndim - 1)


def gather_from_tensor_model_parallel_region(x: torch.Tensor,
                                             axis: AxisLike = TENSOR_AXIS):
    """The ranks' chunks concatenated along the last dim; the gradient
    split."""
    ax = tensor_axis(axis)
    return x if ax.size == 1 else _Gather.apply(x, ax, x.ndim - 1, False)


def scatter_to_sequence_parallel_region(x: torch.Tensor,
                                        axis: AxisLike = TENSOR_AXIS):
    """This rank's chunk of the first (sequence) dim; the gradient
    all-gathered."""
    ax = tensor_axis(axis)
    return x if ax.size == 1 else _Scatter.apply(x, ax, 0)


def gather_from_sequence_parallel_region(
        x: torch.Tensor, axis: AxisLike = TENSOR_AXIS,
        tensor_parallel_output_grad: bool = True):
    """The sequence chunks all-gathered along the first dim; the
    gradient reduce-scattered when the consumer is tensor-parallel (each
    rank holds a partial gradient of the whole sequence), else split."""
    ax = tensor_axis(axis)
    return x if ax.size == 1 else _Gather.apply(
        x, ax, 0, bool(tensor_parallel_output_grad))


def reduce_scatter_to_sequence_parallel_region(x: torch.Tensor,
                                               axis: AxisLike = TENSOR_AXIS):
    """Reduce-scatter along the first (sequence) dim; the gradient
    all-gathered (the exit of a row-parallel product under sequence
    parallelism)."""
    ax = tensor_axis(axis)
    return x if ax.size == 1 else _ReduceScatter.apply(x, ax)


def all_reduce_max(x: torch.Tensor, axis: AxisLike = TENSOR_AXIS
                   ) -> torch.Tensor:
    """The elementwise max over the axis, without a gradient (the
    reference's ``lax.pmax`` of a stopped value)."""
    ax = tensor_axis(axis)
    x = x.detach()
    return x if ax.size == 1 else _all_reduce(x, ax, dist.ReduceOp.MAX)


__all__ = [
    "AxisLike", "TensorAxis", "all_reduce_max",
    "copy_to_tensor_model_parallel_region",
    "gather_from_sequence_parallel_region",
    "gather_from_tensor_model_parallel_region",
    "reduce_from_tensor_model_parallel_region",
    "reduce_scatter_to_sequence_parallel_region",
    "scatter_to_sequence_parallel_region",
    "scatter_to_tensor_model_parallel_region", "tensor_axis",
]
