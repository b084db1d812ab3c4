"""Column/Row parallel linears and the vocab-parallel embedding.

Counterpart of ``apex_tpu/transformer/tensor_parallel/layers.py``
(:79-277). Weights keep the ``(out, in)`` layout.

A layer reads the tensor axis from ``transformer.parallel_state`` when
it is built (the counterpart of the reference's ``_inside_axis``, :50):

- **one rank in the axis** (no topology, or tp=1): every layer is dense,
  and the rounding matches the reference step by step: the product runs
  in the compute dtype with fp32 accumulation, the result is rounded to
  the compute dtype, and only then is the bias added, in that dtype
  (:122-132, :194-211). The products are plain ``torch.matmul`` calls, as
  the reference leaves them to XLA; the bias is deliberately not folded
  into ``F.linear``.
- **tp > 1**: the layer holds this rank's shard and calls the mapping
  ops (``mappings.py``). Parameters are drawn full-size and sharded at
  the boundary (:4-11): every rank draws the same full tensor (from
  ``generator``, on the CPU) and keeps its slice, so a tp=2 layer is the
  tp=1 layer cut in two. ``ColumnParallelLinear`` splits the output dim
  (``gather_output``, ``skip_bias_add``); ``RowParallelLinear`` the input
  dim and, with ``reduce_in_fp32`` (the default, :153-162), all-reduces
  the fp32 partial products, rounds once to the compute dtype and then
  adds the replicated bias; ``VocabParallelEmbedding`` masks the rows
  outside its shard and all-reduces the lookups.
  ``sequence_parallel_enabled``: the column layer all-gathers the
  sequence dim (its gradient reduce-scattered), the row layer
  reduce-scatters its output over it.

``linear_with_grad_accumulation_and_async_allreduce`` is the functional
core with the same data movement; the reference leaves the overlap of
the all-reduce with the backward product to XLA, and the port does not
overlap it (the collective runs where autograd reaches it).

The ``*_spec`` functions give each parameter's layout as a plain tuple,
one entry a dim: the axis name where it is split, None where not.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from apex_tpu_torch._backend import DeviceLike, resolve_device
from apex_tpu_torch.transformer.parallel_state import TENSOR_AXIS
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    AxisLike,
    TensorAxis,
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    reduce_scatter_to_sequence_parallel_region,
    scatter_to_tensor_model_parallel_region,
    tensor_axis,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import (
    VocabUtility,
    shard_tensor,
)

Spec = Tuple[Optional[str], ...]


def column_kernel_spec() -> Spec:
    return (TENSOR_AXIS, None)


def column_bias_spec() -> Spec:
    return (TENSOR_AXIS,)


def row_kernel_spec() -> Spec:
    return (None, TENSOR_AXIS)


def row_bias_spec() -> Spec:
    return ()


def vocab_embedding_spec() -> Spec:
    return (TENSOR_AXIS, None)


def _shard(full: torch.Tensor, spec: Spec, ax: TensorAxis) -> torch.Tensor:
    return shard_tensor(full, spec, {TENSOR_AXIS: ax.size},
                        {TENSOR_AXIS: ax.index}).contiguous()


def _drawn(shape, std: float, spec: Spec, ax: TensorAxis, dtype,
           dev: torch.device, generator) -> nn.Parameter:
    """A parameter of full ``shape`` drawn N(0, std) and cut to this
    rank's shard: on ``dev`` from the default generator where the layer
    is whole and no generator is given (the draw of a dense layer), else
    on the CPU from ``generator``, so that every rank draws the same full
    tensor."""
    on_cpu = generator is not None or ax.size > 1
    full = torch.empty(shape, dtype=dtype, device="cpu" if on_cpu else dev)
    full.normal_(0.0, std, generator=generator)
    return nn.Parameter(_shard(full, spec, ax).to(dev))


def _zeros(shape, spec: Spec, ax: TensorAxis, dtype,
           dev: torch.device) -> nn.Parameter:
    local = list(shape)
    for dim, axis in enumerate(spec):
        if axis is not None:
            local[dim] //= ax.size
    return nn.Parameter(torch.zeros(local, dtype=dtype, device=dev))


class _Linear(nn.Module):
    weight_spec: Spec = ()
    bias_spec: Spec = ()

    def __init__(self, input_size: int, output_size: int, *,
                 use_bias: bool = True, skip_bias_add: bool = False,
                 sequence_parallel_enabled: bool = False,
                 axis_name: AxisLike = TENSOR_AXIS,
                 dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.axis = tensor_axis(axis_name)
        for dim, axis in enumerate(self.weight_spec):
            size = (output_size, input_size)[dim]
            if axis is not None and size % self.axis.size:
                raise ValueError(
                    f"tensor-parallel size {self.axis.size} does not divide "
                    f"the split dim {dim} of a ({output_size}, {input_size}) "
                    "weight")
        self.dtype = dtype
        self.skip_bias_add = skip_bias_add
        self.sequence_parallel_enabled = sequence_parallel_enabled
        # variance 1 / fan_in, the scale of the reference's lecun init
        self.weight = _drawn((output_size, input_size), input_size ** -0.5,
                             self.weight_spec, self.axis, param_dtype, dev,
                             generator)
        self.bias = (_zeros((output_size,), self.bias_spec, self.axis,
                            param_dtype, dev) if use_bias else None)

    @property
    def tensor_parallel(self) -> bool:
        return self.axis.size > 1


class ColumnParallelLinear(_Linear):
    """Y = X W^T + b, W (out, in) split on the output dim over the tensor
    axis. ``gather_output`` all-gathers the output's last dim (not under
    sequence parallelism); ``skip_bias_add`` returns ``(y, bias)``."""

    weight_spec = column_kernel_spec()
    bias_spec = column_bias_spec()

    def __init__(self, input_size: int, output_size: int, *,
                 gather_output: bool = True, **kw):
        super().__init__(input_size, output_size, **kw)
        if self.tensor_parallel and gather_output \
                and self.sequence_parallel_enabled:
            raise ValueError("gather_output is incompatible with "
                             "sequence_parallel_enabled")
        self.gather_output = gather_output

    def forward(self, x: torch.Tensor):
        dtype = self.dtype or x.dtype
        if self.tensor_parallel:
            if self.sequence_parallel_enabled:
                x = gather_from_sequence_parallel_region(x, self.axis, True)
            else:
                x = copy_to_tensor_model_parallel_region(x, self.axis)
        y = torch.matmul(x.to(dtype), self.weight.to(dtype).t())
        bias_out = None
        if self.bias is not None:
            if self.skip_bias_add:
                bias_out = self.bias.to(dtype)
            else:
                y = y + self.bias.to(dtype)
        if self.tensor_parallel and self.gather_output:
            y = gather_from_tensor_model_parallel_region(y, self.axis)
        return (y, bias_out) if self.skip_bias_add else y


class RowParallelLinear(_Linear):
    """Y = X W^T + b, W (out, in) split on the input dim over the tensor
    axis. The input arrives split on its last dim (``input_is_parallel``,
    the Megatron path) or is scattered here; the bias is added after the
    reduction, replicated."""

    weight_spec = row_kernel_spec()
    bias_spec = row_bias_spec()

    def __init__(self, input_size: int, output_size: int, *,
                 input_is_parallel: bool = True, reduce_in_fp32: bool = True,
                 **kw):
        super().__init__(input_size, output_size, **kw)
        self.input_is_parallel = input_is_parallel
        self.reduce_in_fp32 = reduce_in_fp32

    def forward(self, x: torch.Tensor):
        dtype = self.dtype or x.dtype
        tp = self.tensor_parallel
        if tp and not self.input_is_parallel:
            x = scatter_to_tensor_model_parallel_region(x, self.axis)
        if tp and self.reduce_in_fp32:
            # the fp32 partial product of the dtype-rounded operands,
            # reduced before the one rounding to the compute dtype
            y = torch.matmul(x.to(dtype).float(),
                             self.weight.to(dtype).float().t())
        else:
            y = torch.matmul(x.to(dtype), self.weight.to(dtype).t())
        if tp:
            if self.sequence_parallel_enabled:
                y = reduce_scatter_to_sequence_parallel_region(y, self.axis)
            else:
                y = reduce_from_tensor_model_parallel_region(y, self.axis)
        y = y.to(dtype)
        b = None if self.bias is None else self.bias.to(dtype)
        if self.skip_bias_add:
            return y, b
        return y if b is None else y + b


class VocabParallelEmbedding(nn.Module):
    """Token embedding ``(num_embeddings, embedding_dim)``, split on the
    vocab dim over the tensor axis; looks rows up and casts them to
    ``dtype`` (the parameter dtype when None). At tp > 1 the tokens
    outside this rank's rows look up 0 and the lookups are all-reduced."""

    def __init__(self, num_embeddings: int, embedding_dim: int, *,
                 axis_name: AxisLike = TENSOR_AXIS,
                 dtype: Optional[torch.dtype] = None,
                 param_dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.axis = tensor_axis(axis_name)
        if num_embeddings % self.axis.size:
            raise ValueError(
                f"tensor-parallel size {self.axis.size} does not divide "
                f"the vocab ({num_embeddings})")
        self.dtype = dtype
        self.weight = _drawn((num_embeddings, embedding_dim), 0.02,
                             vocab_embedding_spec(), self.axis, param_dtype,
                             resolve_device(device), generator)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        dtype = self.dtype or self.weight.dtype
        if self.axis.size == 1:
            return self.weight[token_ids].to(dtype)
        start, end = VocabUtility.vocab_range_from_per_partition_vocab_size(
            self.weight.shape[0], self.axis.index, self.axis.size)
        inside = (token_ids >= start) & (token_ids < end)
        local = torch.where(inside, token_ids - start, 0)
        out = self.weight[local].to(dtype).masked_fill(~inside[..., None], 0)
        return reduce_from_tensor_model_parallel_region(out, self.axis)


def linear_with_grad_accumulation_and_async_allreduce(
        x: torch.Tensor, weight: torch.Tensor,
        bias: Optional[torch.Tensor] = None, *,
        sequence_parallel_enabled: bool = False,
        axis_name: AxisLike = TENSOR_AXIS) -> torch.Tensor:
    """The tensor-parallel linear's forward (the reference's :255): over a
    tensor axis of more than one rank, the input is all-gathered along
    the sequence dim (sequence parallel; the gradient reduce-scattered)
    or copied (its gradient all-reduced); then ``x @ weight^T`` in x's
    dtype, plus ``bias``."""
    ax = tensor_axis(axis_name)
    if ax.size > 1:
        if sequence_parallel_enabled:
            x = gather_from_sequence_parallel_region(x, ax, True)
        else:
            x = copy_to_tensor_model_parallel_region(x, ax)
    y = torch.matmul(x, weight.to(x.dtype).t())
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding", "column_bias_spec", "column_kernel_spec",
           "linear_with_grad_accumulation_and_async_allreduce",
           "row_bias_spec", "row_kernel_spec", "vocab_embedding_spec"]
