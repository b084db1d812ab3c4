"""Tensor-parallel layers, the mapping ops, the vocab-parallel cross
entropy and their helpers (counterpart of
``apex_tpu/transformer/tensor_parallel/``, ``__init__.py:1-41``). The
reference's ``data``, ``memory`` and ``random`` modules belong to a
later slice of the port (ROADMAP A 11)."""

from apex_tpu_torch.transformer.tensor_parallel.cross_entropy import (
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.layers import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    column_bias_spec,
    column_kernel_spec,
    linear_with_grad_accumulation_and_async_allreduce,
    row_bias_spec,
    row_kernel_spec,
    vocab_embedding_spec,
)
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    TensorAxis,
    copy_to_tensor_model_parallel_region,
    gather_from_sequence_parallel_region,
    gather_from_tensor_model_parallel_region,
    reduce_from_tensor_model_parallel_region,
    reduce_scatter_to_sequence_parallel_region,
    scatter_to_sequence_parallel_region,
    scatter_to_tensor_model_parallel_region,
    tensor_axis,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import (
    VocabUtility,
    divide,
    ensure_divisibility,
    shard_tensor,
    split_tensor_along_last_dim,
)

__all__ = [
    "ColumnParallelLinear", "RowParallelLinear", "TensorAxis",
    "VocabParallelEmbedding", "VocabUtility", "column_bias_spec",
    "column_kernel_spec", "copy_to_tensor_model_parallel_region", "divide",
    "ensure_divisibility", "gather_from_sequence_parallel_region",
    "gather_from_tensor_model_parallel_region",
    "linear_with_grad_accumulation_and_async_allreduce",
    "reduce_from_tensor_model_parallel_region",
    "reduce_scatter_to_sequence_parallel_region", "row_bias_spec",
    "row_kernel_spec", "scatter_to_sequence_parallel_region",
    "scatter_to_tensor_model_parallel_region", "shard_tensor",
    "split_tensor_along_last_dim", "tensor_axis", "vocab_embedding_spec",
    "vocab_parallel_cross_entropy",
]
