"""Fused update engine over flat buffers (counterpart of
``apex_tpu/multi_tensor/``).

- `FlatSpace`: the aligned flat layout of a model's parameters, with
  parameters and gradients bound as views into flat buffers;
- `fused_elementwise`: one sweep of a functor over flat buffers, a CUDA
  kernel per ported functor on CUDA tensors, plain PyTorch on CPU
  tensors;
- `fused_adam_update`: the Adam / AdamW functor (kernel
  ``csrc/fused_adam.cu``).
"""

from apex_tpu_torch.multi_tensor.engine import (
    fused_elementwise,
    register_kernel,
)
from apex_tpu_torch.multi_tensor.flat_buffer import DEFAULT_ALIGN, FlatSpace
from apex_tpu_torch.multi_tensor.ops import fused_adam_update

__all__ = ["DEFAULT_ALIGN", "FlatSpace", "fused_adam_update",
           "fused_elementwise", "register_kernel"]
