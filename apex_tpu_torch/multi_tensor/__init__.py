"""Fused update engine over flat buffers (counterpart of
``apex_tpu/multi_tensor/``).

- `FlatSpace`: the aligned flat layout of a model's parameters, with
  parameters and gradients bound as views into flat buffers;
  `segmented_space` / `SegmentMeta`: the segment-aligned layout of the
  one-pass LAMB;
- `fused_elementwise`: one sweep of a functor over flat buffers, a CUDA
  kernel per ported functor on CUDA tensors, plain PyTorch on CPU
  tensors; `fused_sumsq_partials`: per-tile sums of squares
  (``csrc/sumsq.cu``);
- `multi_tensor_scale` and `multi_tensor_axpby` (the scale and axpby
  functors, ``csrc/scale_axpby.cu``);
- `fused_adam_update`: the Adam / AdamW functor (``csrc/fused_adam.cu``);
- `fused_adagrad_update` and `fused_novograd_update` (the Adagrad and
  NovoGrad functors, ``csrc/adagrad_novograd.cu``);
- the L2 norms (`per_tensor_l2norm`, `multi_tensor_l2norm`,
  `fused_unscale_l2norm`);
- LAMB: `fused_lamb_compute_update_term` and `fused_lamb_update` (the
  two stages, ``csrc/fused_lamb.cu``), `lamb_trust_ratio`, and
  `fused_lamb_segmented_update` (the one-pass segment kernel,
  ``csrc/lamb_segment.cu``).
- `fused_sgd_update` and `fused_lars_update` (the SGD and LARS
  functors, ``csrc/fused_sgd.cu``).
"""

from apex_tpu_torch.multi_tensor.engine import (
    fused_elementwise,
    fused_sumsq_partials,
    register_kernel,
)
from apex_tpu_torch.multi_tensor.flat_buffer import (
    DEFAULT_ALIGN,
    FlatSpace,
    SegmentMeta,
    default_seg_elems,
    segmented_space,
)
from apex_tpu_torch.multi_tensor.ops import (
    fused_adagrad_update,
    fused_adam_update,
    fused_lamb_compute_update_term,
    fused_lamb_update,
    fused_lars_update,
    fused_novograd_update,
    fused_sgd_update,
    fused_unscale_l2norm,
    lamb_trust_ratio,
    multi_tensor_axpby,
    multi_tensor_l2norm,
    multi_tensor_scale,
    per_tensor_l2norm,
)
from apex_tpu_torch.multi_tensor.segmented import fused_lamb_segmented_update

__all__ = ["DEFAULT_ALIGN", "FlatSpace", "SegmentMeta", "default_seg_elems",
           "fused_adagrad_update", "fused_adam_update", "fused_elementwise",
           "fused_lamb_compute_update_term", "fused_lamb_segmented_update",
           "fused_lamb_update", "fused_lars_update", "fused_novograd_update",
           "fused_sgd_update", "fused_sumsq_partials",
           "fused_unscale_l2norm", "lamb_trust_ratio", "multi_tensor_axpby",
           "multi_tensor_l2norm", "multi_tensor_scale", "per_tensor_l2norm",
           "register_kernel", "segmented_space"]
