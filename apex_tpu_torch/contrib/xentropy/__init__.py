"""Fused softmax cross-entropy, the contrib surface.

Counterpart of ``apex_tpu/contrib/xentropy/__init__.py``. The kernels
live in :mod:`apex_tpu_torch.ops.xentropy` (the forward saves only the
per-row logsumexp and the backward recomputes the probabilities); this
module adds the contrib semantics on top: label smoothing and
``padding_idx`` rows whose loss, and so whose gradient, is exactly 0,
as the original's ``losses.masked_fill_(labels == padding_idx, 0)``.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.ops.xentropy import softmax_cross_entropy_loss


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          smoothing: float = 0.0, padding_idx: int = 0,
                          half_to_float: bool = False) -> torch.Tensor:
    """Per-example fp32 losses shaped like ``labels``, 0 where the label
    is ``padding_idx``. ``half_to_float`` is the original's output-dtype
    flag: accepted and ignored, the output is always fp32 (the kernel
    accumulates in fp32 whatever the logits' dtype), as in the
    reference."""
    del half_to_float
    losses = softmax_cross_entropy_loss(logits, labels, smoothing)
    return torch.where(labels == padding_idx, 0.0, losses)


class SoftmaxCrossEntropyLoss:
    """``SoftmaxCrossEntropyLoss.apply(logits, labels, smoothing,
    padding_idx, half_to_float)``, as in apex.contrib.xentropy."""

    @staticmethod
    def apply(logits, labels, smoothing=0.0, padding_idx=0,
              half_to_float=False):
        return softmax_cross_entropy(logits, labels, smoothing, padding_idx,
                                     half_to_float)


__all__ = ["SoftmaxCrossEntropyLoss", "softmax_cross_entropy"]
