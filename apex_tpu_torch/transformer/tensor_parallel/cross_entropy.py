"""Vocab-parallel cross entropy: softmax cross entropy over logits split
on the vocab dim across the tensor axis, without gathering them.

Counterpart of ``apex_tpu/transformer/tensor_parallel/cross_entropy.py``
``vocab_parallel_cross_entropy`` (:29-82), in the reference's order of
operations: the max over the group (the gradient stopped at it, as
Megatron detaches it), the shift, the local target logit picked through
``VocabUtility`` with the targets outside this rank's shard masked to 0,
the log of the summed exps, then the label smoothing of :72-80. The
picked logit, the exp-sum and, under smoothing, the logit sum are summed
over the group through the reduce op whose backward is the identity
(Megatron's convention: every rank seeds the replicated loss with
cotangent 1, so an all-reduce in the backward would scale the gradient
by tp). The gradient is autograd's, each rank's the local softmax minus
its part of the one-hot. With one rank in the axis the shard is the
whole vocab [0, V) and every reduction is the identity.

Its label smoothing is Megatron's, not xentropy's: it mixes in the mean
log-probability with weight ``s * V / (V - 1)``, where
``softmax_cross_entropy_loss`` uses ``s`` itself. Both conventions are
kept.
"""

from __future__ import annotations

import torch

from apex_tpu_torch.transformer.parallel_state import TENSOR_AXIS
from apex_tpu_torch.transformer.tensor_parallel.mappings import (
    AxisLike,
    all_reduce_max,
    reduce_from_tensor_model_parallel_region,
    tensor_axis,
)
from apex_tpu_torch.transformer.tensor_parallel.utils import VocabUtility


def vocab_parallel_cross_entropy(vocab_parallel_logits: torch.Tensor,
                                 target: torch.Tensor,
                                 label_smoothing: float = 0.0,
                                 axis_name: AxisLike = TENSOR_AXIS
                                 ) -> torch.Tensor:
    """Per-token fp32 losses: ``vocab_parallel_logits`` (..., V / tp),
    this rank's shard of the vocab; ``target`` (...) global token ids."""
    ax = tensor_axis(axis_name)
    logits = vocab_parallel_logits.float()
    logits_max = all_reduce_max(torch.amax(logits.detach(), dim=-1), ax)
    logits = logits - logits_max[..., None]

    per = logits.shape[-1]
    start, end = VocabUtility.vocab_range_from_per_partition_vocab_size(
        per, ax.index, ax.size)
    # a target outside [start, end) picks 0 here: another rank holds it
    target = target.long()
    in_range = (target >= start) & (target < end)
    local_target = torch.where(in_range, target - start, 0)
    picked = torch.gather(logits, -1, local_target[..., None])[..., 0]
    target_logit = reduce_from_tensor_model_parallel_region(
        torch.where(in_range, picked, 0.0), ax)

    sum_exp = reduce_from_tensor_model_parallel_region(
        torch.sum(torch.exp(logits), dim=-1), ax)
    lse = torch.log(sum_exp)
    loss = lse - target_logit
    if label_smoothing > 0.0:
        vocab_size = per * ax.size
        smoothing = label_smoothing * vocab_size / (vocab_size - 1)
        mean_logit = reduce_from_tensor_model_parallel_region(
            torch.sum(logits, dim=-1), ax) / vocab_size
        mean_log_prob = mean_logit - lse
        loss = (1.0 - smoothing) * loss - smoothing * mean_log_prob
    return loss


__all__ = ["vocab_parallel_cross_entropy"]
