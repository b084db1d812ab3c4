"""Vocab-parallel cross entropy at tp=1.

Counterpart of ``apex_tpu/transformer/tensor_parallel/cross_entropy.py``
``vocab_parallel_cross_entropy`` outside a tensor-parallel axis, where
the one shard holds the whole vocab [0, V): plain PyTorch in the
reference's order of operations (max detached, shift, the picked target
logit, the log of the summed exps, then the label smoothing of :72-80),
its gradient by autograd, as the reference's falls out of AD over its
psums. The vocab split across ranks waits for the tensor-parallel slice
(ROADMAP A 9), as ``layers.py`` does.

Its label smoothing is Megatron's, not xentropy's: it mixes in the mean
log-probability with weight ``s * V / (V - 1)``, where
``softmax_cross_entropy_loss`` uses ``s`` itself. Both conventions are
kept.
"""

from __future__ import annotations

import torch


def vocab_parallel_cross_entropy(vocab_parallel_logits: torch.Tensor,
                                 target: torch.Tensor,
                                 label_smoothing: float = 0.0
                                 ) -> torch.Tensor:
    """Per-token fp32 losses: ``vocab_parallel_logits`` (..., V),
    ``target`` (...) token ids."""
    logits = vocab_parallel_logits.float()
    # the shift is gradient-transparent; the reference stops the gradient
    # at the max, as Megatron detaches it
    logits_max = torch.amax(logits.detach(), dim=-1)
    logits = logits - logits_max.detach()[..., None]

    vocab_size = logits.shape[-1]
    # a target outside [0, V) picks 0, as the reference's shard mask does
    target = target.long()
    in_range = (target >= 0) & (target < vocab_size)
    local_target = torch.where(in_range, target, 0)
    picked = torch.gather(logits, -1, local_target[..., None])[..., 0]
    target_logit = torch.where(in_range, picked, 0.0)

    lse = torch.log(torch.sum(torch.exp(logits), dim=-1))
    loss = lse - target_logit
    if label_smoothing > 0.0:
        smoothing = label_smoothing * vocab_size / (vocab_size - 1)
        mean_logit = torch.sum(logits, dim=-1) / vocab_size
        mean_log_prob = mean_logit - lse
        loss = (1.0 - smoothing) * loss - smoothing * mean_log_prob
    return loss


__all__ = ["vocab_parallel_cross_entropy"]
