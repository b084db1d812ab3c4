"""The (s, b, heads, head_dim) <-> kernel-layout bridge of flash attention
(counterpart of ``apex_tpu/models/_flash_bridge.py``): the model families
keep activations in Megatron's sbh layout, the flash kernels take (b,
heads, s, d)."""

from __future__ import annotations

import torch

from apex_tpu_torch.ops.attention import flash_attention


def flash_sbhd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               attention=flash_attention, **kwargs) -> torch.Tensor:
    """q (sq, b, h, d), k/v (sk, b, hk, d) -> (sq, b, h*d). ``kwargs``
    pass to ``attention`` (:func:`flash_attention`, or its plain version
    ``attention_plain``): causal, segment ids, dropout, window,
    positions."""
    sq, b = q.shape[0], q.shape[1]
    qb, kb, vb = (t.permute(1, 2, 0, 3).contiguous() for t in (q, k, v))
    out = attention(qb, kb, vb, **kwargs)
    return out.permute(2, 0, 1, 3).reshape(sq, b, -1)


__all__ = ["flash_sbhd"]
