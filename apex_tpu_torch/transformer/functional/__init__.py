"""Transformer functional ops (counterpart of
``apex_tpu/transformer/functional``): the fused softmax dispatcher and
the four RoPE variants (the RoPE kernel lives in ``ops/rope.py``)."""

from apex_tpu_torch.ops.rope import (
    fused_apply_rotary_pos_emb,
    fused_apply_rotary_pos_emb_2d,
    fused_apply_rotary_pos_emb_cached,
    fused_apply_rotary_pos_emb_thd,
)
from apex_tpu_torch.transformer.functional.fused_softmax import (
    AttnMaskType,
    FusedScaleMaskSoftmax,
)

__all__ = ["AttnMaskType", "FusedScaleMaskSoftmax",
           "fused_apply_rotary_pos_emb", "fused_apply_rotary_pos_emb_2d",
           "fused_apply_rotary_pos_emb_cached",
           "fused_apply_rotary_pos_emb_thd"]
