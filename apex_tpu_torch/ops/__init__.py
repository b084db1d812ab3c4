"""Fused ops: each has a hand-written CUDA kernel for CUDA tensors and a
plain PyTorch version for CPU tensors (counterpart of ``apex_tpu/ops/``)."""

from apex_tpu_torch.ops.attention import attention_plain, flash_attention
from apex_tpu_torch.ops.layer_norm import (
    fused_layer_norm,
    fused_rms_norm,
    layer_norm_plain,
)
from apex_tpu_torch.ops.rope import (
    fused_apply_rotary_pos_emb,
    fused_apply_rotary_pos_emb_2d,
    fused_apply_rotary_pos_emb_cached,
    fused_apply_rotary_pos_emb_thd,
)
from apex_tpu_torch.ops.softmax import (
    generic_scaled_masked_softmax,
    scaled_masked_softmax,
    scaled_softmax,
    scaled_upper_triang_masked_softmax,
    softmax_plain,
)
from apex_tpu_torch.ops.xentropy import softmax_cross_entropy_loss

__all__ = ["attention_plain", "flash_attention",
           "fused_apply_rotary_pos_emb", "fused_apply_rotary_pos_emb_2d",
           "fused_apply_rotary_pos_emb_cached",
           "fused_apply_rotary_pos_emb_thd", "fused_layer_norm",
           "fused_rms_norm", "generic_scaled_masked_softmax",
           "layer_norm_plain", "scaled_masked_softmax", "scaled_softmax",
           "scaled_upper_triang_masked_softmax",
           "softmax_cross_entropy_loss", "softmax_plain"]
