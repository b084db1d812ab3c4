"""Transformer functional ops (counterpart of
``apex_tpu/transformer/functional``): the fused softmax dispatcher. The
RoPE re-exports come with the RoPE kernel."""

from apex_tpu_torch.transformer.functional.fused_softmax import (
    AttnMaskType,
    FusedScaleMaskSoftmax,
)

__all__ = ["AttnMaskType", "FusedScaleMaskSoftmax"]
