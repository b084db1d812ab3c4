"""Transformer enums (counterpart of ``apex_tpu/transformer/enums.py``,
its own copy: the port imports nothing of the JAX package).
``AttnMaskType`` is the port's own, from ``functional/fused_softmax.py``."""

import enum

from apex_tpu_torch.transformer.functional.fused_softmax import AttnMaskType


class LayerType(enum.Enum):
    encoder = 1
    decoder = 2


class AttnType(enum.Enum):
    self_attn = 1
    cross_attn = 2


class ModelType(enum.Enum):
    encoder_or_decoder = 1
    encoder_and_decoder = 2


__all__ = ["AttnMaskType", "AttnType", "LayerType", "ModelType"]
