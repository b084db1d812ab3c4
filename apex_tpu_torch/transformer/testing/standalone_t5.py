"""Standalone T5 fixture (counterpart of
``apex_tpu/transformer/testing/standalone_t5.py``): a thin wrapper over
the model family in ``apex_tpu_torch.models.t5``, kept at the fixture's
path."""

from typing import Optional

import torch

from apex_tpu_torch._backend import DeviceLike
from apex_tpu_torch.models.t5 import (
    DecoderLayer,
    EncoderLayer,
    T5Config,
    T5Model,
    encoder_decoder_stage_layout,
    t5_loss_fn,
)


def t5_model_provider(config: Optional[T5Config] = None, *,
                      device: DeviceLike = None,
                      generator: Optional[torch.Generator] = None,
                      **kw) -> T5Model:
    """A :class:`T5Model` of ``config`` (or ``T5Config(**kw)``) on
    ``device`` (CUDA unless named), its weights drawn from
    ``generator``."""
    return T5Model(config or T5Config(**kw), device=device,
                   generator=generator)


__all__ = ["DecoderLayer", "EncoderLayer", "T5Config", "T5Model",
           "encoder_decoder_stage_layout", "t5_loss_fn", "t5_model_provider"]
