"""Fused normalization modules (counterpart of
``apex_tpu/normalization/``).

``FusedLayerNorm`` / ``FusedRMSNorm`` hold fp32 parameters named
``weight`` and ``bias`` (the reference's ``scale`` is ``weight`` here; see
``models/convert.py``) and run the fused norm of
``apex_tpu_torch.ops.layer_norm``, forward and (under autograd) backward:
fp32 compute, output in the input's dtype, so bf16 activations with
fp32 parameters need no separate "mixed" module.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
from torch import nn

from apex_tpu_torch._backend import DeviceLike, resolve_device
from apex_tpu_torch.ops.layer_norm import fused_layer_norm, fused_rms_norm


def _shape_tuple(normalized_shape):
    if isinstance(normalized_shape, int):
        return (normalized_shape,)
    return tuple(normalized_shape)


class FusedLayerNorm(nn.Module):
    """LayerNorm over the trailing ``normalized_shape`` dims."""

    def __init__(self, normalized_shape: Union[int, Sequence[int]],
                 eps: float = 1e-5, elementwise_affine: bool = True,
                 use_bias: bool = True, *, device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        shape = _shape_tuple(normalized_shape)
        dev = resolve_device(device)
        self.normalized_shape = shape
        self.eps = eps
        self.weight = (nn.Parameter(torch.ones(shape, dtype=dtype,
                                               device=dev))
                       if elementwise_affine else None)
        self.bias = (nn.Parameter(torch.zeros(shape, dtype=dtype,
                                              device=dev))
                     if elementwise_affine and use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_layer_norm(x, self.weight, self.bias, eps=self.eps)


class FusedRMSNorm(nn.Module):
    """RMSNorm over the trailing ``normalized_shape`` dims."""

    def __init__(self, normalized_shape: Union[int, Sequence[int]],
                 eps: float = 1e-5, elementwise_affine: bool = True, *,
                 device: DeviceLike = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        shape = _shape_tuple(normalized_shape)
        self.normalized_shape = shape
        self.eps = eps
        self.weight = (nn.Parameter(torch.ones(
            shape, dtype=dtype, device=resolve_device(device)))
            if elementwise_affine else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_rms_norm(x, self.weight, eps=self.eps)


__all__ = ["FusedLayerNorm", "FusedRMSNorm", "fused_layer_norm",
           "fused_rms_norm"]
