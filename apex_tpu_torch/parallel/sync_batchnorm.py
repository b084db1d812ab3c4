"""Batch normalization with the reference's one-pass statistics.

Counterpart of ``apex_tpu/parallel/sync_batchnorm.py`` (``SyncBatchNorm``
:42, ``create_syncbn_group_assignment`` :30) on one device. The
statistics are the reference's single-pass form in fp32: ``mean = sum(x)
/ n`` and ``var = sum(x^2) / n - mean^2`` per channel over every other
dim (:128-141), not ``F.batch_norm``'s, whose variance is computed
another way. Training updates the running statistics in the forward as
``(1 - m) * running + m * stat``, with the unbiased variance ``var * n /
(n - 1)`` (:85-93); the output is ``(x - mean) * rsqrt(var + eps)``, the
affine scale and shift, the optional fused ReLU, in fp32, cast back to
the input's dtype (:95-103). The backward is autograd's through the
same expressions, as the reference's is AD's.

Synchronising the statistics across devices (``axis_name``,
``axis_index_groups``) comes with the distributed slice and raises.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from apex_tpu_torch._backend import DeviceLike


def create_syncbn_group_assignment(world_size: int,
                                   group_size: int) -> List[List[int]]:
    """Partition ``world_size`` data-parallel ranks into BN groups of
    ``group_size`` consecutive ranks (the reference's :30)."""
    if world_size % group_size:
        raise ValueError("world_size must be divisible by group_size")
    return [list(range(i, i + group_size))
            for i in range(0, world_size, group_size)]


def _fp32_div(x: torch.Tensor, n: float) -> torch.Tensor:
    """``x / n`` as a true fp32 division: PyTorch multiplies a CUDA
    tensor by the reciprocal of a Python divisor, so ``n`` goes in as a
    0-d tensor on ``x``'s device (a fill, no host copy)."""
    return x / torch.full((), n, dtype=torch.float32, device=x.device)


class SyncBatchNorm(nn.Module):
    """BatchNorm over a channels-last input ``(..., C)`` (the
    reference's layout): statistics per channel over every other dim.

    ``weight`` and ``bias`` are the reference's ``scale`` and ``bias``;
    the buffers ``running_mean`` and ``running_var`` its ``batch_stats``
    ``mean`` and ``var``. ``forward(x, use_running_stats=False)``
    normalises with the batch's statistics and updates the running ones
    (training), or with the running ones (inference)."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 track_running_stats: bool = True,
                 axis_name: Optional[str] = None,
                 axis_index_groups: Optional[Sequence[Sequence[int]]] = None,
                 fuse_relu: bool = False,
                 param_dtype: torch.dtype = torch.float32, *,
                 device: DeviceLike = None):
        super().__init__()
        if axis_name is not None or axis_index_groups is not None:
            raise NotImplementedError(
                "cross-device SyncBatchNorm (axis_name / axis_index_groups) "
                "comes with the distributed slice; pass axis_name=None")
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        self.track_running_stats = track_running_stats
        self.fuse_relu = fuse_relu
        if affine:
            self.weight = nn.Parameter(torch.ones(num_features,
                                                  dtype=param_dtype,
                                                  device=device))
            self.bias = nn.Parameter(torch.zeros(num_features,
                                                 dtype=param_dtype,
                                                 device=device))
        self.register_buffer("running_mean", torch.zeros(
            num_features, dtype=torch.float32, device=device))
        self.register_buffer("running_var", torch.ones(
            num_features, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor,
                use_running_stats: bool = False) -> torch.Tensor:
        c = self.num_features
        if x.shape[-1] != c:
            raise ValueError(f"SyncBatchNorm expects channels-last (..., "
                             f"{c}), got {tuple(x.shape)}")
        if use_running_stats:
            mean, var = self.running_mean, self.running_var
        else:
            mean, var = self._batch_stats(x)
            if self.track_running_stats:
                self._update_running(x, mean, var)
        y = (x.float() - mean) * torch.rsqrt(var + self.eps)
        if self.affine:
            y = y * self.weight + self.bias
        if self.fuse_relu:
            y = torch.relu(y)
        return y.to(x.dtype)

    @staticmethod
    def _count(x: torch.Tensor) -> float:
        return float(np.prod(x.shape[:-1], dtype=np.float64))

    def _batch_stats(self, x: torch.Tensor):
        xf = x.float()
        dims = tuple(range(x.ndim - 1))
        n = self._count(x)
        mean = _fp32_div(xf.sum(dims), n)
        var = _fp32_div((xf * xf).sum(dims), n) - mean * mean
        return mean, var

    @torch.no_grad()
    def _update_running(self, x, mean, var) -> None:
        # n / max(n - 1, 1) in fp32, as the reference's fp32 count
        n = np.float32(self._count(x))
        bessel = n / np.maximum(n - np.float32(1.0), np.float32(1.0))
        m = self.momentum
        self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
        self.running_var.copy_((1 - m) * self.running_var
                               + m * (var * float(bessel)))


__all__ = ["SyncBatchNorm", "create_syncbn_group_assignment"]
