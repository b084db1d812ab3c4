"""Batch normalization with the reference's one-pass statistics,
synchronised over the data axis's process group.

Counterpart of ``apex_tpu/parallel/sync_batchnorm.py`` (``SyncBatchNorm``
:42, ``create_syncbn_group_assignment`` :30, ``convert_syncbn_model``
:144). The statistics are the reference's single-pass form in fp32:
``mean = sum(x) / n`` and ``var = sum(x^2) / n - mean^2`` per channel
over every other dim (:128-141), not ``F.batch_norm``'s, whose variance
is computed another way. Training updates the running statistics in the forward as
``(1 - m) * running + m * stat``, with the unbiased variance ``var * n /
(n - 1)`` (:85-93); the output is ``(x - mean) * rsqrt(var + eps)``, the
affine scale and shift, the optional fused ReLU, in fp32, cast back to
the input's dtype (:95-103). The backward is autograd's through the
same expressions, as the reference's is AD's.

Across ranks (:105-141): ``axis_name`` names a ``parallel_state`` axis
(``"data"`` by default, the reference's) and ``axis_index_groups`` the
BN groups along it. Each rank's fp32 ``(sum, sumsq)`` is summed over
its group in one all-reduce of a ``(2, C)`` tensor and the count scales
by the group's size (equal shards, as the reference assumes). The
all-reduce is an autograd function whose backward is another sum over
the same group, the transpose of the reference's ``psum``
(``dist.all_reduce`` has no gradient). Outside an initialized topology,
or in a group of one rank, the module acts unsynchronised, as the
reference's does outside ``shard_map``.

``channel_last=False`` takes a channels-first input ``(N, C, ...)``,
``torch.nn.BatchNorm{1,2,3}d``'s layout, which ``convert_syncbn_model``
needs.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from apex_tpu_torch._backend import DeviceLike
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.parallel_state import DATA_AXIS


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


class _GroupSum(torch.autograd.Function):
    """Sum over a process group; the backward sums the cotangents over
    the same group (the transpose of a sum over replicas)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class SyncBatchNorm(nn.Module):
    """BatchNorm over a channels-last input ``(..., C)`` (the
    reference's layout): statistics per channel over every other dim,
    summed over the BN group.

    ``weight`` and ``bias`` are the reference's ``scale`` and ``bias``;
    the buffers ``running_mean`` and ``running_var`` its ``batch_stats``
    ``mean`` and ``var``. ``forward(x, use_running_stats=False)``
    normalises with the batch's statistics and updates the running ones
    (training), or with the running ones (inference)."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True,
                 track_running_stats: bool = True,
                 axis_name: Optional[str] = DATA_AXIS,
                 axis_index_groups: Optional[Sequence[Sequence[int]]] = None,
                 fuse_relu: bool = False,
                 param_dtype: torch.dtype = torch.float32, *,
                 channel_last: bool = True,
                 device: DeviceLike = None):
        super().__init__()
        if axis_name is not None and axis_name not in ps.AXES:
            raise ValueError(f"axis_name {axis_name!r} is not a "
                             f"parallel_state axis {ps.AXES}")
        if axis_name is None and axis_index_groups is not None:
            raise ValueError("axis_index_groups needs an axis_name")
        self.axis_name = axis_name
        self.axis_index_groups = axis_index_groups
        self.channel_last = channel_last
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

    def _group(self):
        """``(group, size)`` of the BN group, or None to act
        unsynchronised (no topology, or a group of one rank)."""
        if self.axis_name is None or not ps.model_parallel_is_initialized():
            return None
        group, ranks = ps.axis_group(self.axis_name, self.axis_index_groups)
        return None if group is None else (group, len(ranks))

    def forward(self, x: torch.Tensor,
                use_running_stats: bool = False) -> torch.Tensor:
        if not self.channel_last:
            y = self._forward(x.movedim(1, -1), use_running_stats)
            return y.movedim(-1, 1)
        return self._forward(x, use_running_stats)

    def _forward(self, x: torch.Tensor,
                 use_running_stats: bool) -> torch.Tensor:
        c = self.num_features
        if x.shape[-1] != c:
            raise ValueError(f"SyncBatchNorm expects channels-last (..., "
                             f"{c}), got {tuple(x.shape)}")
        if use_running_stats:
            mean, var = self.running_mean, self.running_var
        else:
            sync = self._group()
            mean, var = self._batch_stats(x, sync)
            if self.track_running_stats:
                self._update_running(self._count(x, sync), mean, var)
        y = (x.float() - mean) * torch.rsqrt(var + self.eps)
        if self.affine:
            y = y * self.weight + self.bias
        if self.fuse_relu:
            y = torch.relu(y)
        return y.to(x.dtype)

    @staticmethod
    def _count(x: torch.Tensor, sync=None) -> float:
        """The elements a channel's statistics cover: the local count
        times the group's size (every rank holds an equal shard)."""
        local = float(np.prod(x.shape[:-1], dtype=np.float64))
        return local if sync is None else local * sync[1]

    def _batch_stats(self, x: torch.Tensor, sync=None):
        xf = x.float()
        dims = tuple(range(x.ndim - 1))
        n = self._count(x, sync)
        if sync is None:
            s, ss = xf.sum(dims), (xf * xf).sum(dims)
        else:
            s, ss = _GroupSum.apply(torch.stack([xf.sum(dims),
                                                 (xf * xf).sum(dims)]),
                                    sync[0])
        mean = _fp32_div(s, n)
        var = _fp32_div(ss, n) - mean * mean
        return mean, var

    @torch.no_grad()
    def _update_running(self, count: float, mean, var) -> None:
        # n / max(n - 1, 1) in fp32, as the reference's fp32 count
        n = np.float32(count)
        bessel = n / np.maximum(n - np.float32(1.0), np.float32(1.0))
        m = self.momentum
        self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
        self.running_var.copy_((1 - m) * self.running_var
                               + m * (var * float(bessel)))


_TORCH_BN = (nn.BatchNorm1d, nn.BatchNorm2d, nn.BatchNorm3d)


def _synced_from(bn: nn.Module, axis_name, axis_index_groups) -> SyncBatchNorm:
    if bn.momentum is None:
        raise ValueError("a BatchNorm with momentum=None (a cumulative "
                         "average) has no SyncBatchNorm counterpart")
    like = next(iter(list(bn.parameters()) + list(bn.buffers())), None)
    # torch's momentum already weighs the new statistic, as the port's does
    new = SyncBatchNorm(
        bn.num_features, bn.eps, bn.momentum, bn.affine,
        bn.track_running_stats, axis_name, axis_index_groups,
        getattr(bn, "fuse_relu", False),
        bn.weight.dtype if bn.affine else torch.float32,
        channel_last=getattr(bn, "channel_last", False),
        device=None if like is None else like.device)
    with torch.no_grad():
        if bn.affine:
            new.weight.copy_(bn.weight)
            new.bias.copy_(bn.bias)
        if bn.running_mean is not None:
            new.running_mean.copy_(bn.running_mean)
            new.running_var.copy_(bn.running_var)
    return new.train(bn.training)


def convert_syncbn_model(module: nn.Module, axis_name: str = DATA_AXIS,
                         axis_index_groups=None) -> nn.Module:
    """Swap every ``torch.nn.BatchNorm{1,2,3}d`` in ``module`` (and the
    port's own ``SyncBatchNorm``) for a ``SyncBatchNorm`` over
    ``axis_name`` / ``axis_index_groups``, eps, momentum, affine
    parameters and running statistics carried over (the reference's
    :144; it converts Flax's momentum to ``1 - m``, torch's already
    weighs the new statistic). Returns the converted module: ``module``
    itself, changed in place, unless it is a BatchNorm."""
    if isinstance(module, _TORCH_BN + (SyncBatchNorm,)):
        return _synced_from(module, axis_name, axis_index_groups)
    for name, child in module.named_children():
        new = convert_syncbn_model(child, axis_name, axis_index_groups)
        if new is not child:
            setattr(module, name, new)
    return module


__all__ = ["SyncBatchNorm", "convert_syncbn_model",
           "create_syncbn_group_assignment"]
