"""ResNet with bottleneck blocks, the ImageNet example's model.

Counterpart of ``apex_tpu/models/resnet.py`` (``ResNetConfig`` :26,
``_BNBlock`` :45, ``ResNetBottleneckBlock`` :61, ``ResNet`` :93,
``cross_entropy_logits`` :127) as ``nn.Module``s. The input is NHWC, as
the reference's; inside, activations are NCHW views of channels-last
memory (the layout cuDNN's NHWC convolutions take, no copies), and each
BatchNorm sees them as ``(N, H, W, C)`` again. The math is the
reference's:

- conv weights are fp32 parameters cast to ``cfg.dtype`` at use
  (:79-89, :106), stored OIHW (the reference's are HWIO;
  ``models/convert.py`` transposes); convolutions and the 3x3 stride-2
  max-pool pad as XLA's ``"SAME"`` does (``contrib/bottleneck``; the
  pool pads with -inf);
- BatchNorm is ``parallel.SyncBatchNorm`` (fp32 statistics, the
  running statistics updated in the forward when training), over the
  ranks of ``bn_axis_name`` (``"data"``: synchronised across the data
  axis's process group) in the BN groups ``bn_groups``, or on each
  device alone when ``bn_axis_name`` is None; ReLU fused where the
  reference fuses it;
- the residual is ``max(y + x, 0)`` in the compute dtype;
- the global mean over H and W is summed in fp32 and rounded to the
  compute dtype (:118), the head is fp32 (:123-124).

Init as the reference's: ``he_normal`` (a normal truncated at two
standard deviations, std ``sqrt(2 / fan_in) / 0.8796`` with fan-in
``kh * kw * cin``) for the convolutions, N(0, 0.01) for the head, zero
bias and BN shift, unit BN scale. Parameters are drawn on the CPU from
an explicit ``torch.Generator`` and moved to ``device`` (CUDA unless the
caller names another).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch._backend import DeviceLike, resolve_device
from apex_tpu_torch.contrib.bottleneck import conv2d, same_padding
from apex_tpu_torch.parallel.sync_batchnorm import SyncBatchNorm

# the reference's he_normal: variance scaling (2, fan_in) over a normal
# truncated to [-2, 2], whose std this divides out
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    block_sizes: Tuple[int, ...] = (3, 4, 6, 3)     # ResNet-50
    width: int = 64
    num_classes: int = 1000
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32
    bn_axis_name: Optional[str] = None
    bn_groups: Optional[Sequence[Sequence[int]]] = None

    @staticmethod
    def resnet50(**kw) -> "ResNetConfig":
        return ResNetConfig(block_sizes=(3, 4, 6, 3), **kw)

    @staticmethod
    def resnet18ish(**kw) -> "ResNetConfig":
        """Small config for tests and CPU smoke runs."""
        return ResNetConfig(block_sizes=(1, 1), width=16, **kw)


def _conv_weight(cout: int, cin: int, k: int, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(cout, cin, k, k, dtype=dtype))


def _he_normal_(w: torch.Tensor, generator: Optional[torch.Generator]):
    std = math.sqrt(2.0 / (w.shape[1] * w.shape[2] * w.shape[3])) \
        / _TRUNC_STD
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


def _conv(x: torch.Tensor, w: torch.Tensor, dtype, stride: int = 1):
    """``w`` cast to the compute dtype in channels-last order, then the
    SAME convolution of the NCHW view ``x``."""
    return conv2d(x, w.to(dtype, memory_format=torch.channels_last), stride)


def max_pool_same(x: torch.Tensor, window: int, stride: int) -> torch.Tensor:
    """Max-pool of an NCHW ``x`` with XLA's ``"SAME"`` padding, the
    padding -inf (the reference's ``max_pool(..., padding="SAME")``)."""
    (t, b), (l, r) = (same_padding(n, window, stride) for n in x.shape[2:])
    if t or b or l or r:
        x = F.pad(x, (l, r, t, b), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


class _BNBlock(nn.Module):
    """SyncBatchNorm over an NCHW view, as the reference's ``_BNBlock``
    over NHWC."""

    def __init__(self, cfg: ResNetConfig, features: int, relu: bool = True):
        super().__init__()
        self.bn = SyncBatchNorm(features, axis_name=cfg.bn_axis_name,
                                axis_index_groups=cfg.bn_groups,
                                fuse_relu=relu, param_dtype=cfg.param_dtype)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        y = self.bn(x.permute(0, 2, 3, 1), use_running_stats=not train)
        return y.permute(0, 3, 1, 2)


class ResNetBottleneckBlock(nn.Module):
    """conv1x1-BN-relu -> conv3x3-BN-relu -> conv1x1-BN, plus the
    (projected) input, then relu."""

    def __init__(self, cfg: ResNetConfig, in_features: int, filters: int,
                 stride: int = 1):
        super().__init__()
        self.cfg = cfg
        self.stride = stride
        f, out_f, pdt = filters, 4 * filters, cfg.param_dtype
        self.conv1 = _conv_weight(f, in_features, 1, pdt)
        self.conv2 = _conv_weight(f, f, 3, pdt)
        self.conv3 = _conv_weight(out_f, f, 1, pdt)
        self.bn1 = _BNBlock(cfg, f)
        self.bn2 = _BNBlock(cfg, f)
        self.bn3 = _BNBlock(cfg, out_f, relu=False)
        if in_features != out_f or stride != 1:
            self.conv_down = _conv_weight(out_f, in_features, 1, pdt)
            self.bn_down = _BNBlock(cfg, out_f, relu=False)
        else:
            self.conv_down = None

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        dt = self.cfg.dtype
        y = self.bn1(_conv(x, self.conv1, dt), train)
        y = self.bn2(_conv(y, self.conv2, dt, self.stride), train)
        y = self.bn3(_conv(y, self.conv3, dt), train)
        if self.conv_down is not None:
            x = self.bn_down(_conv(x, self.conv_down, dt, self.stride), train)
        return torch.relu(y + x)


class ResNet(nn.Module):
    """NHWC ResNet with bottleneck blocks (50/101/152 by
    ``block_sizes``): ``model(x, train=True)`` maps ``(N, H, W, 3)``
    images to fp32 ``(N, num_classes)`` logits."""

    def __init__(self, config: ResNetConfig, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None,
                 in_channels: int = 3):
        super().__init__()
        cfg = self.config = config
        dev = resolve_device(device)
        pdt = cfg.param_dtype
        self.conv_stem = _conv_weight(cfg.width, in_channels, 7, pdt)
        self.bn_stem = _BNBlock(cfg, cfg.width)
        features = cfg.width
        for i, n_blocks in enumerate(cfg.block_sizes):
            filters = cfg.width * (2 ** i)
            for j in range(n_blocks):
                stride = 2 if (j == 0 and i > 0) else 1
                self.add_module(f"stage{i}_block{j}", ResNetBottleneckBlock(
                    cfg, features, filters, stride))
                features = 4 * filters
        self.head = nn.Parameter(torch.empty(features, cfg.num_classes,
                                             dtype=pdt))
        self.head_bias = nn.Parameter(torch.zeros(cfg.num_classes,
                                                  dtype=pdt))
        with torch.no_grad():
            for name, p in self.named_parameters():
                if p.ndim == 4:
                    _he_normal_(p, generator)
            self.head.normal_(0.0, 0.01, generator=generator)
        self.to(dev)

    def blocks(self):
        return [m for m in self.children()
                if isinstance(m, ResNetBottleneckBlock)]

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        dt = self.config.dtype
        x = x.to(dt).permute(0, 3, 1, 2)           # NCHW view, NHWC memory
        x = self.bn_stem(_conv(x, self.conv_stem, dt, 2), train)
        x = max_pool_same(x, 3, 2)
        for block in self.blocks():
            x = block(x, train)
        x = torch.mean(x, dim=(2, 3), dtype=torch.float32).to(dt)
        return x.float() @ self.head.float() + self.head_bias.float()


def cross_entropy_logits(logits: torch.Tensor,
                         labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy of integer ``labels``."""
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, labels.long()[:, None])[:, 0]
    return torch.mean(lse - tgt)


__all__ = ["ResNet", "ResNetBottleneckBlock", "ResNetConfig",
           "cross_entropy_logits", "max_pool_same"]
