"""NHWC convolution with XLA's padding rule.

Counterpart of ``apex_tpu/contrib/bottleneck/__init__.py``
``conv2d_nhwc`` (:141; ``_conv2d_nhwc_impl`` :111-116, its VJP
:119-137): an NHWC input, HWIO weights, the output in the input's dtype
with fp32 accumulation. The reference hands the convolution to XLA, not
to a Pallas kernel, so here it goes to cuDNN through ``F.conv2d`` (the
port's plain matrix products likewise go to ``torch.matmul``).

XLA's ``"SAME"`` is not PyTorch's symmetric ``padding=k // 2``: it pads
``total = max((ceil(n / s) - 1) * s + k - n, 0)`` along each spatial
dim, ``total // 2`` before and the rest after (:161-163). For an even
input a 3x3 stride-2 convolution pads (0, 1) and the 7x7 stride-2 stem
at 224 pads (2, 3); a symmetric pad would shift every window by one
pixel. Where the two sides differ the input is padded explicitly.

The NHWC tensors cross into PyTorch as NCHW views of the same memory
(channels-last strides, no copy), the layout cuDNN's NHWC kernels take;
:func:`conv2d` is the same convolution on such views with OIHW weights,
as the port's ResNet holds them.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

Padding = Union[str, Sequence[Tuple[int, int]]]


def same_padding(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` pads (before, after) of one spatial dim of size
    ``n`` for a window ``k`` at ``stride``."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, kernel: Tuple[int, int], stride: int,
          padding: Padding) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    if padding == "SAME":
        return tuple(same_padding(n, k, stride)
                     for n, k in zip(x.shape[2:], kernel))
    if padding == "VALID":
        return (0, 0), (0, 0)
    (t, b), (l, r) = padding
    return (int(t), int(b)), (int(l), int(r))


def conv2d(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
           padding: Padding = "SAME") -> torch.Tensor:
    """The convolution of :func:`conv2d_nhwc` on an NCHW ``x`` (any
    memory format; channels-last is cuDNN's NHWC path) and OIHW ``w``
    of ``x``'s dtype; returns NCHW in ``x``'s dtype. Symmetric pads go
    to the convolution itself, uneven ones are padded first."""
    if x.dtype != w.dtype:
        raise TypeError(f"input {x.dtype} and weights {w.dtype} differ; "
                        "cast the weights to the compute dtype")
    (t, b), (l, r) = _pads(x, tuple(w.shape[2:]), stride, padding)
    if t != b or l != r:
        x = F.pad(x, (l, r, t, b))
        t = l = 0
    return F.conv2d(x, w, stride=stride, padding=(t, l))


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, stride: int = 1,
                padding: Padding = "SAME") -> torch.Tensor:
    """NHWC convolution with HWIO weights (the reference's signature):
    ``padding`` is ``"SAME"`` (XLA's rule), ``"VALID"`` or explicit
    ``((top, bottom), (left, right))``. Returns NHWC in ``x``'s dtype
    (a view of the convolution's channels-last output)."""
    y = conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride,
               padding)
    return y.permute(0, 2, 3, 1)


__all__ = ["conv2d", "conv2d_nhwc", "same_padding"]
