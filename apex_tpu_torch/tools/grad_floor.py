"""How far an fp32 ResNet-50 gradient is from its float64 value.

The gradient of the loss on one batch, at the weights ``ResNet`` draws
from ``--seed``, computed twice on the same device: in fp32 (the model
as it trains, BatchNorm statistics in fp32 by ``SyncBatchNorm``'s
one-pass form, or with ``--two-pass`` a two-pass variance), and in
float64 throughout (convolutions, BatchNorm statistics and the head).
Prints the whole flat gradient's relative L2 distance and the leaves'
best, median and worst. ``chip_smoke.py`` phase 20c holds data
parallelism's gradient to this floor rather than to 1e-4::

    python -m apex_tpu_torch.tools.grad_floor [--batch 4] [--device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from apex_tpu_torch.models.resnet import (ResNet, ResNetConfig,
                                          cross_entropy_logits)
from apex_tpu_torch.parallel import sync_batchnorm


def _bn_forward(dtype, two_pass):
    """A ``SyncBatchNorm._forward`` whose statistics and normalisation
    run in ``dtype`` (unsynchronised, training mode)."""

    def forward(self, x, use_running_stats):
        xf = x.to(dtype)
        dims = tuple(range(x.ndim - 1))
        n = float(np.prod(x.shape[:-1]))
        mean = xf.sum(dims) / n
        var = (((xf - mean) ** 2).sum(dims) / n if two_pass
               else (xf * xf).sum(dims) / n - mean * mean)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y * self.weight.to(dtype) + self.bias.to(dtype)
        return (torch.relu(y) if self.fuse_relu else y).to(x.dtype)

    return forward


def gradient(weights, x, y, dtype, device, two_pass=False):
    """Leaf name -> the gradient (float64 numpy) of the mean loss."""
    model = ResNet(ResNetConfig.resnet50(dtype=dtype, param_dtype=dtype),
                   device=device)
    model.load_state_dict({k: v.to(dtype) for k, v in weights.items()})
    saved = sync_batchnorm.SyncBatchNorm._forward
    if dtype == torch.float64 or two_pass:
        sync_batchnorm.SyncBatchNorm._forward = _bn_forward(dtype, two_pass)
    try:
        logits = model(torch.as_tensor(x, dtype=dtype, device=device))
        cross_entropy_logits(logits.to(dtype),
                             torch.as_tensor(y, device=device)).backward()
    finally:
        sync_batchnorm.SyncBatchNorm._forward = saved
    return {k: p.grad.double().cpu().numpy() for k, p in
            model.named_parameters()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--two-pass", action="store_true")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    weights = ResNet(ResNetConfig.resnet50(dtype=torch.float32),
                     device="cpu", generator=torch.Generator().manual_seed(
                         args.seed)).state_dict()
    rng = np.random.RandomState(args.seed + 21)
    x = rng.randn(args.batch, 224, 224, 3).astype(np.float32)
    y = rng.randint(0, 1000, args.batch)
    g32 = gradient(weights, x, y, torch.float32, args.device, args.two_pass)
    g64 = gradient(weights, x, y, torch.float64, args.device)
    whole = np.sqrt(sum(np.sum((g32[k] - g64[k]) ** 2) for k in g64)
                    / sum(np.sum(g64[k] ** 2) for k in g64))
    leaves = sorted((float(np.linalg.norm(g32[k] - g64[k])
                           / np.linalg.norm(g64[k])), k) for k in g64)
    out = {"batch": args.batch, "device": args.device,
           "two_pass": args.two_pass, "whole_rel_l2": float(whole),
           "best": leaves[:3], "median": leaves[len(leaves) // 2],
           "worst": leaves[-3:]}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
