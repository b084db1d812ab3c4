"""DCGAN under amp: two models, two FusedAdams, two loss scalers.

Port of ``examples/dcgan/main_amp.py``. The generator and discriminator
keep independent loss-scaler states, each backward pass runs on its own
loss's scale (the reference's ``amp.scale_loss(errD, optimizerD,
loss_id=...)`` pattern), and each FusedAdam unscales inside its update
and skips it on overflow. The discriminator steps first, on real images
and the generator's fakes, then the generator against the updated
discriminator.

The modules take and give NHWC images, as the reference's Flax modules
do, and compute in fp32 (the reference's layers do not read amp's
policy; O1 here is its loss scaling). The architecture fixes the images
at 16 x 16 (a 4 x 4 seed and two stride-2 layers); ``--feat`` sets the
widths (the reference's module default, 16)::

    python -m apex_tpu_torch.examples.dcgan_amp --steps 20 --feat 64 \\
        --batch-size 64 --nz 100
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from apex_tpu_torch import amp
from apex_tpu_torch import random as jrandom
from apex_tpu_torch._backend import DeviceLike, resolve_device
from apex_tpu_torch.contrib.bottleneck import same_padding
from apex_tpu_torch.optimizers import FusedAdam


class GroupNorm(nn.Module):
    """Flax's ``GroupNorm`` on NHWC: statistics in fp32 over (H, W, the
    group's channels), the variance as E[x^2] - E[x]^2 clamped at 0
    (``use_fast_variance``), eps 1e-6."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6,
                 device=None):
        super().__init__()
        self.num_groups, self.eps = num_groups, eps
        self.scale = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x):
        b, h, w, c = x.shape
        size = c // self.num_groups
        g = x.reshape(b, h, w, self.num_groups, size)
        mu = g.mean(dim=(1, 2, 4))
        mu2 = (g * g).mean(dim=(1, 2, 4))
        var = torch.clamp_min(mu2 - mu * mu, 0.0)
        mean = mu.repeat_interleave(size, dim=-1)[:, None, None, :]
        var = var.repeat_interleave(size, dim=-1)[:, None, None, :]
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean) * mul + self.bias


class _Deconv(nn.Module):
    """A 4 x 4 stride-2 transposed convolution with Flax's SAME output
    (twice the input) on NHWC; weight (in, out, 4, 4)."""

    def __init__(self, cin: int, cout: int, device=None, generator=None):
        super().__init__()
        self.weight = nn.Parameter(0.05 * torch.randn(
            cin, cout, 4, 4, generator=generator).to(device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))

    def forward(self, x):
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), self.weight,
                               stride=2, padding=1)
        return y.permute(0, 2, 3, 1) + self.bias


def _dense(cin: int, cout: int, device=None, generator=None) -> nn.Linear:
    layer = nn.Linear(cin, cout, device=device)
    with torch.no_grad():
        layer.weight.copy_(0.05 * torch.randn(cout, cin, generator=generator))
        layer.bias.zero_()
    return layer


class _Conv(nn.Module):
    """A 4 x 4 stride-2 convolution with XLA's SAME padding on NHWC;
    weight OIHW."""

    def __init__(self, cin: int, cout: int, device=None, generator=None):
        super().__init__()
        self.weight = nn.Parameter(0.05 * torch.randn(
            cout, cin, 4, 4, generator=generator).to(device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))

    def forward(self, x):
        (t, b_), (l, r) = (same_padding(n, 4, 2) for n in x.shape[1:3])
        x = F.pad(x.permute(0, 3, 1, 2), (l, r, t, b_))
        return F.conv2d(x, self.weight, stride=2).permute(0, 2, 3, 1) \
            + self.bias


class Generator(nn.Module):
    """z (b, nz) -> images (b, 16, 16, channels) in [-1, 1]."""

    def __init__(self, nz: int, feat: int = 16, channels: int = 3,
                 device=None, generator=None):
        super().__init__()
        self.feat = feat
        self.dense = _dense(nz, 4 * 4 * feat * 2, device, generator)
        self.group_norm0 = GroupNorm(4, feat * 2, device=device)
        self.deconv0 = _Deconv(feat * 2, feat, device, generator)
        self.group_norm1 = GroupNorm(4, feat, device=device)
        self.deconv1 = _Deconv(feat, channels, device, generator)

    def forward(self, z):
        x = self.dense(z).reshape(z.shape[0], 4, 4, self.feat * 2)
        x = self.deconv0(F.relu(self.group_norm0(x)))
        x = self.deconv1(F.relu(self.group_norm1(x)))
        return torch.tanh(x)


def _half(n: int) -> int:
    """A SAME stride-2 layer's output size."""
    return -(-n // 2)


class Discriminator(nn.Module):
    """images (b, s, s, channels) -> logits (b,)."""

    def __init__(self, feat: int = 16, channels: int = 3,
                 image_size: int = 16, device=None, generator=None):
        super().__init__()
        self.conv0 = _Conv(channels, feat, device, generator)
        self.conv1 = _Conv(feat, feat * 2, device, generator)
        side = _half(_half(image_size))
        self.dense = _dense(side * side * feat * 2, 1, device, generator)

    def forward(self, x):
        x = F.leaky_relu(self.conv0(x), 0.2)
        x = F.leaky_relu(self.conv1(x), 0.2)
        return self.dense(x.reshape(x.shape[0], -1))[:, 0]


def bce_logits(logits, target):
    """The stable BCE with logits (the reference's, in place of BCELoss
    on a sigmoid)."""
    return torch.mean(torch.clamp_min(logits, 0) - logits * target
                      + torch.log1p(torch.exp(-logits.abs())))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--nz", type=int, default=32)
    ap.add_argument("--image-size", type=int, default=16)
    ap.add_argument("--feat", type=int, default=16)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--opt-level", default="O1")
    return ap.parse_args(argv)


def real_images(args, device) -> torch.Tensor:
    """The reference's batch of 'real' images, from numpy's seed 0."""
    rng = np.random.RandomState(0)
    real = rng.rand(args.batch_size, args.image_size, args.image_size, 3) \
        * 2 - 1
    return torch.from_numpy(real.astype(np.float32)).to(device)


def build(args, device, seed: int = 0):
    """The two modules with weights from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return (Generator(args.nz, args.feat, device=device, generator=gen),
            Discriminator(args.feat, image_size=args.image_size,
                          device=device, generator=gen))


def d_loss(netD, netG, pD, pG, real, z):
    """The discriminator's loss at parameters ``pD`` (name -> tensor),
    on ``real`` and the generator's fakes at ``pG`` (no gradient into
    the generator)."""
    with torch.no_grad():
        fake = functional_call(netG, pG, (z,))
    return (bce_logits(functional_call(netD, pD, (real,)), 1.0)
            + bce_logits(functional_call(netD, pD, (fake,)), 0.0))


def g_loss(netD, netG, pG, pD, z):
    """The generator's loss at ``pG`` against the discriminator at
    ``pD``."""
    return bce_logits(functional_call(netD, pD, (functional_call(
        netG, pG, (z,)),)), 1.0)


def train(netG: Generator, netD: Discriminator, args, device,
          grad_hook=None) -> dict:
    """The reference's loop: per step a key split, ``z`` drawn as JAX
    draws it, a D step then a G step, each on its own loss's scale,
    unscaled in its FusedAdam and skipped on overflow by its own scaler.
    ``grad_hook(net, step, flat_grad)`` ("D" or "G"), when given, sees
    each flat gradient of the scaled loss before its update and returns
    the gradient to use. Returns the unscaled losses, each scaler's scale
    after every step and the final states."""
    real = real_images(args, device)
    optG = FusedAdam(lr=args.lr, betas=(0.5, 0.999))
    optD = FusedAdam(lr=args.lr, betas=(0.5, 0.999))
    with amp.policy_scope(amp._amp_state.get_active()):
        _, sD, ampD = amp.initialize(dict(netD.named_parameters()), optD,
                                     opt_level=args.opt_level)
        _, sG, ampG = amp.initialize(dict(netG.named_parameters()), optG,
                                     opt_level=args.opt_level)
    scaler = amp.make_scaler(ampD.properties)
    ssD, ssG = ampD.scalers[0], ampG.scalers[0]
    gradD = sD.space.grad_fn(lambda p, ss, *a: scaler.scale_loss(
        d_loss(netD, netG, p, *a), ss), with_value=True)
    gradG = sG.space.grad_fn(lambda p, ss, *a: scaler.scale_loss(
        g_loss(netD, netG, p, *a), ss), with_value=True)
    hook = grad_hook or (lambda net, i, g: g)
    out = {"lossD": [], "lossG": [], "scaleD": [], "scaleG": []}
    key = jrandom.PRNGKey(2)
    for i in range(args.steps):
        key, kz = jrandom.split(key)
        z = jrandom.normal(kz, (args.batch_size, args.nz), device=device)
        sloss, g = gradD(sD.master, ssD, optG.master_params(sG), real, z)
        out["lossD"].append(float(sloss) / ssD.loss_scale)
        _, sD = optD.step_flat(sD, hook("D", i, g),
                               grad_scale=ssD.loss_scale,
                               skip_if_nonfinite=True)
        ssD = scaler.update(ssD, sD.found_inf)
        sloss, g = gradG(sG.master, ssG, optD.master_params(sD), z)
        out["lossG"].append(float(sloss) / ssG.loss_scale)
        _, sG = optG.step_flat(sG, hook("G", i, g),
                               grad_scale=ssG.loss_scale,
                               skip_if_nonfinite=True)
        ssG = scaler.update(ssG, sG.found_inf)
        out["scaleD"].append(ssD.loss_scale)
        out["scaleG"].append(ssG.loss_scale)
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  lossD {out['lossD'][-1]:.4f}  lossG "
                  f"{out['lossG'][-1]:.4f}")
    out.update(stateD=sD, stateG=sG, scalerD=ssD, scalerG=ssG)
    return out


def main(argv=None, device: DeviceLike = None) -> dict:
    args = parse(argv)
    dev = resolve_device(device)
    netG, netD = build(args, dev)
    return train(netG, netD, args, dev)


if __name__ == "__main__":
    main()
