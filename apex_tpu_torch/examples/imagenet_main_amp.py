"""ImageNet ResNet trainer under amp, data parallel with SyncBatchNorm.

Port of ``examples/imagenet/main_amp.py`` (``BASELINE.json``
``configs[1]``), with its flags: ``--arch resnet50|tiny``, ``--steps``,
``--batch-size`` (global), ``--image-size``, ``--lr``, ``--momentum``,
``--weight-decay``, ``--opt-level``, ``--sync-bn``, ``--print-freq``,
``--resume``, ``--save``. Each rank trains ``ResNet`` on its shard of
the global batch: ``FusedSGD`` through the fused train step under the
opt level's loss scaler, the flat gradient all-reduced over the data
axis between the backward pass and the update (``PretrainStep(...,
grad_reduce=DistributedDataParallel())``), BatchNorm synchronised over
the data axis with ``--sync-bn``. The model computes in the opt level's
cast type (O2 fp16, O5 bf16, O3 fp16); the other levels keep the
reference's config dtype (bf16 for resnet50, fp32 for tiny).

The data is synthetic, ImageNet-shaped, drawn from ``RandomState(0)``
as the reference's: a global batch a step, each rank staging its shard
to its card through ``runtime.PrefetchLoader``. ``--fixed-batch``
repeats the first batch every step (a trainer check's fixed input).
``--save`` writes the model's parameters and running statistics and
the step from rank 0; ``--resume`` loads them on every rank and
continues from that step with a fresh optimizer state, as the
reference's does. Rank 0 prints the reference's end-of-run JSON line.
The reference's ``--profile-dir`` and its record on real hardware are
not ported. Run::

    torchrun --nproc-per-node 8 -m apex_tpu_torch.examples.imagenet_main_amp \
        --sync-bn --steps 100
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from apex_tpu_torch import amp
from apex_tpu_torch._backend import DeviceLike
from apex_tpu_torch.models.pretrain import PretrainStep
from apex_tpu_torch.models.resnet import (ResNet, ResNetConfig,
                                          cross_entropy_logits)
from apex_tpu_torch.optimizers import FusedSGD, make_train_step
from apex_tpu_torch.parallel import DistributedDataParallel, multiproc
from apex_tpu_torch.runtime import PrefetchLoader
from apex_tpu_torch.transformer import parallel_state as ps


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="ImageNet ResNet trainer")
    ap.add_argument("--arch", default="resnet50",
                    choices=["resnet50", "tiny"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=256,
                    help="global batch size")
    ap.add_argument("--image-size", type=int, default=None)
    ap.add_argument("--lr", type=float, default=0.1)
    ap.add_argument("--momentum", type=float, default=0.9)
    ap.add_argument("--weight-decay", type=float, default=1e-4)
    ap.add_argument("--opt-level", default="O5",
                    help="O0..O5; O5 = bf16 + fp32 master")
    ap.add_argument("--sync-bn", action="store_true",
                    help="SyncBatchNorm over the data axis")
    ap.add_argument("--print-freq", type=int, default=10)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--save", default=None)
    ap.add_argument("--fixed-batch", action="store_true",
                    help="repeat the first batch every step")
    return ap.parse_args(argv)


def config(args) -> ResNetConfig:
    props = amp.OPT_LEVELS[args.opt_level]
    axis = ps.DATA_AXIS if args.sync_bn else None
    if args.arch == "tiny":
        dtype = props.cast_model_type or torch.float32
        return ResNetConfig.resnet18ish(num_classes=100, bn_axis_name=axis,
                                        dtype=dtype)
    dtype = props.cast_model_type or torch.bfloat16
    return ResNetConfig.resnet50(bn_axis_name=axis, dtype=dtype)


def batches(args, num_classes: int, size: int):
    """The reference's synthetic global batches (``--fixed-batch``: the
    first, again and again)."""
    rng = np.random.RandomState(0)

    def draw():
        return {"x": rng.rand(args.batch_size, size, size, 3).astype(
                    np.float32),
                "y": rng.randint(0, num_classes, args.batch_size).astype(
                    np.int32)}

    first = draw()
    while True:
        yield first
        if not args.fixed_batch:
            first = draw()


def train(args, *, device: DeviceLike = None,
          state_dict: Optional[dict] = None,
          grad_hook: Optional[Callable[[int, torch.Tensor], None]] = None,
          on_step: Optional[Callable[..., None]] = None,
          sync_steps: bool = False) -> dict:
    """The example's loop on this rank; the topology must be
    initialized. ``state_dict`` replaces the seeded weights;
    ``grad_hook(i, flat_grad)`` runs on this rank's gradient of step
    ``i`` before the all-reduce; ``on_step(i, step, state,
    scaler_state, loss)`` after each step. With ``sync_steps`` each
    step's wall time is taken after a device synchronize."""
    dev = multiproc.rank_device(device)
    dp = ps.get_data_parallel_world_size()
    rank = ps.get_data_parallel_rank()
    if args.batch_size % dp:
        raise ValueError(f"batch size {args.batch_size} % dp {dp} != 0")
    cfg = config(args)
    size = args.image_size or (32 if args.arch == "tiny" else 224)
    model = ResNet(cfg, device=dev,
                   generator=torch.Generator().manual_seed(0))
    if state_dict is not None:
        model.load_state_dict(state_dict)
    start_step = 0
    if args.resume and os.path.exists(args.resume):
        ckpt = torch.load(args.resume, map_location=dev)
        model.load_state_dict(ckpt["model"])
        start_step = int(ckpt["step"])
        if multiproc.is_coordinator():
            print(f"resumed from {args.resume} at step {start_step}")

    opt = FusedSGD(lr=args.lr, momentum=args.momentum,
                   weight_decay=args.weight_decay)
    with amp.policy_scope(amp._amp_state.get_active()):
        _, state, amp_state = amp.initialize(dict(model.named_parameters()),
                                             opt, opt_level=args.opt_level)
    ddp = DistributedDataParallel()
    now = {"step": start_step}

    def reduce(grad):
        if grad_hook is not None:
            grad_hook(now["step"], grad)
        ddp.allreduce_grads(grad)

    step = PretrainStep(
        model, opt,
        loss_fn=lambda m, x, y: cross_entropy_logits(m(x), y),
        train_step=make_train_step(
            opt, scaler=amp.make_scaler(amp_state.properties)),
        grad_reduce=reduce)
    ss = amp_state.scalers[0]
    local = args.batch_size // dp
    shard = slice(rank * local, (rank + 1) * local)
    loader = iter(PrefetchLoader(
        batches(args, cfg.num_classes, size), depth=2, device=dev,
        transform=lambda b: {"x": b["x"][shard], "y": b["y"][shard]}))

    losses, step_s = [], []
    t0 = time.perf_counter()
    for i in range(start_step, args.steps):
        now["step"] = i
        batch = next(loader)
        ts = time.perf_counter()
        state, ss, loss = step(state, batch["x"], batch["y"],
                               scaler_state=ss)
        if sync_steps:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            step_s.append(time.perf_counter() - ts)
        losses.append(float(loss))
        if on_step is not None:
            on_step(i, step, state, ss, loss)
        if multiproc.is_coordinator() and (
                i % args.print_freq == 0 or i == args.steps - 1):
            ips = args.batch_size * (i - start_step + 1) / (
                time.perf_counter() - t0)
            print(f"step {i:5d}  loss {losses[-1]:.4f}  {ips:8.1f} img/s")
    total = time.perf_counter() - t0
    step.bind(state)                # the model holds the final weights
    n_run = args.steps - start_step
    summary = {
        "example": "imagenet_main_amp",
        "arch": args.arch,
        "opt_level": args.opt_level,
        "steps": n_run,
        "global_batch": args.batch_size,
        "imgs_per_sec": round(args.batch_size * n_run / total, 1),
        "final_loss": round(losses[-1], 4) if losses else None,
        "backend": dev.type,
        "n_devices": dp,
    }
    if multiproc.is_coordinator():
        print(json.dumps(summary))
        if args.save:
            torch.save({"model": model.state_dict(), "step": args.steps},
                       args.save)
            print(f"saved {args.save}")
    return {"losses": losses, "step_s": step_s, "summary": summary,
            "state": state, "scaler_state": ss, "model": model,
            "step": step}


def main(argv=None, *, device: DeviceLike = None) -> float:
    """Join the world, train, return this rank's final loss."""
    args = parse_args(argv)
    multiproc.initialize_distributed()
    ps.initialize_model_parallel()
    try:
        out = train(args, device=device)
    finally:
        ps.destroy_model_parallel()
    return out["losses"][-1] if out["losses"] else float("nan")


if __name__ == "__main__":
    main()
