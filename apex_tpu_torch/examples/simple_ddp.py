"""Minimal data-parallel example: an MNIST-sized MLP under amp O1 and
``DistributedDataParallel``.

Port of ``examples/simple/distributed/distributed_data_parallel.py``
(``BASELINE.json`` ``configs[0]``): the 784-128-128-10 MLP, amp O1,
``FusedSGD(lr 0.05, momentum 0.9)`` under the dynamic loss scaler, the
flat gradient all-reduced over the data axis (``PretrainStep(...,
grad_reduce=DistributedDataParallel())``), one fixed global batch
split over the data group. The MLP computes in fp32, as the
reference's does (amp O1 casts only the ops written against ``amp.F``).
Each rank runs :func:`main`, which joins the world from the launcher's
environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``) and returns the rank's final loss::

    torchrun --nproc-per-node 2 -m apex_tpu_torch.examples.simple_ddp

or, sharing one card or on the CPU, ``parallel.multiproc.launch(main,
2, (argv,), backend="gloo")``. Every step polls the preemption flag
across the ranks (``PreemptionHandler.should_stop`` over
``multiproc.process_collective()``): a SIGTERM to any rank stops every
rank at the same step. ``faults.maybe_sigterm(step)`` is the drill's
fault site.
"""

from __future__ import annotations

import argparse
import math
import threading
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from apex_tpu_torch import amp
from apex_tpu_torch._backend import DeviceLike
from apex_tpu_torch.models.pretrain import PretrainStep
from apex_tpu_torch.optimizers import FusedSGD, make_train_step
from apex_tpu_torch.parallel import DistributedDataParallel, multiproc
from apex_tpu_torch.resilience import faults
from apex_tpu_torch.resilience.guard import PreemptionHandler
from apex_tpu_torch.transformer import parallel_state as ps

# the reference's he_normal: a normal truncated to [-2, 2] std, whose
# std this divides out
_TRUNC_STD = 0.87962566103423978
LAYERS = ("fc1", "fc2", "out")


def mnist_mlp_params(generator: Optional[torch.Generator] = None,
                     hidden: int = 128) -> Dict[str, torch.Tensor]:
    """He-normal weights ``(in, out)`` and zero biases on the CPU, the
    reference's ``mnist_mlp_params`` drawn from ``generator``."""
    params = {}
    for name, fan_in, fan_out in zip(LAYERS, (784, hidden, hidden),
                                     (hidden, hidden, 10)):
        std = math.sqrt(2.0 / fan_in) / _TRUNC_STD
        w = torch.empty(fan_in, fan_out)
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        params[f"{name}.w"] = w
        params[f"{name}.b"] = torch.zeros(fan_out)
    return params


class MnistMLP(nn.Module):
    """relu(x @ w1 + b1) -> relu(. @ w2 + b2) -> . @ w3 + b3."""

    def __init__(self, params: Dict[str, torch.Tensor], device=None):
        super().__init__()
        for name in LAYERS:
            layer = nn.Module()
            layer.w = nn.Parameter(torch.as_tensor(
                params[f"{name}.w"], dtype=torch.float32).clone())
            layer.b = nn.Parameter(torch.as_tensor(
                params[f"{name}.b"], dtype=torch.float32).clone())
            self.add_module(name, layer)
        self.to(device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(x @ self.fc1.w + self.fc1.b)
        x = torch.relu(x @ self.fc2.w + self.fc2.b)
        return x @ self.out.w + self.out.b


def local_loss(model: MnistMLP, x: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy of the rank's shard."""
    logits = model(x).float()
    lse = torch.logsumexp(logits, dim=-1)
    return torch.mean(lse - torch.gather(logits, -1, y.long()[:, None])[:, 0])


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch-size", type=int, default=64,
                    help="global batch (split over the data axis)")
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--opt-level", default="O1")
    return ap.parse_args(argv)


def train(args, *, params: Optional[Dict[str, torch.Tensor]] = None,
          device: DeviceLike = None,
          on_step: Optional[Callable[..., None]] = None) -> dict:
    """The example's loop on this rank; the topology must be
    initialized. ``params`` (the reference's tree flattened to
    ``fc1.w`` ... ``out.b``) default to :func:`mnist_mlp_params` of
    seed 0. ``on_step(i, state, scaler_state, loss)`` runs after each
    step. Returns the losses, the step the ranks stopped at (None when
    they ran to the end) and the final optimizer and scaler states."""
    dev = multiproc.rank_device(device)
    dp = ps.get_data_parallel_world_size()
    rank = ps.get_data_parallel_rank()
    if args.batch_size % dp:
        raise ValueError(f"batch size {args.batch_size} % dp {dp} != 0")
    rng = np.random.RandomState(0)
    x = rng.rand(args.batch_size, 784).astype(np.float32)
    y = rng.randint(0, 10, args.batch_size)
    shard = slice(rank * args.batch_size // dp,
                  (rank + 1) * args.batch_size // dp)
    x = torch.as_tensor(x[shard], device=dev)
    y = torch.as_tensor(y[shard], device=dev)

    if params is None:
        params = mnist_mlp_params(torch.Generator().manual_seed(0))
    model = MnistMLP(params, dev)
    opt = FusedSGD(lr=args.lr, momentum=0.9)
    with amp.policy_scope(amp._amp_state.get_active()):
        _, state, amp_state = amp.initialize(dict(model.named_parameters()),
                                             opt, opt_level=args.opt_level)
    step = PretrainStep(model, opt, loss_fn=local_loss,
                        train_step=make_train_step(
                            opt, scaler=amp.make_scaler(amp_state.properties)),
                        grad_reduce=DistributedDataParallel())
    ss = amp_state.scalers[0]
    col = multiproc.process_collective()
    handler = (PreemptionHandler().install()
               if threading.current_thread() is threading.main_thread()
               else None)
    losses, stopped_at = [], None
    try:
        for i in range(args.steps):
            faults.maybe_sigterm(i)
            if handler is not None and handler.should_stop(col):
                stopped_at = i
                break
            state, ss, loss = step(state, x, y, scaler_state=ss)
            losses.append(float(loss))
            if on_step is not None:
                on_step(i, state, ss, loss)
            if ps.get_data_parallel_rank() == 0 and (
                    i % 10 == 0 or i == args.steps - 1):
                print(f"step {i:4d}  loss {losses[-1]:.4f}  "
                      f"scale {ss.loss_scale:.0f}")
    finally:
        if handler is not None:
            handler.uninstall()
    return {"losses": losses, "stopped_at": stopped_at, "state": state,
            "scaler_state": ss, "model": model}


def main(argv=None, *, params=None, device: DeviceLike = None) -> float:
    """Join the world, train, return this rank's final loss."""
    args = parse_args(argv)
    multiproc.initialize_distributed()
    ps.initialize_model_parallel()      # every rank on the data axis
    print(f"mesh: data={ps.get_data_parallel_world_size()}")
    try:
        out = train(args, params=params, device=device)
    finally:
        ps.destroy_model_parallel()
    return out["losses"][-1]


if __name__ == "__main__":
    main()
