"""GPT pretraining over the mesh: data, tensor and pipeline parallelism.

Counterpart of ``examples/gpt_pretrain/pretrain_gpt.py`` with its flags:
``mesh.initialize_mesh(model=tp, pipe=pp)`` (``batch`` takes the rest of
the world), a pipeline schedule on the ``pipe`` axis (1F1B by default;
``--schedule interleaved_1f1b`` with ``--model-chunks 2``), the tensor
layers on the ``model`` axis, FusedAdam on each rank's flat master, and
a checkpoint with exact resume (``--save DIR``: each rank's
``opt.state_dict`` and the step through ``torch.save``, where the
reference uses orbax; the batch stream skips the batches already taken,
so a resumed run draws the batches the uninterrupted run would have).

Every rank runs :func:`main`, which joins the world from the
environment (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``)::

    torchrun --nproc-per-node 4 -m apex_tpu_torch.examples.pretrain_gpt \\
        --tp 2 --pp 2 --steps 20

or from Python, ranks spawned by ``parallel.multiproc`` (gloo on the
CPU)::

    multiproc.launch(pretrain_gpt.main, 4, (argv, "cpu"), backend="gloo")

The weights are drawn from seed 0 on every rank (the full model, then
this rank's stage and shard); the synthetic token stream is seeded 0 as
the reference's is. An ``async_1f1b`` run resumes with its carried
boundary tensors dropped (the pipeline warms up again).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import Callable, Optional

import numpy as np
import torch

from apex_tpu_torch import mesh as gmesh
from apex_tpu_torch._backend import DeviceLike
from apex_tpu_torch.models.gpt import GPTConfig
from apex_tpu_torch.models.pretrain import (init_gpt_pretrain_params,
                                            make_gpt_pretrain_step)
from apex_tpu_torch.optimizers import FusedAdam
from apex_tpu_torch.parallel import multiproc


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--tp", type=int, default=2)
    p.add_argument("--pp", type=int, default=2)
    p.add_argument("--schedule", type=str, default="1f1b",
                   choices=("gpipe", "1f1b", "interleaved_1f1b",
                            "async_1f1b"))
    p.add_argument("--model-chunks", type=int, default=1,
                   help="model chunks per stage (>1 selects the "
                        "interleaved schedule)")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--micro-batches", type=int, default=2)
    p.add_argument("--seq", type=int, default=128)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--vocab", type=int, default=1024)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--bf16", action="store_true",
                   help="bf16 compute (fp32 master in the fused optimizer "
                        "state)")
    p.add_argument("--save", type=str, default="",
                   help="checkpoint directory; if it already holds a "
                        "checkpoint, training resumes from it exactly")
    return p.parse_args(argv)


def synthetic_batch(rng, n, seq, vocab):
    """A deterministic token stream: (inputs, labels), each (n, seq)."""
    toks = rng.randint(0, vocab, (n, seq + 1)).astype(np.int64)
    return torch.from_numpy(toks[:, :-1]), torch.from_numpy(toks[:, 1:])


def train(args, *, device: DeviceLike = None,
          on_step: Optional[Callable[..., None]] = None) -> dict:
    """The example's loop on this rank (the mesh already initialized):
    the losses, the step it started at (after a resume) and the step and
    state. ``on_step(i, step, state, loss)`` runs after each step."""
    dev = multiproc.rank_device(device)
    cfg = GPTConfig(vocab_size=args.vocab, max_seq_len=args.seq,
                    hidden_size=args.hidden, num_layers=args.layers,
                    num_heads=args.heads, attention_backend="flash",
                    dtype=torch.bfloat16 if args.bf16 else torch.float32)
    full = init_gpt_pretrain_params(cfg, torch.Generator().manual_seed(0),
                                    device="cpu")
    opt = FusedAdam(lr=args.lr, weight_decay=0.01)
    step, state = make_gpt_pretrain_step(
        cfg, opt, schedule=args.schedule,
        num_microbatches=args.micro_batches,
        num_model_chunks=args.model_chunks)(full, device=dev)
    del full
    start, path = 0, None
    if args.save:
        rank = torch.distributed.get_rank() \
            if torch.distributed.is_initialized() else 0
        path = os.path.join(os.path.abspath(args.save), f"rank{rank}.pt")
        if os.path.isfile(path):
            saved = torch.load(path, map_location=dev)
            state = opt.load_state_dict(state, saved["opt"])
            start = int(saved["step"])
            print(f"resumed from {path} at step {start}")
    rng = np.random.RandomState(0)
    for _ in range(start):
        synthetic_batch(rng, args.global_batch, args.seq, args.vocab)
    losses = []
    t0 = time.perf_counter()
    for i in range(start, args.steps):
        x, y = synthetic_batch(rng, args.global_batch, args.seq, args.vocab)
        state, loss = step(state, x.to(dev), y.to(dev))
        losses.append(float(loss))
        if on_step is not None:
            on_step(i, step, state, loss)
        if i % 5 == 0 or i == args.steps - 1:
            dt = time.perf_counter() - t0
            tok_s = args.global_batch * args.seq * (i - start + 1) / dt
            bubble = getattr(step, "last_bubble_fraction", None)
            extra = f"  bubble {bubble:.3f}" if bubble is not None else ""
            print(f"step {i:4d}  loss {losses[-1]:.4f}  {tok_s:,.0f} tok/s"
                  f"{extra}")
    if path is not None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save({"opt": opt.state_dict(state), "step": args.steps}, path)
        print(f"saved checkpoint to {path}")
    return {"losses": losses, "start": start, "step": step, "state": state}


def main(argv=None, device: DeviceLike = None) -> float:
    """Join the world, lay out the mesh, train; this rank's last loss
    (nan when no step ran). ``device`` defaults to this rank's card."""
    args = parse_args(argv)
    multiproc.initialize_distributed()
    gmesh.initialize_mesh(model=args.tp, pipe=args.pp)
    sizes = gmesh.axis_sizes()
    print(f"mesh: dp={sizes['batch']} tp={args.tp} pp={args.pp} "
          f"ranks={gmesh.mesh_size()}")
    try:
        out = train(args, device=device)
    finally:
        gmesh.destroy_mesh()
    return out["losses"][-1] if out["losses"] else float("nan")


if __name__ == "__main__":
    main()
