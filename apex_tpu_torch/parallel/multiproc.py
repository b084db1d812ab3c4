"""Multi-process bootstrap: one process per rank over ``torch.distributed``.

Counterpart of ``apex_tpu/parallel/multiproc.py`` (:18-165), which wraps
``jax.distributed.initialize`` with the reference launcher's
environment variables. Here each rank is a process of its own and
:func:`initialize_distributed` brings up the default process group from
the same variables (``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``,
``RANK``; ``LOCAL_RANK`` picks the rank's card). A world of one is a
no-op, as in the reference.

The backend is NCCL when the rank's device is a CUDA card and gloo on
the CPU, unless the caller names one. NCCL refuses two ranks on one
card, so asking for it with more ranks on a host than cards raises;
nothing switches to gloo behind the caller's back (pass
``backend="gloo"`` to share a card between ranks: gloo moves CUDA
tensors through host memory).

:func:`launch` starts ``nprocs`` ranks on this host with the ``spawn``
start method (CUDA cannot be used in a forked child), a rendezvous
through a file in a temporary directory or a ``TCPStore`` on a free
local port, runs a function in each and returns every rank's result;
any rank's failure raises in the caller.

``elastic_checkpoint_manager`` waits for the checkpoint plane (the
roadmap's A 10) and raises.
"""

from __future__ import annotations

import os
import pickle
import shutil
import socket
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return None if v is None else int(v)


def local_rank() -> int:
    """This rank's index on its host (``LOCAL_RANK``, 0 without it)."""
    return _env_int("LOCAL_RANK") or 0


def device() -> torch.device:
    """This rank's device: ``cuda:{local_rank % device_count}`` where
    CUDA is present, else the CPU."""
    if torch.cuda.is_available():
        return torch.device("cuda", local_rank() % torch.cuda.device_count())
    return torch.device("cpu")


def rank_device(requested=None) -> torch.device:
    """An entry point's device: the caller's, else this rank's card
    (raising without CUDA, as every entry point does)."""
    from apex_tpu_torch._backend import resolve_device

    if requested is not None:
        return resolve_device(requested)
    resolve_device(None)
    return device()


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
) -> None:
    """Join this process to the world (the reference's :18).

    Arguments not given fall back to ``MASTER_ADDR:MASTER_PORT`` (port
    12355 by default), ``WORLD_SIZE`` and ``RANK``. ``init_method`` (a
    ``file://`` or ``tcp://`` URL) takes the place of the address. A
    world of one, or no address at all, is a no-op."""
    if coordinator_address is None and init_method is None:
        addr = os.environ.get("MASTER_ADDR")
        port = os.environ.get("MASTER_PORT", "12355")
        coordinator_address = f"{addr}:{port}" if addr else None
    if num_processes is None:
        num_processes = _env_int("WORLD_SIZE")
    if process_id is None:
        process_id = _env_int("RANK")
    if num_processes in (None, 1) or (coordinator_address is None
                                      and init_method is None):
        return
    if dist.is_initialized():
        if dist.get_world_size() != num_processes:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} ranks is "
                f"already initialized, not {num_processes}")
        return
    dev = device()
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        per_host = _env_int("LOCAL_WORLD_SIZE") or num_processes
        cards = torch.cuda.device_count()
        if per_host > cards:
            raise RuntimeError(
                f"NCCL needs a card a rank: {per_host} ranks on this host, "
                f"{cards} card(s); pass backend='gloo' to share a card")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method or f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)


def is_coordinator() -> bool:
    """True on rank 0, the process that owns the world's singleton
    duties (progress logging, records)."""
    return process_index() == 0


def process_index() -> int:
    """This process's global rank (the reference launcher's RANK)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_collective():
    """The resilience guard's collective for this world: a
    ``ProcessCollective`` over the default process group when there is
    more than one rank, else a ``NullCollective``, each routed through
    ``telemetry.comms.instrument`` (the object itself when the comms
    plane is disarmed).

    The reference picks its ``KVStoreCollective`` on a CPU cluster
    (:59-99) because JAX runs no multi-process computation on the CPU.
    Gloo does, so ``ProcessCollective`` serves on the CPU too;
    ``KVStoreCollective`` stays for callers who want the store's
    transport."""
    from apex_tpu_torch.resilience.guard import (NullCollective,
                                                 ProcessCollective)
    from apex_tpu_torch.telemetry import comms

    if world_size() > 1:
        return comms.instrument(ProcessCollective())
    return comms.instrument(NullCollective())


def fleet_aggregator(**kwargs):
    """A ``telemetry.fleet.FleetAggregator`` over
    :func:`process_collective`; every rank calls its ``aggregate()``."""
    from apex_tpu_torch.telemetry.fleet import FleetAggregator

    return FleetAggregator(process_collective(), **kwargs)


def elastic_checkpoint_manager(directory, **kwargs):
    """Waits for the elastic checkpoint plane (the roadmap's A 10)."""
    raise NotImplementedError(
        "elastic_checkpoint_manager: the elastic checkpoint plane is not "
        "ported yet (roadmap A 10)")


# -- launcher ------------------------------------------------------------------


def _free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _child(fn, rank: int, nprocs: int, init: str, backend, args,
           out: str, threads: Optional[int]) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(nprocs),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(nprocs))
    if threads:
        torch.set_num_threads(threads)
    try:
        initialize_distributed(num_processes=nprocs, process_id=rank,
                               backend=backend, init_method=init)
        result = fn(*args)
        with open(out + ".tmp", "wb") as f:
            pickle.dump(result, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(out + ".tmp", out)
    except BaseException:
        with open(out + ".err", "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable[..., Any], nprocs: int, args: Sequence = (), *,
           backend: Optional[str] = None, rendezvous: str = "file",
           timeout: float = 600.0, threads: Optional[int] = None
           ) -> List[Any]:
    """Run ``fn(*args)`` in ``nprocs`` spawned ranks of one world and
    return their results, by rank (each must pickle).

    ``fn`` must be importable by name (a module-level function). Each
    rank calls :func:`initialize_distributed` first (``backend`` as
    there) over ``rendezvous``: ``"file"`` (a file in a temporary
    directory) or ``"tcp"`` (a ``TCPStore`` on a free local port).
    ``threads`` sets each rank's intra-op threads. A rank that raises
    or dies, or a world that outlives ``timeout`` seconds, stops every
    rank and raises here with the rank's traceback."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="apex_launch_")
    if rendezvous == "file":
        init = "file://" + os.path.join(tmp, "rendezvous")
    elif rendezvous == "tcp":
        init = f"tcp://localhost:{_free_port()}"
    else:
        raise ValueError(f"rendezvous {rendezvous!r}: 'file' or 'tcp'")
    outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(nprocs)]
    procs = [ctx.Process(target=_child, args=(fn, r, nprocs, init, backend,
                                              tuple(args), outs[r], threads),
                         daemon=True)
             for r in range(nprocs)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while any(p.exitcode is None for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed:
                r = failed[0]
                err = outs[r] + ".err"
                msg = (open(err).read() if os.path.exists(err)
                       else f"exit code {procs[r].exitcode}")
                raise RuntimeError(f"rank {r} of {nprocs} failed:\n{msg}")
            if time.monotonic() > deadline:
                raise TimeoutError(f"{nprocs} ranks still running after "
                                   f"{timeout:.0f} s")
            time.sleep(0.05)
        results = []
        for r, p in enumerate(procs):
            if p.exitcode != 0 or not os.path.exists(outs[r]):
                err = outs[r] + ".err"
                msg = (open(err).read() if os.path.exists(err)
                       else f"exit code {p.exitcode}")
                raise RuntimeError(f"rank {r} of {nprocs} failed:\n{msg}")
            with open(outs[r], "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.pid is None:
                continue
            if p.exitcode is None:
                p.kill()
            p.join(timeout=30)
        shutil.rmtree(tmp, ignore_errors=True)


__all__ = ["device", "elastic_checkpoint_manager", "fleet_aggregator",
           "initialize_distributed", "is_coordinator", "launch",
           "local_rank", "process_collective", "process_index", "rank_device",
           "world_size"]
