"""Replica-set collectives and preemption-safe shutdown.

Counterpart of two parts of ``apex_tpu/resilience/guard.py``:

- the :class:`Collective` contract (``all_gather`` / ``broadcast_from``
  / ``barrier`` / ``agree_any`` over host numpy arrays), the one-replica
  :class:`NullCollective`, the threaded in-process
  :class:`LocalCollective` (:189-407) and the multi-process ones
  (:241-348): :class:`ProcessCollective` over ``torch.distributed``'s
  default process group (a gloo group of its own for the host payloads
  when the default group is NCCL) and :class:`KVStoreCollective` over
  that group's key-value store (``TCPStore`` or ``FileStore``), with the
  reference's key scheme. What the fleet router's handoff wire,
  ``telemetry.comms`` and ``telemetry.fleet`` ride;
- ``PreemptionHandler`` and ``install_preemption_handler`` (:692-757):
  the SIGTERM flag the serving drain and the training loops poll;
  :meth:`PreemptionHandler.should_stop` with a collective of more than
  one replica runs ``agree_any``: any flagged replica stops them all.

The ``ConsistencyGuard``, the state fingerprints and
``graceful_shutdown`` need the checkpoint manager, the per-leaf
checksums and the train step's ``fingerprint_every``, which come with
the checkpoint plane (the roadmap's A 10).
"""

from __future__ import annotations

import io
import signal
import threading
from datetime import timedelta
from typing import Any, Dict, List, Optional, Sequence

import numpy as np


class Collective:
    """The minimal replica-set interface the guard needs. Replicas are
    the members of the data axis that hold (supposedly) bit-identical
    state — one per host process on a multi-host deployment.

    Observability: route instances through
    ``telemetry.comms.instrument()`` to trace every op (per-op
    counters/bytes/ms, timeline spans, the wire bandwidth ledger);
    with the comms plane disabled that call returns the raw object
    unchanged. :meth:`impl_name` is the ``impl=`` label the traced
    metrics carry."""

    n_replicas: int = 1
    replica_id: int = 0

    def impl_name(self) -> str:
        """Implementation label for comms tracing (telemetry/comms)."""
        return type(self).__name__

    def all_gather(self, arr: np.ndarray) -> np.ndarray:
        """(n_replicas, *arr.shape) — every replica's copy, by id."""
        raise NotImplementedError

    def broadcast_from(self, src: int,
                       arrays: Sequence[np.ndarray]) -> List[np.ndarray]:
        """Every replica returns replica ``src``'s ``arrays``. A
        collective op: ALL replicas must call it."""
        raise NotImplementedError

    def barrier(self) -> None:
        """Block until every replica has arrived."""
        raise NotImplementedError

    def agree_any(self, flag: bool) -> bool:
        """True on every replica iff ANY replica passed True."""
        out = self.all_gather(np.asarray([1 if flag else 0], np.int32))
        return bool(np.any(out))


class NullCollective(Collective):
    """Single replica: gathers are identity, broadcasts echo."""

    def all_gather(self, arr: np.ndarray) -> np.ndarray:
        return np.asarray(arr)[None]

    def broadcast_from(self, src, arrays):
        return [np.asarray(a) for a in arrays]

    def barrier(self) -> None:
        pass


class ProcessCollective(Collective):
    """One replica per rank of ``torch.distributed``'s default process
    group (the reference's :241, over ``multihost_utils``). Host arrays
    ride CPU tensors: gathers as raw bytes (every replica passes one
    shape and dtype, as the contract says), broadcasts as pickled
    objects (only the source knows the shapes). When the default group
    is NCCL, a gloo group over the same ranks, made here, carries them;
    so every rank constructs its collective at the same point."""

    def __init__(self):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialized; call "
                               "parallel.multiproc.initialize_distributed")
        self._dist = dist
        self.n_replicas = dist.get_world_size()
        self.replica_id = dist.get_rank()
        self._group = (dist.new_group(backend="gloo")
                       if dist.get_backend() == "nccl" else None)

    def all_gather(self, arr: np.ndarray) -> np.ndarray:
        import torch

        arr = np.ascontiguousarray(arr)
        mine = torch.from_numpy(arr.reshape(-1).view(np.uint8).copy())
        out = [torch.empty_like(mine) for _ in range(self.n_replicas)]
        self._dist.all_gather(out, mine, group=self._group)
        return np.stack([o.numpy().view(arr.dtype).reshape(arr.shape)
                         for o in out])

    def broadcast_from(self, src, arrays):
        box = [[np.asarray(a) for a in arrays]
               if self.replica_id == src else None]
        self._dist.broadcast_object_list(box, src=src, group=self._group)
        return [np.asarray(a) for a in box[0]]

    def barrier(self) -> None:
        self._dist.barrier(group=self._group)


class KVStoreCollective(Collective):
    """A replica set over the default process group's key-value store
    (the reference's :273 over the ``jax.distributed`` coordination
    service), not over its collectives. The reference's key scheme:
    each op takes a fresh key namespace ``{prefix}/{seq}`` (replicas
    issue collectives in lockstep, so their sequence numbers agree),
    values travel as ``.npy`` bytes, a barrier is every replica's key
    under one namespace."""

    def __init__(self, *, timeout: float = 60.0,
                 prefix: str = "apex_tpu_kvc"):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialized; call "
                               "parallel.multiproc.initialize_distributed")
        self._store = dist.distributed_c10d._get_default_store()
        self.n_replicas = dist.get_world_size()
        self.replica_id = dist.get_rank()
        self.timeout = timedelta(seconds=timeout)
        self._prefix = prefix
        self._seq = 0

    def _op(self) -> str:
        self._seq += 1
        return f"{self._prefix}/{self._seq}"

    @staticmethod
    def _encode(arr: np.ndarray) -> bytes:
        buf = io.BytesIO()
        np.save(buf, np.ascontiguousarray(arr), allow_pickle=False)
        return buf.getvalue()

    @staticmethod
    def _decode(data: bytes) -> np.ndarray:
        return np.load(io.BytesIO(data), allow_pickle=False)

    def _get(self, key: str) -> bytes:
        self._store.wait([key], self.timeout)
        return self._store.get(key)

    def all_gather(self, arr: np.ndarray) -> np.ndarray:
        op = self._op()
        self._store.set(f"{op}/{self.replica_id}",
                        self._encode(np.asarray(arr)))
        return np.stack([self._decode(self._get(f"{op}/{r}"))
                         for r in range(self.n_replicas)])

    def broadcast_from(self, src, arrays):
        op = self._op()
        if self.replica_id == src:
            for i, a in enumerate(arrays):
                self._store.set(f"{op}/{i}", self._encode(np.asarray(a)))
            return [np.asarray(a) for a in arrays]
        n = len(arrays)
        return [self._decode(self._get(f"{op}/{i}")) for i in range(n)]

    def barrier(self) -> None:
        op = self._op().replace("/", "_")
        self._store.set(f"{op}/{self.replica_id}", b"1")
        self._store.wait([f"{op}/{r}" for r in range(self.n_replicas)],
                         self.timeout)


class LocalCollective:
    """An in-process replica set: ``handles(n)`` returns one
    :class:`Collective` per simulated host, synchronized with barriers.
    Each replica runs the SAME loop code a real host would, on its own
    thread: what the fleet telemetry tests drive.
    """

    def __init__(self, n_replicas: int, timeout: float = 60.0):
        self.n_replicas = int(n_replicas)
        self.timeout = float(timeout)
        self._barrier = threading.Barrier(self.n_replicas)
        self._lock = threading.Lock()
        self._slots: Dict[int, Any] = {}

    def handles(self) -> List["_LocalHandle"]:
        return [_LocalHandle(self, r) for r in range(self.n_replicas)]

    def _exchange(self, replica_id: int, value):
        """All replicas deposit, then all read the full slot map."""
        with self._lock:
            self._slots[replica_id] = value
        self._barrier.wait(self.timeout)
        out = dict(self._slots)
        # second barrier: nobody may start the NEXT exchange (and
        # overwrite slots) until everyone has read this one
        self._barrier.wait(self.timeout)
        return out


class _LocalHandle(Collective):
    def __init__(self, group: LocalCollective, replica_id: int):
        self.group = group
        self.n_replicas = group.n_replicas
        self.replica_id = int(replica_id)

    def impl_name(self) -> str:
        return "LocalCollective"        # the sim, not its handle class

    def all_gather(self, arr: np.ndarray) -> np.ndarray:
        slots = self.group._exchange(self.replica_id, np.asarray(arr))
        return np.stack([slots[r] for r in range(self.n_replicas)])

    def broadcast_from(self, src, arrays):
        mine = ([np.asarray(a) for a in arrays]
                if self.replica_id == src else None)
        slots = self.group._exchange(self.replica_id, mine)
        return [np.copy(a) for a in slots[src]]

    def barrier(self) -> None:
        self.group._barrier.wait(self.group.timeout)


class PreemptionHandler:
    """Flag-drain preemption protocol.

    The signal handler body is async-signal-safe: it assigns two
    attributes and nothing else (no allocation beyond an int, no locks,
    no I/O — everything heavy happens later, on the step loop's thread,
    when it polls :meth:`should_stop`).
    """

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.signals = tuple(signals)
        self.requested = False
        self.signum: Optional[int] = None
        self._previous: Dict[int, Any] = {}
        self._installed = False

    # the signal-context entry point — keep it trivial
    def _handle(self, signum, frame):  # noqa: ARG002
        self.requested = True
        self.signum = signum

    def install(self) -> "PreemptionHandler":
        """Register on the configured signals (main thread only, per
        the ``signal`` module's contract); previous handlers are saved
        and restored by :meth:`uninstall`."""
        for s in self.signals:
            self._previous[s] = signal.signal(s, self._handle)
        self._installed = True
        return self

    def uninstall(self) -> None:
        for s, prev in self._previous.items():
            signal.signal(s, prev)
        self._previous.clear()
        self._installed = False

    def should_stop(self, collective=None) -> bool:
        """Drain point for the step loop. With a collective of more
        than one replica, the cross-host agreement: ANY flagged replica
        stops them all (a world that half-stops deadlocks its next
        collective). Without one, the local flag."""
        if collective is None or collective.n_replicas <= 1:
            return self.requested
        return collective.agree_any(self.requested)

    def __enter__(self):
        return self.install()

    def __exit__(self, *exc):
        self.uninstall()
        return False


def install_preemption_handler(
        signals=(signal.SIGTERM, signal.SIGINT)) -> PreemptionHandler:
    """Install and return a :class:`PreemptionHandler`."""
    return PreemptionHandler(signals).install()


__all__ = [
    "Collective",
    "KVStoreCollective",
    "LocalCollective",
    "NullCollective",
    "PreemptionHandler",
    "ProcessCollective",
    "install_preemption_handler",
]
