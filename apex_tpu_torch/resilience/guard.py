"""Replica-set collectives and preemption-safe shutdown.

Counterpart of two parts of ``apex_tpu/resilience/guard.py``:

- the :class:`Collective` contract (``all_gather`` / ``broadcast_from``
  / ``barrier`` / ``agree_any`` over host numpy arrays), the one-replica
  :class:`NullCollective` and the threaded in-process
  :class:`LocalCollective` (:189-407): what the fleet router's handoff
  wire, ``telemetry.comms`` and ``telemetry.fleet`` ride;
- ``PreemptionHandler`` and ``install_preemption_handler`` (:692-757):
  the SIGTERM flag the serving drain polls.

The multi-process collectives (``ProcessCollective``,
``KVStoreCollective``, :241-350), the ``ConsistencyGuard`` and
``graceful_shutdown`` come with the distributed planes (the roadmap's
A 9), and so does the cross-host agreement:
:meth:`PreemptionHandler.should_stop` takes no collective or a
one-replica one and raises for more.
"""

from __future__ import annotations

import signal
import threading
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
        """Drain point for the step loop: the local flag. A collective
        over more than one replica (the reference's cross-host
        agreement) raises until the distributed planes are ported."""
        if collective is not None and collective.n_replicas > 1:
            raise NotImplementedError(
                "PreemptionHandler.should_stop: cross-replica agreement "
                f"over {collective.n_replicas} replicas is not ported")
        return self.requested

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
    "LocalCollective",
    "NullCollective",
    "PreemptionHandler",
    "install_preemption_handler",
]
