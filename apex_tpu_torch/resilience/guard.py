"""Preemption-safe shutdown: the SIGTERM flag the serving drain polls.

Counterpart of ``PreemptionHandler`` and ``install_preemption_handler``
in ``apex_tpu/resilience/guard.py`` (:692-757). The consistency guard
and ``graceful_shutdown`` are not ported yet, and neither is the
cross-host agreement: :meth:`PreemptionHandler.should_stop` takes no
collective or a one-replica one and raises for more.
"""

from __future__ import annotations

import signal
from typing import Any, Dict, Optional


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


__all__ = ["PreemptionHandler", "install_preemption_handler"]
