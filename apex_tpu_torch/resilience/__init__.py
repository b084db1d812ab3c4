"""Resilience: fault injection, retry, the atomic write discipline,
the replica-set collectives and the preemption flag (the part of
``apex_tpu/resilience/`` the serving planes and the fleet router need).

- :mod:`~apex_tpu_torch.resilience.faults` — the whole
  ``APEX_TPU_FAULTS`` grammar and the serving, fleet and comms sites'
  decisions;
- :mod:`~apex_tpu_torch.resilience.retry` — deadline-aware backoff with
  jitter and the non-retryable allowlist;
- :mod:`~apex_tpu_torch.resilience.checkpoint` — ``atomic_write_files``
  (tmp -> fsync -> rename), which the serving drain snapshots commit
  through;
- :mod:`~apex_tpu_torch.resilience.guard` — the ``Collective`` contract
  (``NullCollective``, ``LocalCollective``, ``ProcessCollective``,
  ``KVStoreCollective``) and ``PreemptionHandler``.
"""

from apex_tpu_torch.resilience import checkpoint, faults, guard
from apex_tpu_torch.resilience.checkpoint import atomic_write_files
from apex_tpu_torch.resilience.faults import (
    EngineCrash,
    FaultError,
    FaultInjector,
    SimulatedCrash,
)
from apex_tpu_torch.resilience.guard import (
    Collective,
    KVStoreCollective,
    LocalCollective,
    NullCollective,
    PreemptionHandler,
    ProcessCollective,
    install_preemption_handler,
)
from apex_tpu_torch.resilience.retry import (
    NON_RETRYABLE,
    backoff_delays,
    retry,
    retry_call,
)

__all__ = [
    "Collective",
    "EngineCrash",
    "FaultError",
    "FaultInjector",
    "KVStoreCollective",
    "LocalCollective",
    "NON_RETRYABLE",
    "NullCollective",
    "PreemptionHandler",
    "ProcessCollective",
    "SimulatedCrash",
    "atomic_write_files",
    "backoff_delays",
    "checkpoint",
    "faults",
    "guard",
    "install_preemption_handler",
    "retry",
    "retry_call",
]
