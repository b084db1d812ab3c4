"""Resilience: fault injection, the atomic write discipline and the
preemption flag (the part of ``apex_tpu/resilience/`` the serving
planes need).

- :mod:`~apex_tpu_torch.resilience.faults` — the whole
  ``APEX_TPU_FAULTS`` grammar and the serving sites' helpers;
- :mod:`~apex_tpu_torch.resilience.checkpoint` — ``atomic_write_files``
  (tmp -> fsync -> rename), which the serving drain snapshots commit
  through;
- :mod:`~apex_tpu_torch.resilience.guard` — ``PreemptionHandler``.
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
    PreemptionHandler,
    install_preemption_handler,
)

__all__ = [
    "EngineCrash",
    "FaultError",
    "FaultInjector",
    "PreemptionHandler",
    "SimulatedCrash",
    "atomic_write_files",
    "checkpoint",
    "faults",
    "guard",
    "install_preemption_handler",
]
