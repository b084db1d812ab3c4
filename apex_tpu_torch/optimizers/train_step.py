"""The fused optimizer step with a loss scaler.

Counterpart of ``apex_tpu/optimizers/train_step.py`` ``make_train_step``
(:326). The step unscales the gradients of the scaled loss inside the
update sweep (the loss scale becomes the kernel's ``grad_scale``, as on
the reference's kernel impls, :429-430), takes ``found_inf`` from the
same sweep, skips the update on overflow, and advances the scaler::

    step = make_train_step(opt, scaler=LossScaler())
    state, scaler_state, aux = step(state, flat_grads, scaler_state)

What has no counterpart here, and is left out: the jit, buffer donation
(``donate_grads``; the update is in place already), the factory cache,
the compile-signature and step-span telemetry (``telemetry``). What is
not ported yet and raises ``NotImplementedError``: the global-norm clip
(``max_grad_norm > 0`` needs ``fused_unscale_l2norm``, a sum-of-squares
kernel), ``with_grad_norm``, ``fingerprint_every`` and ``chained``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from apex_tpu_torch.amp.scaler import LossScaler, ScalerState
from apex_tpu_torch.optimizers.fused import FlatFusedOptimizer, FlatOptState


class StepAux(NamedTuple):
    """Per-step diagnostics returned by a fused train step (the
    reference's grad-norm and fingerprint fields come with their
    kernels)."""

    found_inf: torch.Tensor                  # 0-d fp32 {0, 1}
    loss_scale: Optional[float] = None       # scale the step unscaled by


class TrainStep:
    """A fused optimizer step. Call as ``step(state, flat_grads)`` or,
    with a scaler, ``step(state, flat_grads, scaler_state)``; returns
    ``(new_state, aux)`` / ``(new_state, new_scaler_state, aux)``."""

    def __init__(self, opt: FlatFusedOptimizer,
                 scaler: Optional[LossScaler], skip_if_nonfinite: bool):
        self.opt = opt
        self.scaler = scaler
        self.skip_if_nonfinite = skip_if_nonfinite

    def __call__(self, state: FlatOptState, flat_grads: torch.Tensor,
                 scaler_state: Optional[ScalerState] = None, *, lr=None):
        if self.scaler is not None and scaler_state is None:
            raise ValueError(
                "this step was built with a scaler; pass scaler_state")
        if self.scaler is None and scaler_state is not None:
            raise ValueError(
                "this step was built without a scaler; drop scaler_state "
                "or rebuild with make_train_step(opt, scaler=...)")
        loss_scale = (scaler_state.loss_scale if scaler_state is not None
                      else None)
        _, new_state = self.opt.step_flat(
            state, flat_grads, lr=lr,
            grad_scale=1.0 if loss_scale is None else loss_scale,
            skip_if_nonfinite=self.skip_if_nonfinite)
        aux = StepAux(found_inf=new_state.found_inf, loss_scale=loss_scale)
        if scaler_state is not None:
            return (new_state,
                    self.scaler.update(scaler_state, new_state.found_inf),
                    aux)
        return new_state, aux

    def chained(self, k: int):
        raise NotImplementedError(
            "chained steps (one jitted fori_loop in the reference) have no "
            "eager counterpart yet; call the step in a loop")


def make_train_step(
    opt: FlatFusedOptimizer,
    *,
    scaler: Optional[LossScaler] = None,
    max_grad_norm: Optional[float] = None,
    skip_if_nonfinite: Optional[bool] = None,
    with_grad_norm: bool = False,
    fingerprint_every: Optional[int] = None,
) -> TrainStep:
    """Build the fused train step for ``opt``.

    - ``scaler``: a :class:`~apex_tpu_torch.amp.LossScaler`; the step
      then takes a ``ScalerState``, unscales the gradients of the scaled
      loss in the update sweep and advances the scale schedule.
    - ``skip_if_nonfinite``: gate the update on overflow; default True
      when a scaler is given, else False. A skipped step leaves the
      state's buffers and count as they were; a step that may skip
      writes new buffers (see ``optimizers/fused.py``), so a model bound
      to the old master must be bound to the new one.
    - ``max_grad_norm``, ``with_grad_norm``, ``fingerprint_every``: not
      ported yet; raise ``NotImplementedError``.
    """
    mgn = float(max_grad_norm or 0.0)
    if mgn > 0.0:
        raise NotImplementedError(
            f"max_grad_norm={mgn}: the global-norm clip needs "
            "fused_unscale_l2norm (the sum-of-squares kernels), which is "
            "not ported yet")
    if with_grad_norm:
        raise NotImplementedError(
            "with_grad_norm needs the sum-of-squares kernels, which are "
            "not ported yet")
    if fingerprint_every is not None:
        raise NotImplementedError(
            "fingerprint_every (the resilience guard's state checksums) "
            "is not ported yet")
    skip = (scaler is not None) if skip_if_nonfinite is None \
        else bool(skip_if_nonfinite)
    return TrainStep(opt, scaler, skip)


__all__ = ["StepAux", "TrainStep", "make_train_step"]
