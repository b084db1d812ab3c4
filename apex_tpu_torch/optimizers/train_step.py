"""The fused optimizer step with a loss scaler and the global-norm clip.

Counterpart of ``apex_tpu/optimizers/train_step.py`` ``make_train_step``
(:326), following the reference's kernel-impl branches (:393-470). The
step unscales the gradients of the scaled loss inside the update sweep
(the loss scale becomes the kernel's ``grad_scale``), takes
``found_inf`` from the same sweep, skips the update on overflow, and
advances the scaler::

    step = make_train_step(opt, scaler=LossScaler(), max_grad_norm=1.0)
    state, scaler_state, aux = step(state, flat_grads, scaler_state)

The global-norm clip reads the gradient once (``fused_unscale_l2norm``,
kernel ``sumsq_scaled``); FusedLAMB with its own ``max_grad_norm`` takes
that norm through ``global_grad_norm`` (its in-update clip), any other
optimizer gets the clip factor folded into ``grad_scale``. The norm and
the clip factor stay on the device. ``with_grad_norm`` reports the
global and per-tensor norms of the unscaled gradient (FusedLAMB reduces
them inside its update; other optimizers pay the one norm read). On a
state that is one rank's part of the model (``FlatOptState.norms``, a
tensor or pipe shard) every norm is the whole model's, summed over the
ranks by ``parallel.sharded_norms``.

What has no counterpart here, and is left out: the jit, buffer donation
(``donate_grads``; the update is in place already), the factory cache,
the compile-signature and step-span telemetry (``telemetry``). What is
not ported yet and raises ``NotImplementedError``: ``fingerprint_every``
and ``chained``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from apex_tpu_torch.amp.scaler import LossScaler, ScalerState
from apex_tpu_torch.multi_tensor.engine import sqrt_rn
from apex_tpu_torch.multi_tensor.ops import _dev_f32, fused_unscale_l2norm
from apex_tpu_torch.optimizers.fused import (
    FlatFusedOptimizer,
    FlatOptState,
    FusedLAMB,
)


class StepAux(NamedTuple):
    """Per-step diagnostics returned by a fused train step (the
    reference's fingerprint field comes with its kernel)."""

    found_inf: torch.Tensor                          # 0-d fp32 {0, 1}
    grad_norm: Optional[torch.Tensor] = None         # unscaled global L2
    grad_norm_per_tensor: Optional[torch.Tensor] = None
    loss_scale: Optional[float] = None               # scale unscaled by


class TrainStep:
    """A fused optimizer step. Call as ``step(state, flat_grads)`` or,
    with a scaler, ``step(state, flat_grads, scaler_state)``; returns
    ``(new_state, aux)`` / ``(new_state, new_scaler_state, aux)``."""

    def __init__(self, opt: FlatFusedOptimizer,
                 scaler: Optional[LossScaler], skip_if_nonfinite: bool,
                 max_grad_norm: float = 0.0, internal_clip: bool = False,
                 with_grad_norm: bool = False):
        self.opt = opt
        self.scaler = scaler
        self.skip_if_nonfinite = skip_if_nonfinite
        self.max_grad_norm = max_grad_norm
        self.internal_clip = internal_clip
        self.generic_clip = max_grad_norm > 0.0 and not internal_clip
        self.with_grad_norm = with_grad_norm
        self.is_lamb = isinstance(opt, FusedLAMB)

    def __call__(self, state: FlatOptState, flat_grads: torch.Tensor,
                 scaler_state: Optional[ScalerState] = None, *, lr=None):
        if self.scaler is not None and scaler_state is None:
            raise ValueError(
                "this step was built with a scaler; pass scaler_state")
        if self.scaler is None and scaler_state is not None:
            raise ValueError(
                "this step was built without a scaler; drop scaler_state "
                "or rebuild with make_train_step(opt, scaler=...)")
        g = flat_grads.float()
        dev = g.device
        loss_scale = (scaler_state.loss_scale if scaler_state is not None
                      else None)
        grad_scale = 1.0 if loss_scale is None else loss_scale
        extra_found = ggn = unscaled_norm = None
        lamb_norms = self.with_grad_norm and self.is_lamb
        if self.internal_clip or self.generic_clip or (
                self.with_grad_norm and not self.is_lamb):
            # one read of g; the unscale is scalar work on the device
            if state.norms is not None:
                # one rank's part of the model: the whole model's norm
                total = state.norms.global_sumsq(g)
                norm = sqrt_rn(total)
                extra_found = (~torch.isfinite(total)).to(torch.float32)
            else:
                norm, extra_found = fused_unscale_l2norm(g, inv_scale=1.0)
            unscaled_norm = (norm / _dev_f32(loss_scale, dev)
                             if loss_scale is not None else norm)
            if self.internal_clip:
                ggn = norm          # FusedLAMB divides by grad_scale itself
            elif self.generic_clip:
                clip = torch.maximum(
                    unscaled_norm / _dev_f32(self.max_grad_norm, dev),
                    _dev_f32(1.0, dev))
                grad_scale = (_dev_f32(grad_scale, dev) * clip
                              if loss_scale is not None else clip)
        outs = self.opt.step_flat(
            state, g, lr=lr, grad_scale=grad_scale,
            skip_if_nonfinite=self.skip_if_nonfinite, global_grad_norm=ggn,
            extra_found_inf=extra_found, with_grad_norm=lamb_norms)
        new_state = outs[1]
        gnorm_pt = None
        if lamb_norms:
            # the kernels reduce the gradient as given: under a scaler,
            # the scaled one
            gnorm_pt = outs[2]
            if loss_scale is not None:
                gnorm_pt = gnorm_pt / _dev_f32(loss_scale, dev)
            sq = gnorm_pt * gnorm_pt
            unscaled_norm = sqrt_rn(torch.sum(sq) if state.norms is None
                                    else state.norms.total_sumsq(sq))
        aux = StepAux(found_inf=new_state.found_inf, grad_norm=unscaled_norm,
                      grad_norm_per_tensor=gnorm_pt, loss_scale=loss_scale)
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
    - ``max_grad_norm``: the global-norm clip. Default: the optimizer's
      own ``max_grad_norm`` (FusedLAMB) or off. FusedLAMB takes the
      norm into its own clip; other optimizers get the clip factor
      folded into ``grad_scale``. A value that conflicts with a
      FusedLAMB's own clip raises.
    - ``skip_if_nonfinite``: gate the update on overflow; default True
      when a scaler is given, else False. A skipped step leaves the
      state's buffers and count as they were; a step that may skip
      writes new buffers (see ``optimizers/fused.py``), so a model bound
      to the old master must be bound to the new one.
    - ``with_grad_norm``: report ``aux.grad_norm`` and
      ``aux.grad_norm_per_tensor`` (FusedLAMB; others report the global
      norm).
    - ``fingerprint_every``: not ported yet; raises.
    """
    if fingerprint_every is not None:
        raise NotImplementedError(
            "fingerprint_every (the resilience guard's state checksums) "
            "is not ported yet")
    is_lamb = isinstance(opt, FusedLAMB)
    opt_mgn = float(getattr(opt, "max_grad_norm", 0.0) or 0.0)
    mgn = opt_mgn if max_grad_norm is None else float(max_grad_norm)
    if is_lamb and opt_mgn > 0.0 and mgn != opt_mgn:
        raise ValueError(
            f"max_grad_norm={mgn} conflicts with the optimizer's own "
            f"max_grad_norm={opt_mgn}; configure the clip in ONE place")
    skip = (scaler is not None) if skip_if_nonfinite is None \
        else bool(skip_if_nonfinite)
    return TrainStep(opt, scaler, skip, max_grad_norm=mgn,
                     internal_clip=is_lamb and opt_mgn > 0.0,
                     with_grad_norm=with_grad_norm)


__all__ = ["StepAux", "TrainStep", "make_train_step"]
