"""``with amp.scale_loss(...)``: the reference's context-manager surface.

Counterpart of ``apex_tpu/amp/handle.py`` (:33-96). The block yields a
handle whose ``loss`` is the scaled loss (``loss.float() * scale``). In
PyTorch's idiom the caller runs the backward pass inside the block and
hands the gradients (a name -> tensor mapping, or nested tuples, lists
and dicts) to the handle; leaving the block unscales them and advances
that loss's scaler::

    with amp.scale_loss(loss, amp_state, loss_id=0) as scaled:
        scaled.loss.backward()
        scaled.grads = {n: p.grad for n, p in model.named_parameters()}
    grads = scaled.grads            # unscaled
    amp_state = scaled.amp_state    # the scaler advanced (an overflow halves)
    skip = scaled.skip              # 0-d fp32 {0, 1}: gate the step on it

``skip`` replaces the reference's patched skip-step: pass it to a fused
optimizer's ``extra_found_inf`` or gate the update on it.
``delay_unscale=True`` (gradient accumulation) leaves ``grads`` scaled
and the scaler state as it was.
"""

from __future__ import annotations

import contextlib
from typing import Any, Optional

import torch

from apex_tpu_torch.amp import _amp_state
from apex_tpu_torch.amp.frontend import AmpState, make_scaler


class _ScaledLossHandle:
    """Yielded by :func:`scale_loss`: ``loss`` is the scaled loss; set
    ``grads`` to the gradients of that loss inside the block and read the
    unscaled ones, the advanced ``amp_state`` and ``skip`` after it."""

    def __init__(self, loss, scaler, amp_state: AmpState, loss_id: int):
        self._scaler = scaler
        self._in_state = amp_state
        self._loss_id = loss_id
        self.loss = scaler.scale_loss(loss, amp_state.scalers[loss_id])
        self.grads: Optional[Any] = None
        self.amp_state: Optional[AmpState] = None
        self.skip: Optional[torch.Tensor] = None

    def _finish(self):
        state = self._in_state.scalers[self._loss_id]
        if self.grads is not None:
            self.grads, found_inf = self._scaler.unscale(self.grads, state)
        else:
            found_inf = torch.zeros((), dtype=torch.float32,
                                    device=self.loss.device)
        scalers = list(self._in_state.scalers)
        scalers[self._loss_id] = self._scaler.update(state, found_inf)
        self.amp_state = AmpState(properties=self._in_state.properties,
                                  scalers=tuple(scalers))
        self.skip = found_inf


@contextlib.contextmanager
def scale_loss(loss, amp_state: AmpState, *, loss_id: int = 0,
               delay_unscale: bool = False):
    """The scaled loss of ``loss_id``'s scaler, unscaling and advancing it
    on exit (the module docstring)."""
    if loss_id >= len(amp_state.scalers):
        raise ValueError(
            f"loss_id {loss_id} out of range for {len(amp_state.scalers)} "
            f"scalers (pass num_losses to amp.initialize)")
    handle = _ScaledLossHandle(loss, make_scaler(amp_state.properties),
                               amp_state, loss_id)
    yield handle
    if delay_unscale:
        handle.amp_state = amp_state
        handle.skip = torch.zeros((), dtype=torch.float32,
                                  device=handle.loss.device)
    else:
        handle._finish()


@contextlib.contextmanager
def disable_casts():
    """Suspend amp's casts inside the block: every ``amp.F`` wrapper
    passes its inputs through until the block ends."""
    with _amp_state.suspend_casts():
        yield


__all__ = ["scale_loss", "disable_casts"]
