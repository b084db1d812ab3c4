"""Loss scaler.

Counterpart of ``apex_tpu/amp/scaler.py``: static or dynamic scaling
with the reference's schedule (start at 2^16, halve on overflow, floored
at ``min_loss_scale``, double after ``scale_window`` consecutive good
steps, capped at ``max_loss_scale``). The state is carried as
``ScalerState`` and advanced by :meth:`LossScaler.update`, as in the
reference; here it holds host numbers, and the scale is kept in fp32
arithmetic (numpy float32), as the reference's fp32 array is. A skipped
step is the optimizer's ``skip_if_nonfinite``. ``unscale`` takes the
gradients of an unfused loop (a name -> tensor mapping, or nested
tuples, lists and dicts of tensors) and stays on the device.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch.amp.functional import _leaves, _tree_map


class ScalerState(NamedTuple):
    """Carried loss-scale state."""

    loss_scale: float      # an fp32 value
    unskipped: int         # consecutive unskipped steps
    found_inf: float       # {0, 1} from the last update


def _f32(x) -> float:
    return float(np.float32(x))


class LossScaler:
    """Static or dynamic loss scaler (``loss_scale="dynamic"`` for the
    dynamic schedule, a number for a static scale)."""

    def __init__(self, loss_scale="dynamic", init_scale: float = 2.0 ** 16,
                 scale_factor: float = 2.0, scale_window: int = 2000,
                 min_loss_scale: Optional[float] = None,
                 max_loss_scale: float = 2.0 ** 24):
        self.dynamic = loss_scale == "dynamic"
        self._static_scale = 1.0 if self.dynamic else float(loss_scale)
        self.init_scale = init_scale if self.dynamic else self._static_scale
        self.scale_factor = scale_factor
        self.scale_window = scale_window
        self.min_loss_scale = min_loss_scale
        self.max_loss_scale = max_loss_scale

    def init(self) -> ScalerState:
        return ScalerState(loss_scale=_f32(self.init_scale), unskipped=0,
                           found_inf=0.0)

    def scale_loss(self, loss: torch.Tensor,
                   state: ScalerState) -> torch.Tensor:
        """``loss.float() * scale``."""
        return loss.float() * state.loss_scale

    def unscale(self, grads: Any, state: ScalerState
                ) -> Tuple[Any, torch.Tensor]:
        """The gradients of the scaled loss unscaled, and ``found_inf``.

        Each leaf ``g`` becomes ``(g.float() * inv).to(g.dtype)``, ``inv``
        the fp32 reciprocal of the scale as a 0-d tensor on the leaves'
        device (the reference's ``1.0 / loss_scale`` in fp32);
        ``found_inf`` is a 0-d fp32 device tensor, 1 where any unscaled
        value is inf or nan. No value is read on the host. (The fused
        optimizers unscale inside their update through ``grad_scale``.)
        """
        leaves = [g for g in _leaves(grads) if isinstance(g, torch.Tensor)]
        dev = leaves[0].device if leaves else torch.device("cpu")
        one = torch.ones((), dtype=torch.float32, device=dev)
        inv = one / torch.full((), state.loss_scale, dtype=torch.float32,
                               device=dev)
        unscaled = _tree_map(lambda g: (g.float() * inv).to(g.dtype)
                             if isinstance(g, torch.Tensor) else g, grads)
        finite = torch.ones((), dtype=torch.bool, device=dev)
        for g in _leaves(unscaled):
            if isinstance(g, torch.Tensor):
                finite = finite & torch.isfinite(g).all()
        return unscaled, torch.where(finite, 0.0, one)

    def update(self, state: ScalerState, found_inf) -> ScalerState:
        """Advance the state after a step attempt (the reference's
        ``update`` :83)."""
        found = float(found_inf)
        if not self.dynamic:
            return ScalerState(state.loss_scale,
                               state.unskipped + (0 if found > 0 else 1),
                               found)
        scale = np.float32(state.loss_scale)
        if found > 0:
            new = scale / np.float32(self.scale_factor)
            if self.min_loss_scale is not None:
                new = max(new, np.float32(self.min_loss_scale))
            return ScalerState(_f32(new), 0, found)
        unskipped = state.unskipped + 1
        if unskipped >= self.scale_window:
            grown = min(scale * np.float32(self.scale_factor),
                        np.float32(self.max_loss_scale))
            return ScalerState(_f32(grown), 0, found)
        return ScalerState(_f32(scale), unskipped, found)

    def state_dict(self, state: ScalerState) -> Dict[str, Any]:
        return {"loss_scale": float(state.loss_scale),
                "unskipped": int(state.unskipped),
                "found_inf": float(state.found_inf)}

    def load_state_dict(self, d: Mapping[str, Any]) -> ScalerState:
        return ScalerState(loss_scale=_f32(d["loss_scale"]),
                           unskipped=int(d["unskipped"]),
                           found_inf=float(d.get("found_inf", 0.0)))


__all__ = ["LossScaler", "ScalerState"]
