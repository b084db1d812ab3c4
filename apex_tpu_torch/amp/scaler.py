"""Loss scaler.

Counterpart of ``apex_tpu/amp/scaler.py``: static or dynamic scaling
with the reference's schedule (start at 2^16, halve on overflow, floored
at ``min_loss_scale``, double after ``scale_window`` consecutive good
steps, capped at ``max_loss_scale``). The state is carried as
``ScalerState`` and advanced by :meth:`LossScaler.update`, as in the
reference; here it holds host numbers, and the scale is kept in fp32
arithmetic (numpy float32), as the reference's fp32 array is. A skipped
step is the optimizer's ``skip_if_nonfinite``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch


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
