"""Mixed-precision helpers (counterpart of ``apex_tpu/amp/``). Ported so
far: the loss scaler. The O0-O5 precision policies wait."""

from apex_tpu_torch.amp.scaler import LossScaler, ScalerState

__all__ = ["LossScaler", "ScalerState"]
