"""Mixed precision (counterpart of ``apex_tpu/amp/``): the O0-O5
precision policies (``initialize``, ``make_scaler``) and the loss
scaler. The function-level casts (``amp.F``, ``functional.py``) and
``handle.py`` wait."""

from apex_tpu_torch.amp._amp_state import policy_scope
from apex_tpu_torch.amp.frontend import (
    OPT_LEVELS,
    AmpState,
    Properties,
    initialize,
    load_state_dict,
    make_scaler,
    master_params,
    state_dict,
)
from apex_tpu_torch.amp.scaler import LossScaler, ScalerState

__all__ = ["AmpState", "LossScaler", "OPT_LEVELS", "Properties",
           "ScalerState", "initialize", "load_state_dict", "make_scaler",
           "master_params", "policy_scope", "state_dict"]
