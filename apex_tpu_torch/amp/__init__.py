"""Mixed precision (counterpart of ``apex_tpu/amp/``): the O0-O5
precision policies (``initialize``, ``make_scaler``), the loss scaler,
``scale_loss`` and ``disable_casts``, the cast decorators
(``half_function``, ``compute_cast``, ``register_*``), the shipped op
lists and ``amp.F``, the functional namespace with the lists applied."""

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
from apex_tpu_torch.amp.functional import (
    bfloat16_function,
    compute_cast,
    float_function,
    half_function,
    promote_function,
    register_bfloat16_function,
    register_float_function,
    register_half_function,
    register_promote_function,
)
from apex_tpu_torch.amp.handle import disable_casts, scale_loss
from apex_tpu_torch.amp.scaler import LossScaler, ScalerState
from apex_tpu_torch.amp import lists
from apex_tpu_torch.amp import nn_functional as F
from apex_tpu_torch.amp._amp_state import policy_scope

__all__ = [
    "scale_loss",
    "disable_casts",
    "OPT_LEVELS",
    "AmpState",
    "Properties",
    "initialize",
    "state_dict",
    "load_state_dict",
    "make_scaler",
    "LossScaler",
    "ScalerState",
    "half_function",
    "bfloat16_function",
    "float_function",
    "promote_function",
    "compute_cast",
    "register_half_function",
    "register_bfloat16_function",
    "register_float_function",
    "register_promote_function",
    "master_params",
    "lists",
    "F",
    "policy_scope",
]
