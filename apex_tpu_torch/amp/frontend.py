"""amp opt levels and ``initialize``: precision policies.

Counterpart of ``apex_tpu/amp/frontend.py`` (``Properties`` :39,
``OPT_LEVELS`` :66-74, ``initialize`` :115, ``make_scaler`` :183,
``state_dict`` / ``load_state_dict`` :198-222, ``master_params`` :225)
over name -> tensor mappings (``dict(model.named_parameters())``), as
the port's optimizers take their parameters:

  O0  fp32 everywhere, no scaling
  O1  mixed: whitelist ops in fp16, dynamic scale
  O2  cast model fp16, fp32 master, dynamic scale
  O3  pure fp16
  O4  mixed bf16, no loss scaling
  O5  cast model bf16, fp32 master

``initialize`` returns the cast parameters (BatchNorm's kept fp32 by
name under ``keep_batchnorm_fp32``), the optimizers' states built from
the original fp32 parameters (the master weights), and an ``AmpState``
with one loss scaler state per loss. The port's models hold fp32
parameters bound to the optimizer's master and cast them to their
config's compute dtype at use (``ResNetConfig(dtype=torch.float16)`` is
O2's model), so a training step takes the optimizer state and the
scaler, not the cast mapping.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, Iterator, Mapping, NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.amp import _amp_state
from apex_tpu_torch.amp.scaler import LossScaler, ScalerState

# parameters that stay fp32 under keep_batchnorm_fp32, matched against
# the parameter's name ('.'-joined module path; '/' as the reference's)
_BN_PATTERN = re.compile(
    r"(batch_?norm|(^|[./_])bn\d*([./_]|$)|group_?norm)", re.I)


@dataclasses.dataclass(frozen=True)
class Properties:
    """Validated option struct."""

    opt_level: str
    cast_model_type: Optional[torch.dtype]   # dtype params are cast to
    compute_dtype: Optional[torch.dtype]     # dtype whitelist ops run in
    keep_batchnorm_fp32: bool
    master_weights: bool
    loss_scale: Any                          # "dynamic" | float | None

    def __post_init__(self):
        if self.cast_model_type is not None and self.compute_dtype is not None:
            raise ValueError(
                "cast_model_type and compute_dtype are mutually exclusive "
                "(patch-style vs cast-style opt levels)")


def _props(opt_level, cast=None, compute=None, keep_bn=False, master=False,
           loss_scale=None) -> Properties:
    return Properties(opt_level=opt_level, cast_model_type=cast,
                      compute_dtype=compute, keep_batchnorm_fp32=keep_bn,
                      master_weights=master, loss_scale=loss_scale)


OPT_LEVELS: Dict[str, Properties] = {
    "O0": _props("O0"),
    "O1": _props("O1", compute=torch.float16, loss_scale="dynamic"),
    "O2": _props("O2", cast=torch.float16, keep_bn=True, master=True,
                 loss_scale="dynamic"),
    "O3": _props("O3", cast=torch.float16),
    "O4": _props("O4", compute=torch.bfloat16),
    "O5": _props("O5", cast=torch.bfloat16, keep_bn=True, master=True),
}


class AmpState(NamedTuple):
    """Carried amp state: one scaler state per loss."""

    properties: Properties
    scalers: Tuple[ScalerState, ...]


def _cast_params(params: Mapping[str, torch.Tensor], dtype,
                 keep_batchnorm_fp32: bool) -> Dict[str, torch.Tensor]:
    """Floating-point tensors cast to ``dtype``, BatchNorm's (by name)
    to fp32 under ``keep_batchnorm_fp32``; anything else as it is."""
    out = {}
    for name, t in params.items():
        t = torch.as_tensor(t)
        if t.is_floating_point():
            keep = keep_batchnorm_fp32 and _BN_PATTERN.search(name)
            t = t.detach().to(torch.float32 if keep else dtype)
        out[name] = t
    return out


def initialize(
    params: Mapping[str, torch.Tensor],
    optimizers=None,
    opt_level: str = "O1",
    num_losses: int = 1,
    cast_model_type=None,
    keep_batchnorm_fp32=None,
    master_weights=None,
    loss_scale=None,
    min_loss_scale=None,
    max_loss_scale=2.0 ** 24,
    allow_banned=False,
):
    """Configure mixed precision. Returns ``(cast_params, amp_state)``
    and, with ``optimizers`` (one flat fused optimizer or a list), their
    states built from the fp32 ``params`` in between: ``(cast_params,
    opt_states, amp_state)``."""
    if opt_level not in OPT_LEVELS:
        raise ValueError(f"Unexpected opt_level {opt_level!r}; expected "
                         "O0..O5")
    base = OPT_LEVELS[opt_level]
    props = Properties(
        opt_level=opt_level,
        cast_model_type=(cast_model_type if cast_model_type is not None
                         else base.cast_model_type),
        compute_dtype=base.compute_dtype,
        keep_batchnorm_fp32=(keep_batchnorm_fp32
                             if keep_batchnorm_fp32 is not None
                             else base.keep_batchnorm_fp32),
        master_weights=(master_weights if master_weights is not None
                        else base.master_weights),
        loss_scale=loss_scale if loss_scale is not None else base.loss_scale,
    )
    _amp_state.set_active(props)
    _amp_state.allow_banned = bool(allow_banned)

    cast_params = dict(params)
    if props.cast_model_type is not None:
        cast_params = _cast_params(params, props.cast_model_type,
                                   props.keep_batchnorm_fp32)
    scaler = make_scaler(props, min_loss_scale=min_loss_scale,
                         max_loss_scale=max_loss_scale)
    amp_state = AmpState(properties=props,
                         scalers=tuple(scaler.init()
                                       for _ in range(num_losses)))
    if optimizers is None:
        return cast_params, amp_state
    single = not isinstance(optimizers, (list, tuple))
    opts = [optimizers] if single else list(optimizers)
    opt_states = [o.init(params) for o in opts]
    return cast_params, (opt_states[0] if single else opt_states), amp_state


def make_scaler(props: Properties, min_loss_scale=None,
                max_loss_scale=2.0 ** 24) -> LossScaler:
    """The LossScaler a Properties object implies (a static 1 when it
    asks for no scaling)."""
    if props.loss_scale is None:
        return LossScaler(loss_scale=1.0)
    return LossScaler(loss_scale=props.loss_scale,
                      min_loss_scale=min_loss_scale,
                      max_loss_scale=max_loss_scale)


def state_dict(amp_state: AmpState) -> Dict[str, Any]:
    return {f"loss_scaler{i}": {"loss_scale": float(s.loss_scale),
                                "unskipped": int(s.unskipped)}
            for i, s in enumerate(amp_state.scalers)}


def load_state_dict(amp_state: AmpState, d: Mapping[str, Any]) -> AmpState:
    scalers = []
    for i, s in enumerate(amp_state.scalers):
        key = f"loss_scaler{i}"
        if key in d:
            scalers.append(LossScaler().load_state_dict(
                {"loss_scale": d[key]["loss_scale"],
                 "unskipped": d[key]["unskipped"]}))
        else:
            scalers.append(s)
    return AmpState(properties=amp_state.properties, scalers=tuple(scalers))


def master_params(optimizer, state) -> Iterator[torch.Tensor]:
    """The fp32 master weights of a fused optimizer's state, leaf by
    leaf in the flat layout's order."""
    return iter(optimizer.master_params(state).values())


__all__ = ["AmpState", "OPT_LEVELS", "Properties", "initialize",
           "load_state_dict", "make_scaler", "master_params", "state_dict"]
