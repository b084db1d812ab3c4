"""Legacy fp16 utilities: the gen-1 API beside amp.

Counterpart of ``apex_tpu/fp16_utils/__init__.py`` (:26-178), over name ->
tensor mappings (``dict(model.named_parameters())``) and the port's flat
fused optimizers. Every function is value -> value; the fp32 master copy
lives where the fused optimizers keep it, in their flat master buffer,
so :class:`FP16_Optimizer` adds only the loss-scale choreography: scale
the loss, unscale inside the fused update (``grad_scale``), skip the
update on overflow (dynamic scaling only), advance the scale::

    opt = FP16_Optimizer(FusedAdam(lr=1e-4), dynamic_loss_scale=True)
    state = opt.init(dict(model.named_parameters()))
    opt.scale_loss(loss, state).backward()
    params, state = opt.step(state, {n: p.grad for n, p in ...})

``step`` packs the gradients and calls ``opt.train_step``
(``make_train_step`` over the optimizer and the scaler), which a
``PretrainStep`` also takes::

    step = PretrainStep(model, opt.optimizer, train_step=opt.train_step)
    state, scaler_state, loss = step(state, *batch, scaler_state=ss)
"""

from __future__ import annotations

from typing import Any, Mapping, NamedTuple, Optional, Tuple

import torch

from apex_tpu_torch.amp.frontend import _BN_PATTERN, _cast_params
from apex_tpu_torch.amp.scaler import LossScaler, ScalerState
from apex_tpu_torch.optimizers.train_step import make_train_step


def tofp16(params: Mapping[str, torch.Tensor]) -> dict:
    """Every float tensor cast to fp16."""
    return _cast_params(params, torch.float16, keep_batchnorm_fp32=False)


def bn_convert_float(params: Mapping[str, torch.Tensor]) -> dict:
    """The norm parameters (by name, amp's ``_BN_PATTERN``: batch norm,
    ``bn``, group norm) back to fp32; the rest as they are."""
    return {n: t.detach().float()
            if t.is_floating_point() and _BN_PATTERN.search(n) else t
            for n, t in params.items()}


def network_to_half(params: Mapping[str, torch.Tensor]) -> dict:
    """fp16 everywhere except the norm parameters."""
    return _cast_params(params, torch.float16, keep_batchnorm_fp32=True)


def _to_fp32(params: Mapping[str, torch.Tensor]) -> dict:
    return _cast_params(params, torch.float32, keep_batchnorm_fp32=False)


def prep_param_lists(params: Mapping[str, torch.Tensor]
                     ) -> Tuple[dict, dict]:
    """``(model_params, master_params)``: the parameters as given and an
    fp32 copy."""
    return dict(params), {n: t.detach().float().clone()
                          if t.is_floating_point() else t
                          for n, t in params.items()}


def model_grads_to_master_grads(model_grads: Mapping[str, torch.Tensor]
                                ) -> dict:
    """The model's (fp16) gradients in fp32."""
    return _to_fp32(model_grads)


def master_params_to_model_params(master_params: Mapping[str, torch.Tensor],
                                  model_params: Mapping[str, torch.Tensor]
                                  ) -> dict:
    """The updated fp32 masters in each model parameter's dtype."""
    return {n: m.to(model_params[n].dtype) for n, m in master_params.items()}


def to_python_float(t) -> float:
    return float(t)


class DynamicLossScaler(LossScaler):
    """The gen-1 dynamic scaler: 2^32 at the start, window 1000, and no
    growth cap (a cap below the start would snap the scale down on
    growth)."""

    def __init__(self, init_scale=2.0 ** 32, scale_factor=2.0,
                 scale_window=1000):
        super().__init__("dynamic", init_scale=init_scale,
                         scale_factor=scale_factor,
                         scale_window=scale_window,
                         max_loss_scale=float("inf"))


class FP16State(NamedTuple):
    opt_state: Any
    scaler_state: ScalerState


class FP16_Optimizer:
    """A fused optimizer under the gen-1 loss scaling: a static scale
    (``static_loss_scale``; no overflow check, as the reference's) or the
    :class:`DynamicLossScaler` (``dynamic_loss_scale=True``,
    ``dynamic_loss_args`` its keywords)."""

    def __init__(self, optimizer, static_loss_scale: float = 1.0,
                 dynamic_loss_scale: bool = False,
                 dynamic_loss_args: Optional[dict] = None,
                 verbose: bool = False):
        self.optimizer = optimizer
        if dynamic_loss_scale:
            self.loss_scaler = DynamicLossScaler(**(dynamic_loss_args or {}))
        else:
            self.loss_scaler = LossScaler(static_loss_scale)
        self.verbose = verbose
        self.train_step = make_train_step(
            optimizer, scaler=self.loss_scaler,
            skip_if_nonfinite=self.loss_scaler.dynamic)

    def init(self, params: Mapping[str, torch.Tensor]) -> FP16State:
        return FP16State(self.optimizer.init(params),
                         self.loss_scaler.init())

    def scale_loss(self, loss: torch.Tensor, state: FP16State
                   ) -> torch.Tensor:
        """``loss.float() * loss_scale`` (the reference's ``backward``
        runs the backward pass of this)."""
        return self.loss_scaler.scale_loss(loss, state.scaler_state)

    def step(self, state: FP16State, grads: Mapping[str, torch.Tensor],
             **kw) -> Tuple[dict, FP16State]:
        """Unscale inside the fused update, skip it on overflow (dynamic
        scaling only) and advance the scaler. ``grads``: the gradients of
        the scaled loss by parameter name. Returns ``(params,
        new_state)``."""
        opt_state = state.opt_state
        g = opt_state.space.pack(grads, dtype=torch.float32,
                                 device=opt_state.master.device)
        opt_state, scaler_state, _ = self.train_step(
            opt_state, g, state.scaler_state, **kw)
        return (opt_state.space.unpack(opt_state.master),
                FP16State(opt_state, scaler_state))

    def loss_scale(self, state: FP16State) -> float:
        """The current loss scale (the reference's property; it takes
        the state here)."""
        return state.scaler_state.loss_scale

    def state_dict(self, state: FP16State) -> dict:
        return {"opt_state": self.optimizer.state_dict(state.opt_state),
                "loss_scaler": self.loss_scaler.state_dict(
                    state.scaler_state)}

    def load_state_dict(self, state: FP16State, d) -> FP16State:
        """``d`` into ``state``'s buffers (the optimizer's flat layout
        comes from ``state``)."""
        return FP16State(
            self.optimizer.load_state_dict(state.opt_state, d["opt_state"]),
            self.loss_scaler.load_state_dict(d["loss_scaler"]))


__all__ = [
    "DynamicLossScaler",
    "FP16_Optimizer",
    "FP16State",
    "LossScaler",
    "bn_convert_float",
    "master_params_to_model_params",
    "model_grads_to_master_grads",
    "network_to_half",
    "prep_param_lists",
    "to_python_float",
    "tofp16",
]
