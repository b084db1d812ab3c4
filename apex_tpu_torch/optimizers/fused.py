"""Fused optimizers over the flat parameter space.

Counterpart of ``apex_tpu/optimizers/fused.py`` (``FlatOptState``,
``FlatFusedOptimizer``, ``FusedAdam``). The state holds the fp32 master
copy of every parameter and the optimizer's slots as flat buffers laid
out by a :class:`~apex_tpu_torch.multi_tensor.FlatSpace`, and one fused
kernel sweep updates them all.

Where the reference is functional (new buffers each step, donated by
the jitted step), the port updates in place: ``step_flat`` overwrites
the state's master and slots, so parameters bound as views into the
master (``FlatSpace.bind``) change with it, and the returned state holds
the same buffers. The exception is ``skip_if_nonfinite``: the kernel
has written its outputs before it knows whether a gradient was inf or
nan, so a step that may be skipped writes new buffers, reads the
``found_inf`` flag on the host once, and takes the new buffers only
when it is 0 — a skipped step leaves master, slots and count exactly as
they were (the reference's ``lax.cond``, :246-255). That costs a second
master + slots worth of memory during the step and one host
synchronisation; the traffic is the in-place sweep's.

The step count is a host integer (the reference carries an int32 on
the device): the bias corrections are computed on the host from it, in
fp32 as the reference computes them. ``found_inf`` stays a 0-d fp32
tensor on the device. FusedLAMB and the other optimizers wait for their
kernels; a bf16 master with stochastic rounding raises.
"""

from __future__ import annotations

from typing import (Any, Callable, Dict, Mapping, NamedTuple, Optional,
                    Tuple, Union)

import torch

from apex_tpu_torch.multi_tensor import FlatSpace, fused_adam_update

Schedule = Union[float, Callable[[int], float]]


class FlatOptState(NamedTuple):
    """State of a flat-space fused optimizer."""

    space: FlatSpace
    master: torch.Tensor            # fp32 flat master params
    slots: Dict[str, torch.Tensor]
    count: int                      # successful (unskipped) steps
    found_inf: torch.Tensor         # 0-d fp32 {0, 1} from the last step


def _resolve_lr(lr: Schedule, count: int):
    return lr(count) if callable(lr) else lr


class FlatFusedOptimizer:
    """Base: one fused kernel sweep over the flat buffers."""

    def __init__(self, lr: Schedule, *, master_dtype=torch.float32,
                 stochastic_rounding: bool = False):
        if stochastic_rounding or master_dtype != torch.float32:
            raise NotImplementedError(
                "a reduced-precision master with stochastic rounding is "
                "not ported yet; the master is fp32")
        self.lr = lr
        self.master_dtype = master_dtype

    # -- subclass hooks ----------------------------------------------------

    def _init_slots(self, master: torch.Tensor) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def _update(self, state: FlatOptState, g: torch.Tensor, lr,
                grad_scale, in_place: bool
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                           torch.Tensor]:
        """Return (new_master, new_slots, found_inf)."""
        raise NotImplementedError

    # -- public API --------------------------------------------------------

    def init(self, params: Mapping[str, torch.Tensor]) -> FlatOptState:
        """The state for ``params`` (a name -> tensor mapping, e.g.
        ``dict(model.named_parameters())``), on the params' device."""
        space = FlatSpace.create(params)
        master = space.pack(params, dtype=self.master_dtype)
        return FlatOptState(
            space=space, master=master, slots=self._init_slots(master),
            count=0, found_inf=torch.zeros((), dtype=torch.float32,
                                           device=master.device))

    def step(self, state: FlatOptState, grads: Mapping[str, torch.Tensor],
             **kw) -> Tuple[Dict[str, torch.Tensor], FlatOptState]:
        """:meth:`step_flat` for gradients given per parameter name
        (packed into the flat layout first: one extra read and write of
        the gradients)."""
        g = state.space.pack(grads, dtype=torch.float32,
                             device=state.master.device)
        return self.step_flat(state, g, **kw)

    def step_flat(
        self,
        state: FlatOptState,
        flat_grads: torch.Tensor,
        *,
        lr: Optional[Schedule] = None,
        grad_scale=1.0,
        skip_if_nonfinite: bool = False,
        global_grad_norm=None,
        extra_found_inf=None,
        with_grad_norm: bool = False,
    ) -> Tuple[Dict[str, torch.Tensor], FlatOptState]:
        """One optimizer step on gradients already in the flat layout.

        Returns ``(params, new_state)``, ``params`` being views of the
        new master by name. With ``skip_if_nonfinite`` the update is
        discarded when any gradient (or ``extra_found_inf``) is
        non-finite, and the count then counts only unskipped steps.
        ``global_grad_norm`` and ``with_grad_norm`` serve FusedLAMB's
        in-kernel clip and norms, not ported yet: they raise."""
        if global_grad_norm is not None or with_grad_norm:
            raise NotImplementedError(
                "global_grad_norm / with_grad_norm belong to FusedLAMB, "
                "which is not ported yet")
        g = flat_grads
        if g.shape != state.master.shape:
            raise ValueError(f"flat_grads shape {tuple(g.shape)} != master "
                             f"{tuple(state.master.shape)}")
        g = g.float()
        lr_val = _resolve_lr(lr if lr is not None else self.lr, state.count)
        new_master, new_slots, found = self._update(
            state, g, lr_val, grad_scale, in_place=not skip_if_nonfinite)
        if extra_found_inf is not None:
            found = torch.maximum(found, torch.as_tensor(
                extra_found_inf, dtype=torch.float32, device=found.device))
        count = state.count + 1
        if skip_if_nonfinite and float(found) > 0:
            new_master, new_slots, count = (state.master, state.slots,
                                            state.count)
        new_state = FlatOptState(space=state.space, master=new_master,
                                 slots=new_slots, count=count,
                                 found_inf=found)
        return state.space.unpack(new_master), new_state

    def state_dict(self, state: FlatOptState) -> Dict[str, Any]:
        return {"master": state.master, "slots": dict(state.slots),
                "count": state.count, "found_inf": state.found_inf}

    def load_state_dict(self, state: FlatOptState,
                        d: Mapping[str, Any]) -> FlatOptState:
        """``d`` copied into ``state``'s buffers in place (so views bound
        to the master stay valid); returns the updated state."""
        with torch.no_grad():
            state.master.copy_(torch.as_tensor(d["master"]))
            for k, buf in state.slots.items():
                buf.copy_(torch.as_tensor(d["slots"][k]))
        return state._replace(
            count=int(d["count"]),
            found_inf=torch.as_tensor(d["found_inf"], dtype=torch.float32,
                                      device=state.master.device).clone())


class FusedAdam(FlatFusedOptimizer):
    """Adam / AdamW in one fused kernel (the reference's ``FusedAdam``)."""

    def __init__(self, lr=1e-3, bias_correction=True, betas=(0.9, 0.999),
                 eps=1e-8, adam_w_mode=True, weight_decay=0.0, *,
                 master_dtype=torch.float32, stochastic_rounding=False):
        super().__init__(lr, master_dtype=master_dtype,
                         stochastic_rounding=stochastic_rounding)
        self.bias_correction = bias_correction
        self.betas = betas
        self.eps = eps
        self.adam_w_mode = adam_w_mode
        self.weight_decay = weight_decay

    def _init_slots(self, master):
        return {"m": torch.zeros_like(master), "v": torch.zeros_like(master)}

    def _update(self, state, g, lr, grad_scale, in_place):
        p2, m2, v2, found = fused_adam_update(
            state.master, state.slots["m"], state.slots["v"], g,
            lr=lr, beta1=self.betas[0], beta2=self.betas[1], eps=self.eps,
            step=state.count + 1, adam_w_mode=self.adam_w_mode,
            bias_correction=self.bias_correction,
            weight_decay=self.weight_decay, grad_scale=grad_scale,
            in_place=in_place)
        return p2, {"m": m2, "v": v2}, found


class FusedLAMB(FlatFusedOptimizer):
    """Not ported yet: LAMB needs the segment-resident one-pass kernel
    and the sum-of-squares kernels of its clip."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "FusedLAMB is not ported yet: it needs the one-pass LAMB "
            "kernel (multi_tensor/segmented.py) and the sum-of-squares "
            "kernels of its global-norm clip; use FusedAdam")


__all__ = ["FlatFusedOptimizer", "FlatOptState", "FusedAdam", "FusedLAMB"]
