"""LARC: layer-wise adaptive rate clipping or scaling around a fused
optimizer.

Counterpart of ``apex_tpu/parallel/larc.py`` ``LARC`` (:67),
``larc_transform`` (:38) and ``_adaptive_ratio`` (:27): each leaf's
gradient is multiplied by ``trust * ||p|| / (||g|| + wd * ||p|| + eps) /
lr`` (``lr / lr`` where a norm is 0), capped at 1 in clip mode, and the
optimizer then takes its step with the base lr. As in the reference, the
per-leaf norms and the ratios are plain tensor code (XLA there, PyTorch
here, on the device: nothing is read on the host); the step is the
optimizer's kernel (``FusedSGD``: ``csrc/fused_sgd.cu``).
``larc_transform`` is the same scaling as a
:class:`~apex_tpu_torch.optimizers.optax_adapter.GradientTransformation`
over name -> tensor mappings, to run before any optimizer.
"""

from __future__ import annotations

from typing import Mapping

import torch

from apex_tpu_torch.multi_tensor.ops import _dev_f32, per_tensor_l2norm
from apex_tpu_torch.optimizers.fused import (
    FlatFusedOptimizer,
    FlatOptState,
    _resolve_lr,
)
from apex_tpu_torch.optimizers.optax_adapter import GradientTransformation


def adaptive_ratio(p_norm: torch.Tensor, g_norm: torch.Tensor, lr: torch.Tensor,
                   *, trust_coefficient: float, clip: bool, eps: float,
                   weight_decay: float) -> torch.Tensor:
    """The reference's ``_adaptive_ratio`` over per-leaf norms (any
    shape), ``lr`` a 0-d fp32 tensor on their device."""
    adaptive = trust_coefficient * p_norm / (g_norm + weight_decay * p_norm
                                             + eps)
    adaptive = torch.where((p_norm > 0) & (g_norm > 0), adaptive, lr)
    if clip:
        return torch.clamp(adaptive / lr, max=1.0)
    return adaptive / lr


def larc_transform(learning_rate: float, trust_coefficient: float = 0.02,
                   clip: bool = True, eps: float = 1e-8,
                   weight_decay: float = 0.0) -> GradientTransformation:
    """LARC as a gradient transformation (the reference's, :38): its
    ``update(grads, state, params)`` scales each leaf's gradient by its
    adaptive-lr / base-lr ratio (norms of the leaf, in fp32), so the
    optimizer that follows with ``learning_rate`` realises LARC. The
    state is empty."""

    def init_fn(params: Mapping[str, torch.Tensor]) -> tuple:
        return ()

    def update_fn(updates: Mapping[str, torch.Tensor], state, params=None):
        if params is None:
            raise ValueError("larc_transform requires params")
        out = {}
        for k, g in updates.items():
            p = params[k]
            r = adaptive_ratio(
                torch.linalg.vector_norm(p.float()),
                torch.linalg.vector_norm(g.float()),
                _dev_f32(learning_rate, g.device),
                trust_coefficient=trust_coefficient, clip=clip, eps=eps,
                weight_decay=weight_decay)
            out[k] = (g.float() * r).to(g.dtype)
        return out, state

    return GradientTransformation(init_fn, update_fn)


class LARC:
    """Wrap a flat fused optimizer with LARC's per-leaf learning rate
    (the reference's ``LARC(optimizer, trust_coefficient, clip, eps)``).
    ``init``, ``step`` (per-name gradients) and ``step_flat`` (a flat
    gradient, as ``PretrainStep`` gives it) as the wrapped optimizer's;
    the gradient handed to it is a scaled copy."""

    def __init__(self, optimizer: FlatFusedOptimizer,
                 trust_coefficient: float = 0.02, clip: bool = True,
                 eps: float = 1e-8):
        self.optimizer = optimizer
        self.trust_coefficient = trust_coefficient
        self.clip = clip
        self.eps = eps

    def init(self, params: Mapping[str, torch.Tensor]) -> FlatOptState:
        return self.optimizer.init(params)

    def step(self, state: FlatOptState, grads: Mapping[str, torch.Tensor],
             **kw):
        g = state.space.pack(grads, dtype=torch.float32,
                             device=state.master.device)
        return self.step_flat(state, g, **kw)

    def step_flat(self, state: FlatOptState, flat_grads: torch.Tensor, *,
                  lr=None, **kw):
        """Scale each leaf's slice of ``flat_grads`` by its ratio (a new
        buffer; the caller's is left as it was), then the wrapped
        optimizer's ``step_flat`` with the same ``lr`` and ``kw``."""
        lr = _resolve_lr(lr or self.optimizer.lr, state.count)
        dev = state.master.device
        g = flat_grads.float()
        ratio = adaptive_ratio(
            per_tensor_l2norm(state.master, state.space, plain=True,
                              norms=state.norms),
            per_tensor_l2norm(g, state.space, plain=True, norms=state.norms),
            _dev_f32(lr, dev),
            trust_coefficient=self.trust_coefficient, clip=self.clip,
            eps=self.eps,
            weight_decay=getattr(self.optimizer, "weight_decay", 0.0))
        ids = state.space.device_subtile_leaf_ids(dev).long()
        scaled = (g.view(ids.shape[0], -1) * ratio[ids][:, None]).view(-1)
        return self.optimizer.step_flat(state, scaled, lr=lr, **kw)


__all__ = ["LARC", "adaptive_ratio", "larc_transform"]
