"""The fused optimizers as a gradient transformation: an ``init`` /
``update`` pair over name -> tensor mappings.

Counterpart of ``apex_tpu/optimizers/optax_adapter.py`` ``as_optax``
(:25). The reference returns an ``optax.GradientTransformation``; the
port cannot import optax, so it keeps its own two-field
:class:`GradientTransformation` with optax's calling convention::

    tx = as_optax(FusedAdam(lr=1e-3))
    state = tx.init(params)
    updates, state = tx.update(grads, state, params)
    params = {k: p + updates[k] for k, p in params.items()}

``update`` runs the optimizer's fused step on its fp32 master and
returns ``new - old`` per parameter, taken in fp32 and cast to the
parameter's dtype (:35-43), so adding the updates (optax's
``apply_updates``) gives the fused result in fp32.
"""

from __future__ import annotations

from typing import Callable, Mapping, NamedTuple

import torch

from apex_tpu_torch.optimizers.fused import FlatFusedOptimizer, FlatOptState


class GradientTransformation(NamedTuple):
    """optax's pair: ``init(params) -> state`` and ``update(updates,
    state, params=None) -> (updates, state)``."""

    init: Callable
    update: Callable


class FusedOptaxState(NamedTuple):
    inner: FlatOptState


def as_optax(opt: FlatFusedOptimizer) -> GradientTransformation:
    """Wrap a fused optimizer as a :class:`GradientTransformation`.
    ``update`` needs ``params`` (as the reference's does)."""

    def init_fn(params: Mapping[str, torch.Tensor]) -> FusedOptaxState:
        return FusedOptaxState(inner=opt.init(params))

    def update_fn(updates: Mapping[str, torch.Tensor],
                  state: FusedOptaxState, params=None):
        if params is None:
            raise ValueError(
                "as_optax(...) requires update(..., params=params)")
        new_params, inner = opt.step(state.inner, updates)
        deltas = {k: (new_params[k].float() - p.float()).to(p.dtype)
                  for k, p in params.items()}
        return deltas, FusedOptaxState(inner=inner)

    return GradientTransformation(init_fn, update_fn)


__all__ = ["FusedOptaxState", "GradientTransformation", "as_optax"]
