"""Fused global-norm gradient clipping.

Counterpart of ``apex_tpu/contrib/clip_grad/__init__.py``
``clip_grad_norm_`` (:24). For the 2-norm: the global L2 norm
(``multi_tensor_l2norm``, kernel ``sumsq``), the factor ``min(max_norm /
(norm + 1e-6), 1)`` as a 0-d fp32 tensor on the device, and
``multi_tensor_scale`` by it (kernel ``multi_tensor_scale`` reads it by
pointer): nothing is read on the host unless ``error_if_nonfinite`` is
set. The gradients are scaled in place, as the original CUDA Apex scales
them (the reference, being functional, returns new ones); the call
returns ``(grads, total_norm)``, as the reference's does.

``grads`` is a name -> tensor mapping or a sequence of tensors (packed
into one flat fp32 buffer, as the reference packs its pytree, then
copied back scaled, each in its own dtype), or one flat fp32 buffer such
as ``PretrainStep.grad``, which is scaled where it lies, without
packing. Other p-norms and the inf-norm are plain PyTorch, as they are
XLA in the reference (:56-71).

``norms`` (a ``parallel.sharded_norms.ShardedNorms``, a sharded
``FlatOptState``'s ``norms``) makes the 2-norm of a flat gradient that
is one rank's part of the model (a tensor or pipe shard) the whole
model's, as the reference's replicated tree gives it: each leaf's sum
of squares summed over the ranks that split it, every leaf counted
once.
"""

from __future__ import annotations

import math
from typing import Any, List, Mapping, Tuple

import torch

from apex_tpu_torch.multi_tensor.flat_buffer import FlatSpace
from apex_tpu_torch.multi_tensor.ops import (
    _dev_f32,
    multi_tensor_l2norm,
    multi_tensor_scale,
)


def _leaves(grads) -> List[torch.Tensor]:
    if isinstance(grads, torch.Tensor):
        return [grads]
    if isinstance(grads, Mapping):
        return list(grads.values())
    return list(grads)


def _is_flat(grads) -> bool:
    return (isinstance(grads, torch.Tensor) and grads.ndim == 1
            and grads.dtype == torch.float32 and grads.is_contiguous())


def clip_grad_norm_(grads: Any, max_norm: float, norm_type: float = 2.0,
                    error_if_nonfinite: bool = False, *, norms=None
                    ) -> Tuple[Any, torch.Tensor]:
    """Scale ``grads`` in place so that their global ``norm_type``-norm
    is at most ``max_norm`` (by ``min(max_norm / (norm + 1e-6), 1)``)
    and return ``(grads, total_norm)``, the norm before clipping a 0-d
    fp32 tensor on the gradients' device. ``error_if_nonfinite`` reads
    the norm on the host and raises when it is inf or nan (the
    reference checks only the other norms; ``torch.nn.utils.
    clip_grad_norm_`` checks all). ``norms``: the module docstring (a
    flat fp32 gradient laid out by its space)."""
    if norms is not None and (norm_type != 2.0 or not _is_flat(grads)):
        raise ValueError("norms takes the 2-norm of a flat fp32 gradient")
    leaves = _leaves(grads)
    if not leaves:
        return grads, torch.zeros((), dtype=torch.float32)
    max_norm, norm_type = float(max_norm), float(norm_type)

    if norm_type == 2.0:
        if _is_flat(grads):
            space, buf = None, grads
        else:
            named = (dict(grads) if isinstance(grads, Mapping) else
                     {str(i): t for i, t in enumerate(leaves)})
            space = FlatSpace.create(named)
            buf = space.pack(named, dtype=torch.float32)
        if norms is not None:
            total_norm = norms.global_norm(buf)
        else:
            total_norm, _ = multi_tensor_l2norm(buf)
        coef = _clip_coef(total_norm, max_norm, norm_type, error_if_nonfinite)
        multi_tensor_scale(buf, coef, in_place=True)
        if space is not None:
            with torch.no_grad():
                for t, v in zip(leaves, space.unpack(buf, "buffer").values()):
                    t.copy_(v)
        return grads, total_norm

    fl = [t.float() for t in leaves]
    if math.isinf(norm_type):
        total_norm = torch.stack([t.abs().max() for t in fl]).max()
    else:
        total_norm = torch.stack([
            torch.sum(t.abs() ** norm_type) for t in fl]).sum() \
            ** (1.0 / norm_type)
    coef = _clip_coef(total_norm, max_norm, norm_type, error_if_nonfinite)
    with torch.no_grad():
        for t, f in zip(leaves, fl):
            t.copy_((f * coef).to(t.dtype))
    return grads, total_norm


def _clip_coef(total_norm: torch.Tensor, max_norm: float, norm_type: float,
               error_if_nonfinite: bool) -> torch.Tensor:
    """``min(max_norm / (total_norm + 1e-6), 1)``, fp32 arithmetic on 0-d
    tensors of the norm's device (a true division, as the reference's)."""
    if error_if_nonfinite and not bool(torch.isfinite(total_norm)):
        raise RuntimeError(
            f"The total norm of order {norm_type} is non-finite")
    dev = total_norm.device
    coef = _dev_f32(max_norm, dev) / (total_norm + _dev_f32(1e-6, dev))
    return torch.minimum(coef, _dev_f32(1.0, dev))


__all__ = ["clip_grad_norm_"]
