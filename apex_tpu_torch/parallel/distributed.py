"""Data-parallel gradient synchronization over the data axis's process
group.

Counterpart of ``apex_tpu/parallel/distributed.py``. The reference
averages a gradient tree with one ``psum`` over the mesh's data axis
inside the jitted step and keeps the reference apex's policy knobs;
here the same policy runs eagerly over the data axis's process group
(``transformer.parallel_state``), in place on the gradient tensors:

  gradient_average          -> mean instead of sum
  gradient_predivide_factor -> divide by f before, by world/f after
  allreduce_always_fp32     -> reduce an fp32 copy, cast back

in the reference's order of operations (:72-89). As there, the average
divides by the size of the whole data axis, also where
``axis_index_groups`` sums over smaller groups. A flat gradient buffer
(``PretrainStep.grad``) is one collective; a dict, list or tuple of
tensors is one a tensor, dicts in sorted key order, as ``jax.tree``
walks them, so that every rank issues them in one order.

:func:`sync_deviation` is the reference's replication check (:130): the
group's first rank broadcasts its copy, each rank takes its local max
|x - ref| over every leaf (non-finite mapped to +inf), one all-reduce
MAX. ``Reducer`` is the manual helper (:178). ``prof`` wraps the
reduction in a ``torch.profiler.record_function`` range.

Outside an initialized topology, with no process group, the world is
one rank and the reduction is the identity (divided by 1); with a
process group of more than one rank and no topology, it raises.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Any, List, Optional, Sequence

import torch
import torch.distributed as dist

from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.parallel_state import DATA_AXIS

PROFILE_RANGE = "apex_tpu_torch.ddp.allreduce"


def _group_of(axis_name: str, axis_index_groups):
    """``(group, ranks, axis_size)`` of a collective over ``axis_name``
    on this rank; ``(None, (rank,), 1)`` in a world of one."""
    if not ps.model_parallel_is_initialized():
        if dist.is_initialized() and dist.get_world_size() > 1:
            raise RuntimeError(
                "torch.distributed has more than one rank but the "
                "topology is not initialized (call "
                "parallel_state.initialize_model_parallel)")
        return None, (0,), 1
    group, ranks = ps.axis_group(axis_name, axis_index_groups)
    return group, ranks, ps.get_mesh().shape[axis_name]


def _leaves(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _leaves(x)]
    if tree is None:
        return []
    raise TypeError(f"not a tensor, dict, list or tuple: {type(tree)}")


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` rounded once to fp32, a 0-d tensor on ``like``'s device (a
    fill, no host copy): the reference's weak-typed Python scalar. A
    CUDA tensor divided by a Python number is multiplied by its
    reciprocal instead."""
    return torch.full((), v, dtype=torch.float32, device=like.device)


class DistributedDataParallel:
    """Gradient-averaging policy over the data axis::

        ddp = DistributedDataParallel()
        loss = step.backward(state, x, y)
        ddp.allreduce_grads(step.grad)       # in place, one collective

    or ``PretrainStep(..., grad_reduce=ddp)``. The reference apex's
    bucketing and stream knobs (``message_size``, ``delay_allreduce``)
    have no counterpart here, as in the JAX reference."""

    def __init__(
        self,
        axis_name: str = DATA_AXIS,
        gradient_average: bool = True,
        gradient_predivide_factor: float = 1.0,
        allreduce_always_fp32: bool = False,
        axis_index_groups: Optional[Sequence[Sequence[int]]] = None,
        prof: bool = False,
        check_reduction: bool = False,
    ):
        self.axis_name = axis_name
        self.gradient_average = gradient_average
        self.gradient_predivide_factor = gradient_predivide_factor
        self.allreduce_always_fp32 = allreduce_always_fp32
        self.axis_index_groups = axis_index_groups
        self.prof = prof
        self.check_reduction = check_reduction
        # every subgroup is made now, on every rank in one order
        _group_of(axis_name, axis_index_groups)

    def _reduce_one(self, g: torch.Tensor, group, world: int) -> None:
        predivide = self.gradient_predivide_factor
        t = g
        if self.allreduce_always_fp32 and g.dtype != torch.float32:
            t = g.float()
        if predivide != 1.0:
            t.div_(_scalar(predivide, t))
        if group is not None:
            dist.all_reduce(t, group=group)
        if self.gradient_average:
            post = world / predivide if predivide != 1.0 else world
            t.div_(_scalar(post, t))
        elif predivide != 1.0:
            t.mul_(_scalar(predivide, t))
        if t is not g:
            g.copy_(t)

    def allreduce_grads(self, grads: Any) -> Any:
        """All-reduce every tensor of ``grads`` (a tensor, or a dict,
        list or tuple of them) in place over the data axis; returns
        ``grads``."""
        group, _, world = _group_of(self.axis_name, self.axis_index_groups)
        scope = (torch.profiler.record_function(PROFILE_RANGE) if self.prof
                 else contextlib.nullcontext())
        with scope:
            for g in _leaves(grads):
                self._reduce_one(g, group, world)
        return grads

    __call__ = allreduce_grads

    def check_synchronized(self, tree: Any) -> torch.Tensor:
        """With ``check_reduction``, :func:`sync_deviation` of ``tree``
        (the gradients the optimizer consumes), warning when it is not
        0: a leaf that bypassed the reduction is reaching the
        optimizer. Without it, a 0-d zero and no collective."""
        if not self.check_reduction:
            return torch.zeros((), dtype=torch.float32)
        dev = sync_deviation(tree, self.axis_name, self.axis_index_groups)
        if not bool(dev <= 0):
            warnings.warn(
                f"DDP check_reduction: grads DIVERGE across "
                f"{self.axis_name} (max dev {float(dev)}): an unsynced or "
                "rank-dependent grad is reaching the optimizer")
        return dev


def sync_deviation(tree: Any, axis_name: str = DATA_AXIS,
                   axis_index_groups=None) -> torch.Tensor:
    """Max |x - first_rank(x)| over the group, across every leaf of
    ``tree``: exactly 0 iff the (finite) tree is replicated, +inf if any
    leaf holds an inf or a NaN anywhere. A 0-d fp32 tensor, the same on
    every rank of the group. Every rank of the group must call it."""
    leaves = [t for t in _leaves(tree) if t.numel()]
    if not leaves:
        return torch.zeros((), dtype=torch.float32)
    group, ranks, _ = _group_of(axis_name, axis_index_groups)
    x = torch.cat([t.detach().reshape(-1).float() for t in leaves])
    ref = x.clone()
    if group is not None:
        dist.broadcast(ref, src=min(ranks), group=group)
    d = (x - ref).abs().max()
    d = torch.where(torch.isfinite(d), d, torch.full_like(d, float("inf")))
    if group is not None:
        dist.all_reduce(d, op=dist.ReduceOp.MAX, group=group)
    return d


class Reducer:
    """Manual all-reduce helper: ``reduce(tree)`` sums every tensor of
    ``tree`` in place over the data axis (divided by its size with
    ``average``) whenever the caller chooses; no hooks."""

    def __init__(self, axis_name: str = DATA_AXIS, axis_index_groups=None):
        self.axis_name = axis_name
        self.axis_index_groups = axis_index_groups
        _group_of(axis_name, axis_index_groups)

    def reduce(self, tree: Any, average: bool = True) -> Any:
        group, _, world = _group_of(self.axis_name, self.axis_index_groups)
        for t in _leaves(tree):
            if group is not None:
                dist.all_reduce(t, group=group)
            if average:
                t.div_(_scalar(world, t))
        return tree


__all__ = ["DistributedDataParallel", "PROFILE_RANGE", "Reducer",
           "sync_deviation"]
