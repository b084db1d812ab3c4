"""Norms over a flat optimizer state that lies across ranks.

The reference holds one replicated flat master on its mesh and lets XLA
place every reduction (``apex_tpu/mesh/mesh.py`` :184-196), and its ZeRO
optimizers sum their shards' norms with ``lax.psum``
(``apex_tpu/contrib/optimizers/distributed.py`` :290-300). In the port
each rank's flat state holds only its part: a tensor rank the shards of
the split leaves (and every replicated leaf whole), a pipe rank its
stage's leaves, a ZeRO rank one contiguous slice of the flat space. A
norm over a leaf or over the whole gradient is then a sum of squares
over ranks:

- :func:`group_sum` / :func:`group_max`: the one collective each,
  all-reduced over a process group (the input itself without one);
- :class:`ShardedNorms`: the rule for a state cut on the tensor and pipe
  axes. A *split* leaf's sum of squares is its local one summed over the
  tensor group; a replicated leaf (LayerNorm, the row-parallel biases)
  is whole on every rank and counted once, not tp times. The global sum
  adds every leaf once over the pipe group, a leaf held by two stages
  (the tied embedding on the first and last) counted on one. Every rank
  of a group gets the same bits (an all-reduce hands each rank one
  result), so replicated leaves stay bitwise equal across ranks.

Summing in another order than the reference's is not bitwise: the tests
state their bounds.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from apex_tpu_torch.multi_tensor.engine import (PER_TENSOR_TILE_ROWS,
                                                fused_sumsq_partials,
                                                leaf_sums, sqrt_rn)


def group_sum(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group`` (a new tensor; ``x`` itself when
    ``group`` is None)."""
    if group is None:
        return x
    x = x.clone()
    dist.all_reduce(x, group=group)
    return x


def group_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise max of ``x`` over ``group`` (``x`` itself when
    ``group`` is None)."""
    if group is None:
        return x
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def local_leaf_sumsq(buf: torch.Tensor, space, *,
                     plain: bool = False) -> torch.Tensor:
    """(num_leaves,) sums of squares of each leaf of the flat ``buf``
    on this rank (kernels ``sumsq`` and ``leaf_sum``)."""
    return leaf_sums(fused_sumsq_partials(buf, PER_TENSOR_TILE_ROWS,
                                          plain=plain), space, plain=plain)


@dataclasses.dataclass(frozen=True)
class ShardedNorms:
    """How this rank's per-leaf sums of squares over its flat state
    (laid out by ``space``) become the whole model's.

    ``split[i]``: leaf i is cut over ``group`` (the tensor group), so
    its sum of squares is summed over it. ``counted[i]``: leaf i counts
    toward the global sum on this rank (False for a copy another rank
    of ``outer`` counts). ``outer``: the group whose ranks hold
    different leaves (the pipe group), over which the global sum runs.
    """

    space: object
    split: Tuple[bool, ...]
    counted: Tuple[bool, ...]
    group: Optional[object] = None
    outer: Optional[object] = None

    def _mask(self, flags: Sequence[bool], like: torch.Tensor
              ) -> torch.Tensor:
        key = (tuple(flags), like.device)
        cache = self.space._device_ids
        m = cache.get(("norm_mask",) + key)
        if m is None:
            m = cache[("norm_mask",) + key] = torch.tensor(
                flags, dtype=torch.bool).to(like.device)
        return m

    @property
    def splits_any(self) -> bool:
        return self.group is not None and any(self.split)

    def leaf_sumsq(self, local: torch.Tensor) -> torch.Tensor:
        """(num_leaves,) sums of squares of the whole leaves from this
        rank's ``local`` ones: the split leaves' summed over the tensor
        group, the rest as they are."""
        if not self.splits_any:
            return local
        split = self._mask(self.split, local)
        zero = torch.zeros((), dtype=local.dtype, device=local.device)
        summed = group_sum(torch.where(split, local, zero), self.group)
        return torch.where(split, summed, local)

    def leaf_norms(self, local: torch.Tensor) -> torch.Tensor:
        """The whole leaves' L2 norms from this rank's local sums of
        squares."""
        return sqrt_rn(self.leaf_sumsq(local))

    def total_sumsq(self, leaf_sq: torch.Tensor) -> torch.Tensor:
        """The global sum of squares (0-d) from the whole leaves' sums
        (:meth:`leaf_sumsq`): every leaf once over the pipe group."""
        counted = self._mask(self.counted, leaf_sq)
        zero = torch.zeros((), dtype=leaf_sq.dtype, device=leaf_sq.device)
        return group_sum(torch.sum(torch.where(counted, leaf_sq, zero)),
                         self.outer)

    def global_sumsq(self, buf: torch.Tensor, *,
                     plain: bool = False) -> torch.Tensor:
        """The whole model's sum of squares of the flat ``buf``, 0-d fp32
        on its device."""
        return self.total_sumsq(self.leaf_sumsq(local_leaf_sumsq(
            buf, self.space, plain=plain)))

    def global_norm(self, buf: torch.Tensor, *,
                    plain: bool = False) -> torch.Tensor:
        return sqrt_rn(self.global_sumsq(buf, plain=plain))

    def any(self, flag: torch.Tensor) -> torch.Tensor:
        """A found-inf flag max-reduced over every rank the state spans,
        so that all of them skip alike."""
        return group_max(group_max(flag, self.group), self.outer)


__all__ = ["ShardedNorms", "group_max", "group_sum", "local_leaf_sumsq"]
