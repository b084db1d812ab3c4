"""Model-parallel topology: one process group per axis of the rank grid.

Counterpart of ``apex_tpu/transformer/parallel_state.py`` (:49-208).
The reference lays the devices out as one mesh of shape ``(data,
expert, pipe, context, tensor)``, ``tensor`` innermost, by a plain
reshape of the device list (:93, :128). Here every process is one rank
and the same reshape of ``range(world)`` gives each rank its
coordinates; each axis becomes the process groups of the ranks that
differ along it alone (``dist.new_group``, created by every rank in the
same order, as ``torch.distributed`` requires). A collective over an
axis is then a collective over this rank's group of that axis, where
the reference names the axis inside ``shard_map``.

Without an initialized process group the world is one rank, as the
reference's one-device mesh is: every axis has size 1 and every rank
query returns 0.

The ranks are host integers here (the reference's ``get_*_rank`` are
``lax.axis_index`` inside a trace). ``get_mesh`` returns the topology,
whose ``shape`` maps each axis name to its size as a ``Mesh``'s does.
Topology-aware device placement (the reference's ``mesh_utils`` path
for multi-slice TPUs) has no counterpart: a rank's device is
``cuda:{local_rank % device_count}`` (``parallel.multiproc``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

DATA_AXIS = "data"
TENSOR_AXIS = "tensor"
PIPELINE_AXIS = "pipe"
EXPERT_AXIS = "expert"
CONTEXT_AXIS = "context"
AXES = (DATA_AXIS, EXPERT_AXIS, PIPELINE_AXIS, CONTEXT_AXIS, TENSOR_AXIS)


def rank_grid(world: int, tensor_model_parallel_size: int = 1,
              pipeline_model_parallel_size: int = 1,
              expert_model_parallel_size: int = 1,
              context_parallel_size: int = 1) -> np.ndarray:
    """The ranks ``0..world-1`` reshaped to ``(dp, ep, pp, cp, tp)``, the
    reference's plain reshape of the device list. Raises when ``world``
    is not divisible by tp x pp x ep x cp."""
    tp, pp, ep, cp = (tensor_model_parallel_size,
                      pipeline_model_parallel_size,
                      expert_model_parallel_size, context_parallel_size)
    if world % (tp * pp * ep * cp):
        raise RuntimeError(
            f"world size {world} not divisible by "
            f"tp({tp}) x pp({pp}) x ep({ep}) x cp({cp})")
    dp = world // (tp * pp * ep * cp)
    return np.arange(world).reshape(dp, ep, pp, cp, tp)


def axis_rank_lists(grid: np.ndarray, axis: str) -> List[List[int]]:
    """The groups of ``axis``: for every position along the other axes,
    the ranks along ``axis`` in order, in row-major order of those
    positions."""
    a = AXES.index(axis)
    moved = np.moveaxis(grid, a, -1)
    return [[int(r) for r in row]
            for row in moved.reshape(-1, grid.shape[a])]


@dataclasses.dataclass
class Topology:
    """This process's place in the rank grid and its groups."""

    grid: np.ndarray
    rank: int
    coords: Dict[str, int]
    # axis -> (this rank's group of the axis or None for a world of
    # one, the group's ranks in axis order)
    groups: Dict[str, Tuple[Optional[object], Tuple[int, ...]]]
    subgroups: Dict[tuple, Tuple[Optional[object], Tuple[int, ...]]] = \
        dataclasses.field(default_factory=dict)

    @property
    def shape(self) -> Dict[str, int]:
        return {a: int(self.grid.shape[i]) for i, a in enumerate(AXES)}

    @property
    def size(self) -> int:
        return int(self.grid.size)


_STATE: Optional[Topology] = None


def _world() -> Tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def _make_group(ranks: Sequence[int], world: int):
    """A process group over ``ranks``; every rank of the world calls
    this for every group in the same order. The whole world is the
    default group; a group of one needs none."""
    if len(ranks) == 1:
        return None
    if len(ranks) == world:
        return dist.group.WORLD
    return dist.new_group(list(ranks))


def initialize_model_parallel(
    tensor_model_parallel_size: int = 1,
    pipeline_model_parallel_size: int = 1,
    expert_model_parallel_size: int = 1,
    context_parallel_size: int = 1,
) -> Topology:
    """Lay the world's ranks out as ``(data, expert, pipe, context,
    tensor)`` and create every axis's process groups (the reference's
    :49). The data axis takes what the others leave."""
    global _STATE
    world, rank = _world()
    grid = rank_grid(world, tensor_model_parallel_size,
                     pipeline_model_parallel_size,
                     expert_model_parallel_size, context_parallel_size)
    pos = np.argwhere(grid == rank)[0]
    coords = {a: int(pos[i]) for i, a in enumerate(AXES)}
    groups = {}
    for axis in AXES:
        mine = None
        for ranks in axis_rank_lists(grid, axis):
            g = _make_group(ranks, world)
            if rank in ranks:
                mine = (g, tuple(ranks))
        groups[axis] = mine
    _STATE = Topology(grid=grid, rank=rank, coords=coords, groups=groups)
    return _STATE


def model_parallel_is_initialized() -> bool:
    return _STATE is not None


def get_mesh() -> Topology:
    if _STATE is None:
        raise RuntimeError(
            "model parallel mesh is not initialized "
            "(call initialize_model_parallel first)")
    return _STATE


def destroy_model_parallel() -> None:
    """Forget the topology and its groups (the reference's
    ``destroy_model_parallel``). The subgroups stay alive in
    ``torch.distributed`` until its own ``destroy_process_group``."""
    global _STATE
    _STATE = None


def axis_group(axis: str = DATA_AXIS,
               axis_index_groups: Optional[Sequence[Sequence[int]]] = None):
    """``(group, ranks)`` for a collective over ``axis`` on this rank:
    the axis's group, or with ``axis_index_groups`` (lists of indices
    along the axis, the reference's ``lax.psum`` argument) the subgroup
    holding this rank. ``(None, (rank,))`` when the topology is not
    initialized or the group is this rank alone. Every subgroup of
    every group of the axis is created at the first call, on every rank
    in the same order, and cached."""
    if axis not in AXES:
        raise ValueError(f"unknown axis {axis!r}; expected one of {AXES}")
    if _STATE is None:
        return None, (_world()[1],)
    if axis_index_groups is None:
        return _STATE.groups[axis]
    key = (axis, tuple(tuple(int(i) for i in g) for g in axis_index_groups))
    if key not in _STATE.subgroups:
        size = _STATE.shape[axis]
        flat = sorted(i for g in key[1] for i in g)
        if flat != list(range(size)):
            raise ValueError(
                f"axis_index_groups {key[1]} do not partition the "
                f"{size} indices of axis {axis!r}")
        if len({len(g) for g in key[1]}) != 1:
            raise ValueError("axis_index_groups must all have one size")
        world = _STATE.size
        mine = None
        for ranks in axis_rank_lists(_STATE.grid, axis):
            for idx in key[1]:
                sub = tuple(ranks[i] for i in idx)
                g = _make_group(sub, world)
                if _STATE.rank in sub:
                    mine = (g, sub)
        _STATE.subgroups[key] = mine
    return _STATE.subgroups[key]


# -- world sizes ---------------------------------------------------------------


def _axis_size(name: str) -> int:
    return get_mesh().shape[name]


def get_tensor_model_parallel_world_size() -> int:
    return _axis_size(TENSOR_AXIS)


def get_pipeline_model_parallel_world_size() -> int:
    return _axis_size(PIPELINE_AXIS)


def get_data_parallel_world_size() -> int:
    return _axis_size(DATA_AXIS)


def get_expert_model_parallel_world_size() -> int:
    return _axis_size(EXPERT_AXIS)


def get_context_parallel_world_size() -> int:
    return _axis_size(CONTEXT_AXIS)


def get_world_size() -> int:
    return get_mesh().size


# -- ranks: this process's coordinate along each axis --------------------------


def _axis_rank(name: str) -> int:
    return get_mesh().coords[name]


def get_tensor_model_parallel_rank() -> int:
    return _axis_rank(TENSOR_AXIS)


def get_pipeline_model_parallel_rank() -> int:
    return _axis_rank(PIPELINE_AXIS)


def get_data_parallel_rank() -> int:
    return _axis_rank(DATA_AXIS)


def get_expert_model_parallel_rank() -> int:
    return _axis_rank(EXPERT_AXIS)


def get_context_parallel_rank() -> int:
    return _axis_rank(CONTEXT_AXIS)



__all__ = [
    "AXES", "CONTEXT_AXIS", "DATA_AXIS", "EXPERT_AXIS", "PIPELINE_AXIS",
    "TENSOR_AXIS", "Topology", "axis_group", "axis_rank_lists",
    "destroy_model_parallel", "get_context_parallel_rank",
    "get_context_parallel_world_size", "get_data_parallel_rank",
    "get_data_parallel_world_size",
    "get_expert_model_parallel_rank", "get_expert_model_parallel_world_size",
    "get_mesh", "get_pipeline_model_parallel_rank",
    "get_pipeline_model_parallel_world_size", "get_tensor_model_parallel_rank",
    "get_tensor_model_parallel_world_size", "get_world_size",
    "initialize_model_parallel", "model_parallel_is_initialized",
    "rank_grid",
]
