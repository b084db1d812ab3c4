"""One process-global named mesh (``batch`` / ``pipe`` / ``model``), the
sharding plan of a model on it, and the train step over this rank's
shard.

Counterpart of ``apex_tpu/mesh/mesh.py`` (:40-492). The reference's mesh
is one ``jax.sharding.Mesh`` whose arrays carry ``NamedSharding``s, and
XLA places every collective (GSPMD). PyTorch has no compiler to place
them, so the port's mesh is the explicit one: each process is one rank,
:func:`initialize_mesh` lays the ranks out through
``transformer.parallel_state`` (``batch`` is its data axis, ``model`` its
tensor axis, innermost; ``pipe`` its pipeline axis), and each rank holds
its shard of every parameter; the tensor-parallel layers place the
collectives themselves (``transformer/tensor_parallel``).

- :class:`ShardingPlan`: a spec a parameter name (the models'
  ``*_param_specs`` with the tensor axis renamed ``model``) and the
  batch spec. ``shard_params`` gives this rank's slice of each full
  tensor, ``shard_batch`` this data rank's rows, ``shard_state`` this
  rank's part of an optimizer state over the full parameters. Each is
  the identity (the same object) on a mesh of one rank.
- :class:`MeshTrainStep`: ``PretrainStep`` over this rank's shard: the
  backward, the gradient's all-reduce over the data group (a
  ``DistributedDataParallel`` as ``grad_reduce``, only where ``batch >
  1``), then ``opt.step_flat``. The loss returned is the whole batch's,
  the mean over the data group.

**The optimizer state is sharded, not replicated.** The reference
replicates its flat master on the mesh (:184-197) and lets XLA slice the
parameters out of it. Here a parameter is a view into this rank's flat
master, and a strided column slice of a full master cannot be one, so
each rank's flat state holds its own shard (the replicated leaves on
every rank). For an elementwise update (FusedAdam, FusedSGD,
FusedAdagrad) the numbers are those of the replicated master. FusedLAMB,
the global-norm clip, FusedNovoGrad and FusedLARS / LARC need norms over
the whole of a split leaf and the whole gradient: the state carries the
plan's :meth:`ShardingPlan.norms` (``FlatOptState.norms``), which sums a
split leaf's squares over the tensor group, counts a replicated leaf
once, and sums the global norm over the pipe group with the tied
embedding counted once (``parallel/sharded_norms.py``). FusedLAMB's
segmented layout then keeps the split leaves and the tied embedding out
of the small segments, whose norms the segment kernel computes on its
own (:meth:`ShardingPlan.cross_rank_names`).

Pipelining: on a mesh with ``pipe > 1`` each rank holds one stage of the
model (``mesh/pipeline.py``); :func:`plan_gpt` then keeps this rank's
stage's parameters (``num_model_chunks`` chunks a stage), each cut on the
tensor axis within, and ``shard_params`` / ``shard_state`` cut by stage.
:class:`MeshTrainStep` runs one stage and refuses a pipe axis: the
pipelined step is ``mesh.MeshPipelineTrainStep``.

Not ported: the compile-plane observation and the sharding telemetry of
the reference's step (:436-443, ROADMAP A 10) and its MoE fault hooks
(A 9f).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, ClassVar, Dict, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.tensor_parallel import shard_tensor

BATCH_AXIS = "batch"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"

#: outer -> inner; model innermost (the latency-critical axis on
#: adjacent ranks, as parallel_state puts its tensor axis)
MESH_AXES = (BATCH_AXIS, PIPE_AXIS, MODEL_AXIS)

# the parallel_state axis each mesh axis is
_PS_AXIS = {BATCH_AXIS: ps.DATA_AXIS, PIPE_AXIS: ps.PIPELINE_AXIS,
            MODEL_AXIS: ps.TENSOR_AXIS}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The live layout of the world's ranks: ``shape`` maps each mesh
    axis to its size, ``coords`` to this rank's index along it."""

    topology: ps.Topology
    axis_names: ClassVar[Tuple[str, ...]] = MESH_AXES

    @property
    def shape(self) -> Dict[str, int]:
        sizes = self.topology.shape
        return {a: int(sizes[_PS_AXIS[a]]) for a in MESH_AXES}

    @property
    def coords(self) -> Dict[str, int]:
        return {a: int(self.topology.coords[_PS_AXIS[a]]) for a in MESH_AXES}

    @property
    def size(self) -> int:
        return int(self.topology.size)

    def group(self, axis: str):
        """``(process group or None, ranks)`` of this rank along ``axis``."""
        return ps.axis_group(_PS_AXIS[axis])


_MESH: Optional[Mesh] = None


def mesh_initialized() -> bool:
    return _MESH is not None


def current_mesh() -> Mesh:
    if _MESH is None:
        raise RuntimeError("the mesh is not initialized (call "
                           "mesh.initialize_mesh first)")
    return _MESH


def mesh_size() -> int:
    """Ranks of the live mesh (1 when none is live)."""
    return 1 if _MESH is None else _MESH.size


def axis_sizes() -> Dict[str, int]:
    """``{axis: size}`` of the live mesh (all 1 when none is live)."""
    if _MESH is None:
        return {a: 1 for a in MESH_AXES}
    return _MESH.shape


def _world() -> int:
    return dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1


def initialize_mesh(batch: Optional[int] = None, model: int = 1,
                    pipe: int = 1) -> Mesh:
    """Lay the world's ranks out as ``(batch, pipe, model)`` through
    ``parallel_state`` (its data, pipeline and tensor axes) and arm the
    mesh. ``batch`` defaults to ``world // (model * pipe)``. Without a
    process group the world is one rank, and a mesh of one is legal."""
    global _MESH
    world = _world()
    model, pipe = int(model), int(pipe)
    if model < 1 or pipe < 1:
        raise ValueError(f"axis sizes must be >= 1 (model={model}, "
                         f"pipe={pipe})")
    if batch is None:
        if world % (model * pipe):
            raise ValueError(f"world size {world} not divisible by "
                             f"model({model}) x pipe({pipe})")
        batch = world // (model * pipe)
    if int(batch) * model * pipe != world:
        raise ValueError(f"batch({batch}) x model({model}) x pipe({pipe}) "
                         f"!= world size {world}")
    topo = ps.initialize_model_parallel(tensor_model_parallel_size=model,
                                        pipeline_model_parallel_size=pipe)
    _MESH = Mesh(topo)
    return _MESH


def destroy_mesh() -> None:
    """Disarm the mesh and forget its topology."""
    global _MESH
    if _MESH is not None:
        ps.destroy_model_parallel()
    _MESH = None


# -- ShardingPlan -------------------------------------------------------------


def _rows(x, n: int, index: int):
    """Rows ``[index * b / n, (index + 1) * b / n)`` of a batch-major
    tensor or array."""
    b = x.shape[0]
    if b % n:
        raise ValueError(f"batch of {b} does not split over {n} data ranks")
    chunk = b // n
    return x[index * chunk:(index + 1) * chunk]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


@dataclasses.dataclass(frozen=True)
class ShardingPlan:
    """How one model's tensors lie on one mesh: a spec a parameter name
    (a tuple of mesh axis names or None, one a dim) and the batch spec.
    Every ``shard_*`` returns its argument itself on a mesh of one
    rank."""

    mesh: Mesh
    param_specs: Dict[str, tuple]
    batch_spec: tuple = (BATCH_AXIS,)
    # leaves two pipe stages hold (GPT's tied embedding, on the first and
    # the last): counted once in a global norm, on the first stage
    tied: Tuple[str, ...] = ()

    @property
    def n_devices(self) -> int:
        return self.mesh.size

    def is_identity(self) -> bool:
        return self.n_devices <= 1

    def shard_params(self, params: Mapping[str, torch.Tensor]
                     ) -> Mapping[str, torch.Tensor]:
        """This rank's slice of each full parameter, by name (contiguous
        tensors, views where the slice is whole); with ``pipe > 1`` only
        this rank's stage's parameters (the names the plan holds)."""
        if self.is_identity():
            return params
        shape, coords = self.mesh.shape, self.mesh.coords
        staged = shape[PIPE_AXIS] > 1
        return {n: shard_tensor(t, self.param_specs.get(n, ()), shape,
                                coords).contiguous()
                for n, t in params.items()
                if not staged or n in self.param_specs}

    def shard_batch(self, batch: Any) -> Any:
        """This data rank's rows of a batch-major tensor or array (or a
        dict, list or tuple of them)."""
        if self.is_identity():
            return batch
        n, i = self.mesh.shape[BATCH_AXIS], self.mesh.coords[BATCH_AXIS]
        return _map(lambda x: _rows(x, n, i), batch)

    def split_names(self, names) -> Tuple[str, ...]:
        """The names among ``names`` cut over a model axis of more than
        one rank."""
        if self.mesh.shape[MODEL_AXIS] <= 1:
            return ()
        return tuple(n for n in names
                     if MODEL_AXIS in self.param_specs.get(n, ()))

    def cross_rank_names(self, names) -> Tuple[str, ...]:
        """The names among ``names`` whose norms span ranks or must agree
        across them: the :meth:`split_names`, and a ``tied`` leaf that
        two pipe stages hold. FusedLAMB's segmented layout keeps them
        out of the small segments, whose norms the segment kernel sums
        in an order that depends on the segment a leaf shares."""
        tied = (() if self.mesh.shape[PIPE_AXIS] <= 1 else
                tuple(n for n in names if n in self.tied))
        return self.split_names(names) + tied

    def norms(self, space):
        """The rule that turns norms over this rank's flat state (laid
        out by ``space``) into the whole model's
        (``parallel.sharded_norms.ShardedNorms``): the split leaves
        summed over the model group, the global sum over the pipe group
        with each ``tied`` leaf counted on the first stage. None where
        both axes are one rank (every norm is local)."""
        from apex_tpu_torch.parallel.sharded_norms import ShardedNorms

        shape, coords = self.mesh.shape, self.mesh.coords
        if shape[MODEL_AXIS] <= 1 and shape[PIPE_AXIS] <= 1:
            return None
        split = set(self.split_names(space.names))
        later = coords[PIPE_AXIS] > 0
        return ShardedNorms(
            space=space, split=tuple(n in split for n in space.names),
            counted=tuple(not (later and n in self.tied)
                          for n in space.names),
            group=self.mesh.group(MODEL_AXIS)[0],
            outer=self.mesh.group(PIPE_AXIS)[0])

    def shard_state(self, state):
        """This rank's part of a ``FlatOptState`` over the full
        parameters: a flat state over this rank's shards, its master and
        every elementwise slot cut the way the parameters are, a per-leaf
        slot (FusedNovoGrad's ``v``, the norm of the whole leaf) and a
        0-d one (the first-run flag) kept per leaf, the count and
        found_inf kept, and the plan's :meth:`norms`. A segmented layout
        (FusedLAMB) is laid out anew over the shards at its segment size,
        the split leaves out of the small segments
        (``optimizers.fused.segmented_layout``)."""
        if self.is_identity():
            return state
        from apex_tpu_torch.multi_tensor.flat_buffer import FlatSpace
        from apex_tpu_torch.optimizers.fused import segmented_layout

        mine = self.shard_params(state.space.unpack(state.master))
        meta = state.seg_meta
        if meta is None:
            space = FlatSpace.create(mine, align=state.space.align)
        else:
            space, new = segmented_layout(mine, meta.seg_elems,
                                          self.cross_rank_names(mine))
            meta = dataclasses.replace(new, stash_p=meta.stash_p,
                                       u_dtype_name=meta.u_dtype_name)
        total, leaves = state.master.numel(), state.space.num_leaves
        keep = torch.tensor([state.space.names.index(n)
                             for n in space.names], dtype=torch.long)

        def cut(buf):
            if buf.numel() == total:
                return space.pack(self.shard_params(
                    state.space.unpack(buf, dtype="buffer")),
                    dtype=buf.dtype)
            if buf.ndim == 1 and buf.numel() == leaves:
                return buf[keep.to(buf.device)].clone()
            if buf.ndim == 0:
                return buf.clone()
            raise ValueError(f"shard_state: a slot of shape "
                             f"{tuple(buf.shape)} is neither elementwise, "
                             "per leaf nor a scalar")

        return state._replace(
            space=space, master=cut(state.master),
            slots={k: cut(b) for k, b in state.slots.items()},
            found_inf=state.found_inf.clone(), seg_meta=meta,
            norms=self.norms(space))

    def detail(self) -> Dict[str, Any]:
        """A JSON-able summary (the reference's keys)."""
        specs = list(self.param_specs.values())
        return {"mesh": self.mesh.shape, "n_devices": self.n_devices,
                "batch_spec": str(tuple(self.batch_spec)),
                "param_leaves": len(specs),
                "param_leaves_sharded": sum(
                    1 for s in specs if any(a is not None for a in s))}


def plan_gpt(params: Any, *, mesh: Optional[Mesh] = None,
             num_model_chunks: int = 1) -> ShardingPlan:
    """The GPT plan: ``gpt_param_specs`` with the tensor axis renamed to
    the mesh's ``model`` axis (column kernels on the output dim, row
    kernels on the input dim, the embedding on the vocab), the batch on
    ``batch``. ``params``: the full model, a state dict or the names.
    With ``pipe > 1`` the plan holds this rank's stage's parameters
    (``mesh.pipeline.stage_param_names``: its ``num_model_chunks``
    chunks of layers, the embeddings on the first stage, the final norm
    and the tied head's copy of the embedding on the last)."""
    from apex_tpu_torch.mesh.pipeline import stage_param_names
    from apex_tpu_torch.models.gpt import gpt_param_specs

    mesh = mesh if mesh is not None else current_mesh()
    specs = {n: tuple(MODEL_AXIS if a == ps.TENSOR_AXIS else a for a in s)
             for n, s in gpt_param_specs(params).items()}
    pipe = mesh.shape[PIPE_AXIS]
    tied: Tuple[str, ...] = ()
    if pipe > 1:
        keep = stage_param_names(list(specs), pipe, mesh.coords[PIPE_AXIS],
                                 num_model_chunks)
        specs = {n: specs[n] for n in keep}
        tied = ("embedding.weight",)
    return ShardingPlan(mesh=mesh, param_specs=specs, tied=tied)


def shard_params(plan: ShardingPlan, params):
    return plan.shard_params(params)


def shard_state(plan: ShardingPlan, state):
    return plan.shard_state(state)


def shard_batch(plan: ShardingPlan, batch):
    return plan.shard_batch(batch)


# -- the train step over this rank's shard -----------------------------------


class MeshTrainStep:
    """One training step of this rank's shard ``model`` (a module built
    under the plan's mesh, e.g. a ``GPTModel``) over ``plan``:
    ``state, loss = step(state, tokens, labels)`` with the whole
    batch, of which this data rank takes its rows. ``loss_fn(model,
    tokens, labels)`` defaults to GPT's. ``init(params=None)`` gives the
    optimizer state over the model's parameters, after loading this
    rank's slice of ``params`` (full-size, by name) when given."""

    def __init__(self, model: torch.nn.Module, optimizer, plan: ShardingPlan,
                 *, loss_fn: Optional[Callable[..., torch.Tensor]] = None):
        from apex_tpu_torch.models.pretrain import PretrainStep
        from apex_tpu_torch.parallel.distributed import \
            DistributedDataParallel

        sizes = plan.mesh.shape
        self._check_layout(sizes)
        self.model = model
        self.opt = optimizer
        self.plan = plan
        self._data = plan.mesh.group(BATCH_AXIS)
        ddp = DistributedDataParallel() if sizes[BATCH_AXIS] > 1 else None
        self.inner = PretrainStep(model, optimizer, loss_fn=loss_fn,
                                  grad_reduce=ddp)

    def _check_layout(self, sizes: Dict[str, int]) -> None:
        if sizes[PIPE_AXIS] > 1:
            raise NotImplementedError(
                f"a mesh with pipe={sizes[PIPE_AXIS]}: MeshTrainStep runs "
                "one pipeline stage; the pipe axis takes "
                "mesh.MeshPipelineTrainStep (make_mesh_pipeline_train_step)")

    def init(self, params: Optional[Mapping[str, torch.Tensor]] = None):
        """The optimizer state over this rank's shard, carrying the
        plan's :meth:`ShardingPlan.norms`; a segmented FusedLAMB lays
        the :meth:`ShardingPlan.cross_rank_names` out of its small
        segments."""
        from apex_tpu_torch.optimizers.fused import FusedLAMB

        own = dict(self.model.named_parameters())
        if params is not None:
            mine = self.plan.shard_params(params)
            with torch.no_grad():
                for n, p in own.items():
                    p.copy_(mine[n])
        split = self.plan.cross_rank_names(own)
        if split and isinstance(self.opt, FusedLAMB) and self.opt.segmented:
            state = self.opt.init(own, split=split)
        else:
            state = self.opt.init(own)
        state = state._replace(norms=self.plan.norms(state.space))
        self.inner.bind(state)
        return state

    @property
    def grad(self) -> Optional[torch.Tensor]:
        """This rank's flat gradient of the last step (reduced over the
        data group)."""
        return self.inner.grad

    def step(self, state, tokens, labels):
        tokens = self.plan.shard_batch(tokens)
        labels = self.plan.shard_batch(labels)
        state, loss = self.inner(state, tokens, labels)
        return state, self._data_mean(loss)

    def _data_mean(self, loss: torch.Tensor) -> torch.Tensor:
        """The data ranks' losses averaged (the loss itself on one)."""
        group, ranks = self._data
        if group is not None:
            loss = loss.clone()
            dist.all_reduce(loss, group=group)
            loss = loss / torch.full((), float(len(ranks)),
                                     device=loss.device)
        return loss

    __call__ = step


def make_mesh_train_step(model, optimizer, plan: ShardingPlan, *,
                         loss_fn=None) -> MeshTrainStep:
    """:class:`MeshTrainStep` of ``model`` (this rank's shard) over
    ``plan``."""
    return MeshTrainStep(model, optimizer, plan, loss_fn=loss_fn)


__all__ = [
    "BATCH_AXIS", "MESH_AXES", "MODEL_AXIS", "PIPE_AXIS", "Mesh",
    "MeshTrainStep", "ShardingPlan", "axis_sizes",
    "current_mesh", "destroy_mesh", "initialize_mesh",
    "make_mesh_train_step", "mesh_initialized", "mesh_size", "plan_gpt",
    "shard_batch", "shard_params", "shard_state",
]
