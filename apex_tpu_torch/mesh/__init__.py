"""The mesh: one named layout of the ranks for training and serving.

Counterpart of ``apex_tpu/mesh/`` (``__init__.py``'s ``__all__``,
:48-55 for the pipeline):

- :mod:`~apex_tpu_torch.mesh.mesh`: the process-global mesh (``batch`` /
  ``pipe`` / ``model`` over ``transformer.parallel_state``),
  :class:`ShardingPlan` and :class:`MeshTrainStep` over this rank's
  shard; every entry point is the identity on a mesh of one rank;
- :mod:`~apex_tpu_torch.mesh.annotate`: a model-sharded GPT checkpoint
  and a KV pool of this rank's kv heads for serving;
- :mod:`~apex_tpu_torch.mesh.pipeline`: :class:`PipelineSpec`, the GPipe,
  1F1B, interleaved and async schedules over the ``pipe`` axis (a stage a
  rank, explicit boundary transfers), :func:`make_pipeline_loss_fn` and
  :class:`MeshPipelineTrainStep`;
- :mod:`~apex_tpu_torch.mesh.planner`: the (dp, tp, pp, schedule,
  microbatches) layout search, returning a ranked :class:`LayoutPlan`.
"""

from apex_tpu_torch.mesh import annotate, pipeline, planner
from apex_tpu_torch.mesh.mesh import (
    BATCH_AXIS,
    MESH_AXES,
    MODEL_AXIS,
    PIPE_AXIS,
    Mesh,
    MeshTrainStep,
    ShardingPlan,
    axis_sizes,
    current_mesh,
    destroy_mesh,
    initialize_mesh,
    make_mesh_train_step,
    mesh_initialized,
    mesh_size,
    plan_gpt,
    shard_batch,
    shard_params,
    shard_state,
)
from apex_tpu_torch.mesh.pipeline import (
    SCHEDULES,
    MeshPipelineTrainStep,
    PipelineSpec,
    bubble_fraction,
    make_mesh_pipeline_train_step,
    make_pipeline_loss_fn,
)
from apex_tpu_torch.mesh.planner import (
    LayoutPlan,
    LayoutScore,
    enumerate_layouts,
    measured_link_gbps,
    plan_for_config,
    plan_layout,
    publish_plan,
)

__all__ = [
    "BATCH_AXIS",
    "MESH_AXES",
    "MODEL_AXIS",
    "PIPE_AXIS",
    "SCHEDULES",
    "LayoutPlan",
    "LayoutScore",
    "Mesh",
    "MeshPipelineTrainStep",
    "MeshTrainStep",
    "PipelineSpec",
    "ShardingPlan",
    "annotate",
    "axis_sizes",
    "bubble_fraction",
    "current_mesh",
    "destroy_mesh",
    "enumerate_layouts",
    "initialize_mesh",
    "make_mesh_pipeline_train_step",
    "make_mesh_train_step",
    "make_pipeline_loss_fn",
    "measured_link_gbps",
    "mesh_initialized",
    "mesh_size",
    "pipeline",
    "plan_for_config",
    "plan_gpt",
    "plan_layout",
    "planner",
    "publish_plan",
    "shard_batch",
    "shard_params",
    "shard_state",
]
