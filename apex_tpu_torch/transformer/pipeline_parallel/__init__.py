"""The pipeline-parallel toolbox (counterpart of
``apex_tpu/transformer/pipeline_parallel/``, ``__init__.py:1-29``): the
microbatch calculators, microbatch slicing, the data-group loss average,
the parameter norm, the left-to-right masks and the Timers. The
schedules themselves run over the mesh's ``pipe`` axis in
:mod:`apex_tpu_torch.mesh.pipeline`, as the reference's do."""

from apex_tpu_torch.transformer.pipeline_parallel.microbatches import (
    ConstantNumMicroBatches,
    RampupBatchsizeNumMicroBatches,
    build_num_microbatches_calculator,
)
from apex_tpu_torch.transformer.pipeline_parallel.utils import (
    Timers,
    average_losses_across_data_parallel_group,
    calc_params_l2_norm,
    get_current_global_batch_size,
    get_kth_microbatch,
    get_ltor_masks_and_position_ids,
    get_micro_batch_size,
    get_num_microbatches,
    get_timers,
    setup_microbatch_calculator,
    update_num_microbatches,
)

__all__ = [
    "ConstantNumMicroBatches", "RampupBatchsizeNumMicroBatches", "Timers",
    "average_losses_across_data_parallel_group",
    "build_num_microbatches_calculator", "calc_params_l2_norm",
    "get_current_global_batch_size", "get_kth_microbatch",
    "get_ltor_masks_and_position_ids", "get_micro_batch_size",
    "get_num_microbatches", "get_timers", "setup_microbatch_calculator",
    "update_num_microbatches",
]
