"""Data-parallel runtime (counterpart of ``apex_tpu/parallel/``):
`DistributedDataParallel` (the gradient all-reduce policy over the data
axis's process group), `Reducer`, `sync_deviation`, `SyncBatchNorm`
(synchronised across the data axis) with `convert_syncbn_model` and the
BN groups, `LARC`, and `multiproc` (the process bootstrap and a
launcher)."""

from apex_tpu_torch.parallel import multiproc
from apex_tpu_torch.parallel.distributed import (
    DistributedDataParallel,
    Reducer,
    sync_deviation,
)
from apex_tpu_torch.parallel.larc import LARC, larc_transform
from apex_tpu_torch.parallel.sync_batchnorm import (
    SyncBatchNorm,
    convert_syncbn_model,
    create_syncbn_group_assignment,
)

__all__ = ["DistributedDataParallel", "LARC", "Reducer", "SyncBatchNorm",
           "convert_syncbn_model", "create_syncbn_group_assignment",
           "larc_transform", "multiproc", "sync_deviation"]
