"""Parallel utilities (counterpart of ``apex_tpu/parallel/``). Ported
so far, for one device: `SyncBatchNorm` (the reference's one-pass
statistics; synchronising across devices raises until the distributed
slice), `create_syncbn_group_assignment`, `LARC` and `larc_transform`."""

from apex_tpu_torch.parallel.larc import LARC, larc_transform
from apex_tpu_torch.parallel.sync_batchnorm import (
    SyncBatchNorm,
    create_syncbn_group_assignment,
)

__all__ = ["LARC", "SyncBatchNorm", "create_syncbn_group_assignment",
           "larc_transform"]
