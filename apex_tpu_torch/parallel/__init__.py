"""Parallel utilities (counterpart of ``apex_tpu/parallel/``). Ported
so far, for one device: `SyncBatchNorm` (the reference's one-pass
statistics; synchronising across devices raises until the distributed
slice), `create_syncbn_group_assignment` and `LARC`."""

from apex_tpu_torch.parallel.larc import LARC
from apex_tpu_torch.parallel.sync_batchnorm import (
    SyncBatchNorm,
    create_syncbn_group_assignment,
)

__all__ = ["LARC", "SyncBatchNorm", "create_syncbn_group_assignment"]
