"""ZeRO-style sharded fused optimizers (the reference's
``apex_tpu/contrib/optimizers``): :class:`DistributedFusedAdam` and
:class:`DistributedFusedLAMB` over a ``parallel_state`` axis, each rank
holding one shard of the flat state (:class:`DistFlatOptState`)."""

from apex_tpu_torch.contrib.optimizers.distributed import (
    DistFlatOptState,
    DistributedFusedAdam,
    DistributedFusedLAMB,
    ShardLayout,
    e5m2_bits,
)

__all__ = ["DistFlatOptState", "DistributedFusedAdam",
           "DistributedFusedLAMB", "ShardLayout", "e5m2_bits"]
