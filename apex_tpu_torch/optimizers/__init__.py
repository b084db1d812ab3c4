"""Fused optimizers over the flat parameter space (counterpart of
``apex_tpu/optimizers/``). Ported so far: `FusedAdam` (the Adam kernel,
``csrc/fused_adam.cu``) and `make_train_step` with the loss scaler.
FusedLAMB and the other optimizers wait for their kernels."""

from apex_tpu_torch.optimizers.fused import (
    FlatFusedOptimizer,
    FlatOptState,
    FusedAdam,
    FusedLAMB,
)
from apex_tpu_torch.optimizers.train_step import (
    StepAux,
    TrainStep,
    make_train_step,
)

__all__ = ["FlatFusedOptimizer", "FlatOptState", "FusedAdam", "FusedLAMB",
           "StepAux", "TrainStep", "make_train_step"]
