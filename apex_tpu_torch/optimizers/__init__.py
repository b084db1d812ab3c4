"""Fused optimizers over the flat parameter space (counterpart of
``apex_tpu/optimizers/``). Ported so far: `FusedAdam` (the Adam kernel,
``csrc/fused_adam.cu``), `FusedLAMB` (the sum-of-squares, LAMB stage
and one-pass segment kernels), `FusedSGD` and `FusedLARS`
(``csrc/fused_sgd.cu``; LARS's norms on the sum-of-squares kernel) and
`make_train_step` with the loss scaler, the global-norm clip and the
grad-norm report. The other optimizers wait for their kernels;
`FusedMixedPrecisionLamb` raises."""

from apex_tpu_torch.optimizers.fused import (
    FlatFusedOptimizer,
    FlatOptState,
    FusedAdam,
    FusedLAMB,
    FusedLARS,
    FusedMixedPrecisionLamb,
    FusedSGD,
)
from apex_tpu_torch.optimizers.train_step import (
    StepAux,
    TrainStep,
    make_train_step,
)

__all__ = ["FlatFusedOptimizer", "FlatOptState", "FusedAdam", "FusedLAMB",
           "FusedLARS", "FusedMixedPrecisionLamb", "FusedSGD", "StepAux",
           "TrainStep", "make_train_step"]
