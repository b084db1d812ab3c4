"""Fused optimizers over the flat parameter space (counterpart of
``apex_tpu/optimizers/``): `FusedAdam` (the Adam kernel,
``csrc/fused_adam.cu``), `FusedLAMB` (the sum-of-squares, LAMB stage
and one-pass segment kernels), `FusedSGD` and `FusedLARS`
(``csrc/fused_sgd.cu``; LARS's norms on the sum-of-squares kernel),
`FusedNovoGrad` and `FusedAdagrad` (``csrc/adagrad_novograd.cu``;
NovoGrad's per-leaf norms on the sum-of-squares kernel), `as_optax`
(an init / update pair over name -> tensor mappings) and
`make_train_step` with the loss scaler, the global-norm clip and the
grad-norm report. `FusedMixedPrecisionLamb` (a bf16 master with
stochastic rounding) raises."""

from apex_tpu_torch.optimizers.fused import (
    FlatFusedOptimizer,
    FlatOptState,
    FusedAdagrad,
    FusedAdam,
    FusedLAMB,
    FusedLARS,
    FusedMixedPrecisionLamb,
    FusedNovoGrad,
    FusedSGD,
)
from apex_tpu_torch.optimizers.optax_adapter import (
    GradientTransformation,
    as_optax,
)
from apex_tpu_torch.optimizers.train_step import (
    StepAux,
    TrainStep,
    make_train_step,
)

__all__ = ["FlatFusedOptimizer", "FlatOptState", "FusedAdagrad", "FusedAdam",
           "FusedLAMB", "FusedLARS", "FusedMixedPrecisionLamb",
           "FusedNovoGrad", "FusedSGD", "GradientTransformation", "StepAux",
           "TrainStep", "as_optax", "make_train_step"]
