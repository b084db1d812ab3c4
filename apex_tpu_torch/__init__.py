"""PyTorch/CUDA port of ``apex_tpu`` for NVIDIA Hopper (H100).

Module paths mirror ``apex_tpu/`` so each counterpart is easy to find.
Every op that ``apex_tpu`` runs as a Pallas kernel is a hand-written
CUDA kernel here (``csrc/``, built with ``nvcc`` at first use by
``_build.py``) beside a plain PyTorch version of the same function: a
CUDA tensor goes to the kernel, a CPU tensor to the plain version.
Entry points run on the CUDA device unless the caller passes
``device="cpu"``, and raise when no CUDA device is present.

This package imports neither JAX nor ``apex_tpu``; the tests hold it
against ``apex_tpu`` on the same inputs and weights.

Ported so far: the GPT serving path (``models.gpt``,
``serving.{kv_cache,decode,scheduler}``), single-device GPT and BERT
pretraining (``models.pretrain``, ``optimizers``, ``amp``,
``multi_tensor``, ``ops``) and ResNet-50 ImageNet training
(``models.resnet``, ``parallel``, ``contrib.bottleneck``, FusedSGD,
FusedLARS and LARC), T5 (``models.t5``), amp's function-level casts
(``amp.F``, ``amp.scale_loss``) and the gen-1 ``fp16_utils``, and
data-parallel training over ``torch.distributed``
(``transformer.parallel_state``, ``parallel.DistributedDataParallel``,
cross-device ``parallel.SyncBatchNorm``, ``parallel.multiproc``), on
the kernels of ``csrc/``.
"""

from apex_tpu_torch._backend import resolve_device
from apex_tpu_torch import fp16_utils  # noqa: E402,F401

__all__ = ["fp16_utils", "resolve_device"]
