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
``serving.{kv_cache,decode,scheduler}``) and the single-device GPT
pretraining step (``models.pretrain``, ``optimizers``, ``amp.scaler``,
``multi_tensor``), on the LayerNorm forward and backward, flash-attention
forward, dq and dk/dv, and fused-Adam kernels.
"""

from apex_tpu_torch._backend import resolve_device

__all__ = ["resolve_device"]
