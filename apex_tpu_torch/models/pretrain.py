"""The GPT pretraining step on one device.

Counterpart of ``apex_tpu/models/pretrain.py`` (``init_gpt_pretrain_params``
:32, ``make_gpt_pretrain_step`` :42) and of the step it builds on one
device, ``apex_tpu/mesh/mesh.py`` ``MeshTrainStep`` (:270) at the
identity plan: the loss's value and its gradient with respect to the
flat fp32 master, then ``opt.step_flat``. The loop reads as the
reference's::

    model = init_gpt_pretrain_params(cfg, generator)
    step, state = make_gpt_pretrain_step(cfg, FusedAdam(lr))(model)
    state, loss = step(state, tokens, labels)

The model's parameters are bound as views into the optimizer's flat
master and their ``.grad`` into one flat fp32 gradient buffer
(``FlatSpace.bind``): the backward pass accumulates straight into the
flat gradient and the in-place Adam sweep is the weight update. On CUDA
the step runs the LayerNorm and flash-attention kernels forward and
backward and the Adam kernel; on the CPU their plain versions.

The mesh (data, tensor and pipeline parallelism) waits for the
distributed slice: ``mesh=`` and interleaved pipeline chunks raise.
``schedule``, ``num_microbatches`` and ``remat`` are accepted and, as in
the reference at one pipeline stage, have no effect.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from apex_tpu_torch._backend import DeviceLike
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel, gpt_loss_fn
from apex_tpu_torch.optimizers.fused import FlatFusedOptimizer, FlatOptState


def init_gpt_pretrain_params(cfg: GPTConfig,
                             generator: Optional[torch.Generator] = None,
                             *, device: DeviceLike = None) -> GPTModel:
    """A :class:`GPTModel` of ``cfg`` with weights drawn from
    ``generator``, on ``device`` (CUDA unless the caller names
    another) — the model whose parameters the step trains."""
    return GPTModel(cfg, device=device, generator=generator)


class PretrainStep:
    """One fused training step of ``model`` on one device:
    ``state, loss = step(state, tokens, labels)`` (``tokens`` and
    ``labels`` (b, s); ``loss`` a 0-d fp32 tensor)."""

    def __init__(self, model: GPTModel, optimizer: FlatFusedOptimizer):
        self.model = model
        self.opt = optimizer
        self._grad: Optional[torch.Tensor] = None
        self._bound: Optional[torch.Tensor] = None

    def init(self) -> FlatOptState:
        """The optimizer state for the model's parameters, with the
        parameters bound to its master."""
        state = self.opt.init(dict(self.model.named_parameters()))
        self._bind(state)
        return state

    def _bind(self, state: FlatOptState) -> None:
        if self._grad is None or self._grad.shape != state.master.shape:
            self._grad = torch.zeros_like(state.master)
        state.space.bind(self.model, state.master, self._grad)
        self._bound = state.master

    def step(self, state: FlatOptState, tokens,
             labels) -> Tuple[FlatOptState, torch.Tensor]:
        if state.master is not self._bound:
            self._bind(state)       # a state the model is not bound to
        dev = state.master.device
        tokens = torch.as_tensor(tokens, device=dev).long()
        labels = torch.as_tensor(labels, device=dev).long()
        self._grad.zero_()
        loss = gpt_loss_fn(self.model(tokens), labels)
        loss.backward()
        _, new_state = self.opt.step_flat(state, self._grad)
        return new_state, loss.detach()

    __call__ = step


def make_gpt_pretrain_step(
    cfg: GPTConfig,
    optimizer: FlatFusedOptimizer,
    *,
    schedule: str = "1f1b",
    num_microbatches: int = 4,
    remat: bool = True,
    num_model_chunks: int = 1,
    mesh=None,
):
    """Returns ``build(model) -> (step, state)``: ``step`` a
    :class:`PretrainStep` over ``model`` (a :class:`GPTModel` of
    ``cfg``), ``state`` its optimizer state."""
    if mesh is not None:
        raise NotImplementedError(
            "mesh= (data, tensor and pipeline parallelism) is not ported "
            "yet; the pretrain step runs on one device")
    if num_model_chunks > 1:
        raise NotImplementedError(
            f"num_model_chunks={num_model_chunks}: pipeline parallelism "
            "(more than one pipe stage) is not ported yet")

    def build(model: GPTModel) -> Tuple[PretrainStep, FlatOptState]:
        if model.config != cfg:
            raise ValueError("the model's config is not the step's config")
        step = PretrainStep(model, optimizer)
        return step, step.init()

    return build


__all__ = ["PretrainStep", "init_gpt_pretrain_params",
           "make_gpt_pretrain_step"]
