"""The pretraining step on one device (GPT by default, or any model with
its loss).

Counterpart of ``apex_tpu/models/pretrain.py`` (``init_gpt_pretrain_params``
:32, ``make_gpt_pretrain_step`` :42) and of the step it builds on one
device, ``apex_tpu/mesh/mesh.py`` ``MeshTrainStep`` (:270) at the
identity plan: the loss's value and its gradient with respect to the
flat master, then ``opt.step_flat``. The loop reads as the
reference's::

    model = init_gpt_pretrain_params(cfg, generator)
    step, state = make_gpt_pretrain_step(cfg, FusedAdam(lr))(model)
    step, state = make_gpt_pretrain_step(
        cfg, FusedLAMB(lr, weight_decay=0.01, max_grad_norm=1.0))(model)
    state, loss = step(state, tokens, labels)

Another model trains through the same step with its loss, as the
reference's ``MeshTrainStep(loss_fn=...)`` composes it (BERT-Large
pretraining, ``bench.py`` :852-862)::

    def loss_fn(model, tokens, attn, tokentypes, labels, loss_mask, nsp):
        return bert_loss_fn(*model(tokens, attn, tokentypes), labels,
                            loss_mask, nsp)

    step = PretrainStep(BertModel(cfg), FusedLAMB(lr, weight_decay=0.01,
                        max_grad_norm=1.0, use_nvlamb=True), loss_fn=loss_fn)
    state = step.init()
    state, loss = step(state, tokens, attn, tokentypes, labels, loss_mask,
                       nsp)

ResNet-50 trains the same way (``examples/imagenet/main_amp.py``), its
BatchNorm running statistics module buffers that the forward updates;
under amp O2 the step goes through ``make_train_step`` with the
dynamic loss scaler::

    model = ResNet(ResNetConfig.resnet50(dtype=torch.float16))
    opt = FusedSGD(lr=0.1, momentum=0.9, weight_decay=1e-4)
    _, state, amp_state = amp.initialize(dict(model.named_parameters()),
                                         opt, opt_level="O2")
    step = PretrainStep(model, opt, loss_fn=lambda m, x, y:
                        cross_entropy_logits(m(x), y),
                        train_step=make_train_step(
                            opt, scaler=amp.make_scaler(amp_state.properties)))
    state, scaler_state, loss = step(state, images, labels,
                                     scaler_state=amp_state.scalers[0])

The model's parameters are bound as views into the optimizer's flat
master and their ``.grad`` into one flat gradient buffer of the
master's dtype (``FlatSpace.bind``), whatever the master's layout: the
plain one, or FusedLAMB's segmented one, whose offsets differ. A bf16
master (``master_dtype=torch.bfloat16, stochastic_rounding=True``) takes
a model cast to bf16 (``model.bfloat16()``): its gradient buffer is
bf16 as PyTorch keeps a ``.grad`` in its parameter's dtype (the
reference's ``jax.grad`` of a bf16 master is bf16 too, ``pretrain.py``
:136-137), and ``step_flat`` reads it as fp32. The backward pass
accumulates straight into the flat gradient and the in-place optimizer
sweep is the weight update. On CUDA the step runs the LayerNorm and
flash-attention kernels forward and backward and the optimizer's
kernels (Adam; or LAMB's sum of squares for its clip, the one-pass
segment kernel and the two stages over the large leaves); on the CPU
their plain versions.

Dropout: ``step(state, *batch, dropout_key=key)`` (and ``backward``)
pass a per-step key to the loss as ``loss_fn(model, *batch,
dropout_key=key)``, the counterpart of the reference's user feeding
``rngs={"dropout": key}`` into ``apply`` (``tests/test_bert.py``):
the model then runs with ``deterministic=False``. Without a key the step
is as before, deterministic.

Data parallelism: ``PretrainStep(..., grad_reduce=ddp)`` (a
``parallel.DistributedDataParallel``, or any callable that reduces the
flat gradient in place) reduces the flat gradient over the data axis
between the backward pass and the update, one collective a step. The
update (and under a loss scaler its ``found_inf``) reads the reduced
gradient, as the reference's ``opt.step`` reads the all-reduced one: an
inf on one rank skips the step on every rank. Without it the step is as
before.

The mesh (``make_gpt_pretrain_step(..., mesh=...)``, or the live one of
``mesh.initialize_mesh``): ``build(model)`` takes the full model, as the
reference's ``build(params)`` takes the full tree (:82-130), and returns
a ``mesh.MeshTrainStep`` over this rank's shard of it (a ``GPTModel``
at the mesh's ``model`` size, its slice of the full parameters, on the
full model's device or ``build(model, device=...)``) with its state;
the step takes the whole batch, of which each data rank trains its rows,
the gradient all-reduced over the data group::

    mesh.initialize_mesh(model=2)               # in each rank of a world
    model = init_gpt_pretrain_params(cfg, generator)      # the full model
    step, state = make_gpt_pretrain_step(cfg, FusedAdam(lr))(model)
    state, loss = step(state, tokens, labels)

A mesh with ``pipe > 1`` runs a pipeline schedule (the reference's
:92-108): ``build`` cuts this rank's stage (``mesh.pipeline.GPTStage``,
tp-sharded within) from the full model and returns a
``mesh.MeshPipelineTrainStep`` running ``schedule`` over
``num_microbatches`` (``interleaved_1f1b`` with ``num_model_chunks``
chunks a stage when that is more than one), ``remat`` checkpointing each
layer::

    mesh.initialize_mesh(pipe=2)                # in each rank of a world
    step, state = make_gpt_pretrain_step(cfg, FusedAdam(lr),
                                         schedule="1f1b",
                                         num_microbatches=8)(model)
    state, loss = step(state, tokens, labels)

At one pipeline stage ``schedule``, ``num_microbatches``,
``num_model_chunks`` and ``remat`` have no effect, as in the reference.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from apex_tpu_torch._backend import DeviceLike
from apex_tpu_torch.amp.scaler import ScalerState
from apex_tpu_torch.models.gpt import GPTConfig, GPTModel, gpt_loss_fn
from apex_tpu_torch.optimizers.fused import FlatFusedOptimizer, FlatOptState
from apex_tpu_torch.optimizers.train_step import TrainStep


def init_gpt_pretrain_params(cfg: GPTConfig,
                             generator: Optional[torch.Generator] = None,
                             *, device: DeviceLike = None) -> GPTModel:
    """The full :class:`GPTModel` of ``cfg`` (whatever the topology) with
    weights drawn from ``generator``, on ``device`` (CUDA unless the
    caller names another) — the model whose parameters the step trains,
    or whose shards it trains on a mesh."""
    return GPTModel(cfg, device=device, generator=generator, axis_name=None)


def _gpt_loss(model: GPTModel, tokens, labels,
              dropout_key=None) -> torch.Tensor:
    return gpt_loss_fn(model(tokens.long(),
                             deterministic=dropout_key is None,
                             dropout_key=dropout_key), labels,
                       axis_name=model.axis)


class PretrainStep:
    """One fused training step of ``model`` on one device:
    ``state, loss = step(state, *batch)``, ``loss`` a 0-d fp32 tensor.

    ``loss_fn(model, *batch)`` gives the loss of one batch (each item
    moved to the master's device first); the default is GPT's,
    ``batch = (tokens, labels)``, both (b, s). A step given a
    ``dropout_key`` calls ``loss_fn(model, *batch, dropout_key=key)``.
    ``train_step`` (a
    :class:`~apex_tpu_torch.optimizers.TrainStep` of ``optimizer``, from
    ``make_train_step``) takes the update instead of
    ``optimizer.step_flat``; with a loss scaler the backward pass runs
    on the scaled loss and the call is ``state, scaler_state, loss =
    step(state, *batch, scaler_state=...)``. ``grad_reduce(grad)``,
    when given, reduces the flat gradient in place before the update."""

    def __init__(self, model: torch.nn.Module, optimizer: FlatFusedOptimizer,
                 *, loss_fn: Optional[Callable[..., torch.Tensor]] = None,
                 train_step: Optional[TrainStep] = None,
                 grad_reduce: Optional[Callable[[torch.Tensor], Any]] = None):
        if train_step is not None and train_step.opt is not optimizer:
            raise ValueError("train_step was built for another optimizer")
        self.model = model
        self.opt = optimizer
        self.loss_fn = _gpt_loss if loss_fn is None else loss_fn
        self.train_step = train_step
        self.grad_reduce = grad_reduce
        self._grad: Optional[torch.Tensor] = None
        self._bound: Optional[torch.Tensor] = None

    def init(self) -> FlatOptState:
        """The optimizer state for the model's parameters (in the
        optimizer's own flat layout), with the parameters bound to its
        master."""
        state = self.opt.init(dict(self.model.named_parameters()))
        self._bind(state)
        return state

    def bind(self, state: FlatOptState) -> None:
        """Bind the model's parameters to ``state``'s master (a step
        whose update may skip writes a new master; the model follows
        it at the next call, or now through this)."""
        self._bind(state)

    def _bind(self, state: FlatOptState) -> None:
        if self._grad is None or self._grad.shape != state.master.shape:
            self._grad = torch.zeros_like(state.master)
        state.space.bind(self.model, state.master, self._grad)
        self._bound = state.master

    def backward(self, state: FlatOptState, *batch,
                 scaler_state: Optional[ScalerState] = None,
                 dropout_key=None) -> torch.Tensor:
        """The loss of one batch, its gradient (of the loss scaled by
        ``scaler_state``'s scale, when given) in the flat buffer
        ``grad``, the model bound to ``state``'s master first.
        ``dropout_key`` (a (2,) tensor or pair of uint32 words) turns
        the model's dropout on for this batch."""
        if state.master is not self._bound:
            self._bind(state)       # a state the model is not bound to
        dev = state.master.device
        batch = [torch.as_tensor(t, device=dev) for t in batch]
        self._grad.zero_()
        if dropout_key is None:
            loss = self.loss_fn(self.model, *batch)
        else:
            loss = self.loss_fn(self.model, *batch,
                                dropout_key=dropout_key)
        if scaler_state is None:
            loss.backward()
        else:
            self.train_step.scaler.scale_loss(loss, scaler_state).backward()
        return loss.detach()

    @property
    def grad(self) -> Optional[torch.Tensor]:
        """The flat gradient of the last :meth:`backward`, in the
        master's dtype."""
        return self._grad

    def step(self, state: FlatOptState, *batch,
             scaler_state: Optional[ScalerState] = None, dropout_key=None):
        scaler = None if self.train_step is None else self.train_step.scaler
        if (scaler is None) != (scaler_state is None):
            raise ValueError("pass scaler_state exactly when the step's "
                             "train_step has a loss scaler")
        loss = self.backward(state, *batch, scaler_state=scaler_state,
                             dropout_key=dropout_key)
        if self.grad_reduce is not None:
            self.grad_reduce(self._grad)
        if self.train_step is None:
            _, new_state = self.opt.step_flat(state, self._grad)
            return new_state, loss
        if scaler is None:
            new_state, _ = self.train_step(state, self._grad)
            return new_state, loss
        new_state, scaler_state, _ = self.train_step(state, self._grad,
                                                     scaler_state)
        return new_state, scaler_state, loss

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
    """Returns ``build(model, device=None) -> (step, state)``: without a
    mesh (neither ``mesh`` nor a live one) ``step`` is a
    :class:`PretrainStep` over ``model`` (a :class:`GPTModel` of
    ``cfg``); on a mesh, a ``mesh.MeshTrainStep`` over this rank's shard
    of the full ``model`` (on ``device``, else the model's), or with
    ``pipe > 1`` a ``mesh.MeshPipelineTrainStep`` over this rank's stage;
    ``state`` its optimizer state."""

    def build(model: GPTModel, *, device: DeviceLike = None):
        from apex_tpu_torch import mesh as gmesh

        if model.config != cfg:
            raise ValueError("the model's config is not the step's config")
        live = mesh if mesh is not None else (
            gmesh.current_mesh() if gmesh.mesh_initialized() else None)
        if live is None:
            step = PretrainStep(model, optimizer)
            return step, step.init()
        if model.axis.size > 1:
            raise ValueError("build takes the full model (a GPTModel built "
                             "with axis_name=None, as "
                             "init_gpt_pretrain_params builds it)")
        full = dict(model.named_parameters())
        dev = (device if device is not None
               else next(iter(full.values())).device)
        pp = live.shape[gmesh.PIPE_AXIS]
        if pp > 1:
            chunks = max(num_model_chunks, 1)
            spec = gmesh.PipelineSpec(
                schedule=("interleaved_1f1b" if num_model_chunks > 1
                          else schedule),
                num_stages=pp, num_microbatches=num_microbatches,
                num_model_chunks=chunks)
            plan = gmesh.plan_gpt(model, mesh=live, num_model_chunks=chunks)
            stage = gmesh.pipeline.GPTStage(
                cfg, spec, live.coords[gmesh.PIPE_AXIS], params=full,
                device=dev)
            step = gmesh.make_mesh_pipeline_train_step(
                stage, optimizer, plan, spec, remat=remat)
            return step, step.init()
        plan = gmesh.plan_gpt(model, mesh=live)
        shard = (model if plan.is_identity() and device is None else
                 GPTModel(cfg, device=dev, params=full))
        step = gmesh.make_mesh_train_step(shard, optimizer, plan)
        return step, step.init()

    return build


__all__ = ["PretrainStep", "init_gpt_pretrain_params",
           "make_gpt_pretrain_step"]
