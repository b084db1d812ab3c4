"""Rank-side code of the pipeline-parallel parity tests
(tests/test_torch_pipeline.py, tests/test_torch_pp_cuda.py).

Each function runs in every rank of a world that
``apex_tpu_torch.parallel.multiproc.launch`` spawns (gloo over a file
rendezvous), takes the inputs of every rank (numpy: the reference's
parameter trees and the batches from the tests' seeds) and returns this
rank's results as numpy. It imports the port only: the reference runs in
the pytest process.
"""

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch import mesh as gmesh
from apex_tpu_torch.mesh.pipeline import (GPTStage, PipelineSpec,
                                          make_mesh_pipeline_train_step,
                                          make_pipeline_loss_fn)
from apex_tpu_torch.models import (GPTConfig, GPTModel, gpt_param_specs,
                                   gpt_shard_from_jax)
from apex_tpu_torch.models.convert import gpt_params_from_jax
from apex_tpu_torch.optimizers import FusedAdam


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy().copy()
    if isinstance(t, dict):
        return {k: _np(v) for k, v in t.items()}
    return t


def _full(case):
    cfg = GPTConfig(**case["cfg"])
    return cfg, GPTModel(cfg, device="cpu", axis_name=None,
                         params=gpt_params_from_jax(case["tree"], cfg))


def _params(step):
    return {n: _np(p) for n, p in step.model.named_parameters()}


def _grads_in_place(step) -> bool:
    """Every parameter's ``.grad`` is still its view into the flat
    gradient (autograd accumulated in place)."""
    flat = step.grad
    lo, hi = flat.data_ptr(), flat.data_ptr() + flat.numel() * 4
    return all(p.grad is not None and lo <= p.grad.data_ptr() < hi
               for p in step.model.parameters())


def _parity(case, x, y):
    """The loss of each synchronous schedule over the pipe ranks
    (forward only), twice, on this rank's stage of the reference's
    weights."""
    cfg = GPTConfig(**case["cfg"])
    mesh = gmesh.current_mesh()
    out = {}
    for name, args in case["specs"].items():
        spec = PipelineSpec(*args)
        stage = GPTStage(cfg, spec, mesh.coords[gmesh.PIPE_AXIS],
                         params=gpt_params_from_jax(case["tree"], cfg),
                         device="cpu")
        fn = make_pipeline_loss_fn(stage, spec)
        out[name] = [float(fn(stage, x, y)) for _ in range(2)]
    return out


def _train(case, x, y, *, telemetry=False, compare_gpipe=False):
    """``case["steps"]`` steps of ``MeshPipelineTrainStep`` on the
    reference's weights: the losses, the parameters after them, both
    copies of the tied embedding after every step; with ``telemetry``
    the armed planes and a step from pre-sharded params; with
    ``compare_gpipe`` whether a gpipe step 1 equals this one bitwise."""
    from apex_tpu_torch import telemetry as tel
    from apex_tpu_torch.telemetry import comms, metrics, timeline

    cfg, full = _full(case)
    if telemetry:
        tel.reset()
        timeline.enable()
        comms.enable()
    plan = gmesh.plan_gpt(full, num_model_chunks=case["chunks"])
    step = make_mesh_pipeline_train_step(
        full, FusedAdam(lr=case["lr"]), plan, schedule=case["schedule"],
        num_microbatches=case["m"], num_model_chunks=case["chunks"])
    state = step.init()
    out = {"losses": [], "tied": [], "bubble": None}
    for i in range(case["steps"]):
        state, loss = step(state, x, y)
        out["losses"].append(float(loss))
        if hasattr(step.model, "embedding"):
            out["tied"].append(_np(step.model.embedding.weight))
        if i == 0 and compare_gpipe:
            first = (float(loss), state.master.clone())
    out["bubble"] = step.last_bubble_fraction
    out["params"] = _params(step)
    out["in_place"] = _grads_in_place(step)
    out["carried"] = step._pipe_buf is not None
    out["transfers"] = (step.last_transfers.calls, step.last_transfers.bytes)
    if case["schedule"] == "async_1f1b":
        step.reset_pipeline()
        out["reset"] = (step._pipe_buf is None, step._tick0)
        state, loss = step(state, x, y)
        out["after_reset"] = float(loss)
    if telemetry:
        snap = metrics.registry().snapshot()
        out["gauges"] = {k: v for k, v in snap["gauges"].items()
                         if k.startswith("pipeline")}
        out["info"] = snap["info"]["pipeline"]
        out["ledger"] = [r for r in comms.get_tracer().ledger()
                         if r["op"] == "ppermute"]
        out["spans"] = [(s.name, s.args) for s in
                        timeline.get_timeline().spans()
                        if s.category == "pipeline"]
        state2 = step.init(plan.shard_params(dict(full.named_parameters())))
        _, loss2 = step(state2, x, y)
        out["presharded"] = float(loss2)
        out["ledger_after"] = [r for r in comms.get_tracer().ledger()
                               if r["op"] == "ppermute"]
        out["spans_after"] = len([s for s in timeline.get_timeline().spans()
                                  if s.category == "pipeline"])
        tel.reset()
        timeline.disable()
        comms.disable()
    if compare_gpipe:
        other = make_mesh_pipeline_train_step(
            full, FusedAdam(lr=case["lr"]), plan, schedule="gpipe",
            num_microbatches=case["m"])
        s2, l2 = other(other.init(), x, y)
        out["gpipe_bitwise"] = (float(l2) == first[0]
                                and torch.equal(s2.master, first[1]))
    return out


def _tp_grads(case, x, y):
    """One step at this rank's (pipe, tensor) shard: the loss and the
    reduced gradient by name (the step's flat gradient)."""
    cfg, full = _full(case)
    plan = gmesh.plan_gpt(full)
    step = make_mesh_pipeline_train_step(
        full, FusedAdam(lr=case["lr"]), plan, schedule=case["schedule"],
        num_microbatches=case["m"])
    state = step.init()
    state, loss = step(state, x, y)
    return {"loss": float(loss),
            "grads": {n: g.numpy().copy() for n, g in
                      state.space.unpack(step.grad, "buffer").items()},
            "tp_rank": gmesh.current_mesh().coords[gmesh.MODEL_AXIS]}


def _shard_from_jax(case):
    """``gpt_shard_from_jax`` cut by pipe stage equals the stage a full
    model gives."""
    cfg = GPTConfig(**case["cfg"])
    mesh = gmesh.current_mesh()
    spec = PipelineSpec(*case["spec"])
    stage = GPTStage(cfg, spec, mesh.coords[gmesh.PIPE_AXIS],
                     params=gpt_params_from_jax(case["tree"], cfg),
                     device="cpu")
    ax = stage.axis
    got = gpt_shard_from_jax(case["tree"], cfg, gpt_param_specs(stage),
                             ax.index, ax.size,
                             pipe_rank=mesh.coords[gmesh.PIPE_AXIS],
                             pipe=spec.num_stages,
                             num_model_chunks=spec.num_model_chunks)
    own = dict(stage.named_parameters())
    return sorted(got) == sorted(own) and all(
        torch.equal(got[n], own[n].detach()) for n in own)


def _example(case):
    """``examples/pretrain_gpt.py``'s loop at this mesh: 4 steps, then 2
    steps saved and a resume to 4 from the checkpoint."""
    from apex_tpu_torch.examples import pretrain_gpt

    def args(steps, save=""):
        return pretrain_gpt.parse_args(case["argv"] + [
            "--steps", str(steps), "--save", save])

    whole = pretrain_gpt.train(args(4), device="cpu")
    pretrain_gpt.train(args(2, case["dir"]), device="cpu")
    resumed = pretrain_gpt.train(args(4, case["dir"]), device="cpu")
    return {"whole": whole["losses"], "resumed": resumed["losses"],
            "start": resumed["start"],
            "bubble": whole["step"].last_bubble_fraction}


def pp_world(inp):
    """Every case of ``inp["cases"]`` (label -> (mesh axes, kind,
    case)), each on its own mesh."""
    out = {}
    for label, (axes, kind, case) in inp["cases"].items():
        x, y = ((torch.tensor(case["tokens"]).long(),
                 torch.tensor(case["labels"]).long())
                if "tokens" in case else (None, None))
        gmesh.initialize_mesh(**axes)
        try:
            if kind == "parity":
                out[label] = _parity(case, x, y)
            elif kind == "train":
                out[label] = _train(case, x, y,
                                    telemetry=case.get("telemetry", False),
                                    compare_gpipe=case.get("gpipe", False))
            elif kind == "grads":
                out[label] = _tp_grads(case, x, y)
            elif kind == "shard":
                out[label] = _shard_from_jax(case)
            elif kind == "example":
                out[label] = _example(case)
            out[label + ":coords"] = gmesh.current_mesh().coords
        finally:
            gmesh.destroy_mesh()
    out["rank"] = dist.get_rank()
    return out


# -- the card -----------------------------------------------------------------


def cuda_world(inp):
    """Two ranks on one card over gloo: a tiny GPT at pp=2 through each
    schedule, the tied embedding's copies bitwise after every step, gpipe
    and 1f1b bitwise after step 1, the LayerNorm, flash and Adam kernels
    launched on each rank."""
    from apex_tpu_torch import _build
    from apex_tpu_torch.parallel import multiproc

    dev = multiproc.device()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = GPTConfig(**inp["cfg"])
    full = GPTModel(cfg, device="cpu", axis_name=None,
                    generator=torch.Generator().manual_seed(0))
    x = torch.tensor(inp["tokens"], device=dev)
    y = torch.tensor(inp["labels"], device=dev)
    out = {}
    gmesh.initialize_mesh(pipe=2)
    try:
        for name, chunks in (("gpipe", 1), ("1f1b", 1),
                             ("interleaved_1f1b", 2), ("async_1f1b", 1)):
            plan = gmesh.plan_gpt(full, num_model_chunks=chunks)
            stage = GPTStage(cfg, PipelineSpec(name, 2, inp["m"], chunks),
                             gmesh.current_mesh().coords[gmesh.PIPE_AXIS],
                             params=dict(full.named_parameters()), device=dev)
            step = make_mesh_pipeline_train_step(
                stage, FusedAdam(lr=1e-3), plan, schedule=name,
                num_microbatches=inp["m"], num_model_chunks=chunks)
            state = step.init()
            _build.reset_launch_counts()
            losses, tied = [], []
            for i in range(inp["steps"]):
                state, loss = step(state, x, y)
                losses.append(float(loss))
                tied.append(_np(step.model.embedding.weight))
                if i == 0:
                    first = state.master.clone()
            torch.cuda.synchronize()
            out[name] = {"losses": losses, "tied": tied,
                         "launches": _build.launch_counts(),
                         "first_master": first.cpu()}
        return out
    finally:
        gmesh.destroy_mesh()


def utils_world(inp):
    """The pipeline toolbox's collectives at a world of 2: the loss
    average over the data group (tp=1) and the parameter norm over the
    tensor group (tp=2), each rank on its own slice of the inputs."""
    from apex_tpu_torch.transformer import parallel_state as ps
    from apex_tpu_torch.transformer.pipeline_parallel import (
        average_losses_across_data_parallel_group, calc_params_l2_norm)

    r = dist.get_rank()
    out = {}
    ps.initialize_model_parallel()
    try:
        losses = [torch.tensor(a[r]) for a in inp["losses"]]
        out["average"] = _np(average_losses_across_data_parallel_group(
            losses))
    finally:
        ps.destroy_model_parallel()
    ps.initialize_model_parallel(2)
    try:
        shards = {k: torch.tensor(v[r]) for k, v in inp["params"].items()}
        out["norm_sharded"] = float(calc_params_l2_norm(shards))
        out["norm_replicated"] = float(calc_params_l2_norm(
            shards, params_sharded=False))
    finally:
        ps.destroy_model_parallel()
    return out
