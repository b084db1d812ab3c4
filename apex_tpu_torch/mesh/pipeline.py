"""Pipeline parallelism over the mesh's ``pipe`` axis: the GPipe, 1F1B,
interleaved 1F1B and asynchronous schedules.

Counterpart of ``apex_tpu/mesh/pipeline.py`` (:1-725). The reference
writes a schedule as one GSPMD program: a ``(S, seq, mb, hidden)``
boundary buffer constrained to the ``pipe`` axis, every stage row applied
each tick under ``vmap``, ``jnp.roll`` rotating the rows (XLA lowers it
to a collective-permute), and ``jax.grad`` of the tick scan as the
reverse pipeline. PyTorch has no compiler to place those transfers, so
the port's mesh is the explicit one (``mesh.py``): each pipe rank holds
its stage's layers (:class:`GPTStage`), the boundary transfer is a
send and a receive between neighbouring pipe ranks (``_exchange``, the
counterpart of the roll; the wrap from the last rank to the first is the
interleaved chunk boundary), and the schedule drives the backward:
receive the output's gradient, ``torch.autograd.backward`` on the saved
output, send the input's gradient back.

The values are the reference's: the loss is the mean over equal
microbatches of each microbatch's mean cross entropy, summed in
microbatch order; the gradients are those of that loss. Every schedule
runs in lock-step ticks computed once from the schedule (each rank does
at most one forward or backward of one microbatch and model chunk a
tick, then the tick's transfers are exchanged), so no rank waits on a
transfer that is not already posted:

- ``"gpipe"``: every forward, then every backward (microbatch order);
  a rank holds every microbatch's boundary state;
- ``"1f1b"``: ``S - s - 1`` warm-up forwards on stage ``s``, then one
  forward and one backward at a time, then the cool-down; no stage holds
  more than ``S`` microbatches. The backwards run in microbatch order in
  both schedules, so their gradients, like their losses, are bitwise
  GPipe's;
- ``"interleaved_1f1b"``: V model chunks a rank (rank ``s`` holds global
  chunks ``{c * S + s}``); a microbatch crosses the ring V times
  (Megatron's order of chunks and warm-up);
- ``"async_1f1b"``: exactly M ticks a step, the boundary tensors carried
  (detached) from step to step, the labels aligned by ``(j - (S - 1))
  mod M`` and the global warm-up ticks masked out of the mean
  (``_async_step``). Backprop is truncated at the step boundary, as in
  the reference.

A pipe group of one rank runs all S stage rows locally, differentiably,
as the reference does on one device (``_local_loss``,
``_async_local_loss``). ``remat`` checkpoints each layer
(``torch.utils.checkpoint``), so the recompute runs the LayerNorm and
flash kernels again in the backward.

Observability is the reference's (:602-693): ``last_bubble_fraction``,
``last_step_ms``, the ``pipeline_bubble_fraction{schedule,stage}`` and
``pipeline_ticks{schedule}`` gauges, the ``pipeline`` info blob, one
``pipeline:stage{s}`` span a stage (the schedule's analytic geometry
scaled by the measured wall) and one ``ppermute`` record a step in the
comms ledger. Beside it each rank counts its transfers
(``last_transfers``: calls, bytes, and, with ``meter=True``, the
synchronised seconds spent in them) and the tied embedding's all-reduce.
The compile plane and goodput (the reference's :652-667) are ROADMAP
A 10.
"""

from __future__ import annotations

import dataclasses
import datetime
import functools
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from apex_tpu_torch.mesh.mesh import PIPE_AXIS, MeshTrainStep, ShardingPlan
from apex_tpu_torch.transformer import parallel_state as ps

SCHEDULES = ("gpipe", "1f1b", "interleaved_1f1b", "async_1f1b")

#: seconds a blocking boundary receive waits before it raises
TRANSFER_TIMEOUT_S = 600.0


def bubble_fraction(schedule: str, num_stages: int, num_microbatches: int,
                    num_model_chunks: int = 1) -> float:
    """The idle share of one schedule on (stages, microbatches, model
    chunks): ``(s - 1) / (m + s - 1)`` for GPipe and 1F1B, ``(s - 1) /
    (v * m + s - 1)`` interleaved, 0 for the asynchronous schedule's
    steady state and for one stage."""
    s, m, v = int(num_stages), int(num_microbatches), int(num_model_chunks)
    if s <= 1:
        return 0.0
    if schedule == "async_1f1b":
        return 0.0
    if schedule == "interleaved_1f1b":
        return (s - 1) / (v * m + s - 1)
    return (s - 1) / (m + s - 1)


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    """One pipeline schedule, validated: ``num_stages`` stage rows,
    ``num_microbatches`` a step, ``num_model_chunks`` (V) model chunks a
    stage for the interleaved schedule (1 elsewhere). Derived: the ticks
    a step and the analytic bubble."""

    schedule: str = "1f1b"
    num_stages: int = 2
    num_microbatches: int = 4
    num_model_chunks: int = 1

    def __post_init__(self):
        if self.schedule not in SCHEDULES:
            raise ValueError(
                f"unknown schedule {self.schedule!r}; one of {SCHEDULES}")
        if self.num_stages < 1 or self.num_microbatches < 1:
            raise ValueError(
                f"num_stages ({self.num_stages}) and num_microbatches "
                f"({self.num_microbatches}) must be >= 1")
        if self.schedule == "interleaved_1f1b":
            if self.num_model_chunks < 2:
                raise ValueError(
                    "interleaved_1f1b needs num_model_chunks >= 2 "
                    f"(got {self.num_model_chunks}) — with one chunk "
                    "per stage use '1f1b'")
            if self.num_microbatches % self.num_stages:
                raise ValueError(
                    f"interleaved_1f1b needs num_microbatches "
                    f"({self.num_microbatches}) divisible by num_stages "
                    f"({self.num_stages}) — same constraint as the "
                    "reference schedule")
        elif self.num_model_chunks != 1:
            raise ValueError(
                f"schedule {self.schedule!r} runs one model chunk per "
                f"stage (got num_model_chunks={self.num_model_chunks})")

    @property
    def ticks(self) -> int:
        """Ticks one step takes (fine ticks for interleaved)."""
        if self.schedule == "async_1f1b":
            return self.num_microbatches
        return (self.num_model_chunks * self.num_microbatches
                + self.num_stages - 1)

    @property
    def busy_ticks_per_stage(self) -> int:
        """Ticks each stage does real work (the same for every stage)."""
        return self.num_model_chunks * self.num_microbatches

    @property
    def bubble(self) -> float:
        return bubble_fraction(self.schedule, self.num_stages,
                               self.num_microbatches, self.num_model_chunks)

    @property
    def num_chunks(self) -> int:
        """Model chunks over all stages (``S * V``)."""
        return self.num_stages * self.num_model_chunks

    def stage_layers(self, num_layers: int) -> int:
        """Layers per (stage, chunk); validates divisibility."""
        denom = self.num_stages * self.num_model_chunks
        if num_layers % denom:
            raise ValueError(
                f"num_layers ({num_layers}) must divide over "
                f"num_stages x num_model_chunks ({denom})")
        return num_layers // denom

    def chunk_layers(self, num_layers: int, chunk: int) -> range:
        """Global layer ids of global model chunk ``chunk``."""
        per = self.stage_layers(num_layers)
        return range(chunk * per, (chunk + 1) * per)

    def stage_chunks(self, stage: int) -> List[int]:
        """Global chunks on stage ``stage``: ``c * S + stage`` for each
        local chunk ``c``."""
        return [c * self.num_stages + stage
                for c in range(self.num_model_chunks)]

    def detail(self) -> Dict[str, Any]:
        return {
            "schedule": self.schedule,
            "num_stages": self.num_stages,
            "num_microbatches": self.num_microbatches,
            "num_model_chunks": self.num_model_chunks,
            "ticks": self.ticks,
            "bubble_fraction": round(self.bubble, 6),
        }


# -- the stage decomposition of GPT -------------------------------------------


def _layer_id(name: str) -> Optional[int]:
    parts = name.split(".")
    return int(parts[1]) if parts[0] == "layers" else None


def stage_param_names(names: Sequence[str], num_stages: int, stage: int,
                      num_model_chunks: int = 1) -> List[str]:
    """The parameters of GPT's pipe stage ``stage`` among the full
    model's ``names`` (global names, in their order): its chunks'
    ``layers.{i}.*``; ``embedding.weight`` and ``position_embedding`` on
    the first stage; ``final_norm.*`` and the tied LM head's own copy of
    ``embedding.weight`` on the last."""
    layers = len({_layer_id(n) for n in names} - {None})
    per = layers // (num_stages * num_model_chunks)
    mine = {(c * num_stages + stage) * per + i
            for c in range(num_model_chunks) for i in range(per)}
    first, last = stage == 0, stage == num_stages - 1
    out = []
    for n in names:
        i = _layer_id(n)
        if i is not None:
            keep = i in mine
        elif n == "embedding.weight":
            keep = first or last
        elif n == "position_embedding":
            keep = first
        else:
            keep = last                 # final_norm
        if keep:
            out.append(n)
    return out


class GPTStage(nn.Module):
    """GPT's pipe stage ``stage`` of ``spec``: the layers of its chunks
    under their global names (``layers.{i}.…``), ``embedding`` and
    ``position_embedding`` on the first stage, ``final_norm`` and the
    tied LM head's own copy of ``embedding.weight`` on the last. Built at
    the topology's tensor axis as ``GPTModel`` is (a tp > 1 shard of each
    parameter). ``params`` (full-size tensors by name) or ``generator``
    (the full model's draw, then cut) give the weights. The layers run
    without dropout, as the reference's pipelined loss does."""

    def __init__(self, config, spec: PipelineSpec, stage: int, *,
                 params: Optional[Mapping[str, torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None,
                 device=None, axis_name=ps.TENSOR_AXIS):
        from apex_tpu_torch._backend import resolve_device
        from apex_tpu_torch.models.gpt import GPTLayer, GPTModel, \
            gpt_param_specs
        from apex_tpu_torch.normalization import FusedLayerNorm
        from apex_tpu_torch.transformer.tensor_parallel import (
            VocabParallelEmbedding, shard_tensor, tensor_axis)

        super().__init__()
        dev = resolve_device(device)
        cfg = self.config = config
        if cfg.sequence_parallel:
            raise NotImplementedError(
                "sequence_parallel under pipeline parallelism: the "
                "reference's pipelined loss runs the sequence whole")
        if not 0 <= stage < spec.num_stages:
            raise ValueError(f"stage {stage} not in [0, {spec.num_stages})")
        self.spec, self.stage = spec, int(stage)
        self.first, self.last = stage == 0, stage == spec.num_stages - 1
        ax = self.axis = tensor_axis(axis_name)
        self.chunk_ids = [list(spec.chunk_layers(cfg.num_layers, k))
                          for k in spec.stage_chunks(stage)]
        if self.first or self.last:
            self.embedding = VocabParallelEmbedding(
                cfg.vocab_size, cfg.hidden_size, axis_name=ax,
                dtype=cfg.dtype, param_dtype=cfg.param_dtype, device="cpu")
        if self.first:
            self.position_embedding = nn.Parameter(torch.empty(
                (cfg.max_seq_len, cfg.hidden_size), dtype=cfg.param_dtype))
        self.layers = nn.ModuleDict(
            {str(i): GPTLayer(cfg, device="cpu", axis_name=ax)
             for ids in self.chunk_ids for i in ids})
        if self.last:
            self.final_norm = FusedLayerNorm(cfg.hidden_size, device="cpu",
                                             dtype=torch.float32)
        if params is None:
            params = dict(GPTModel(cfg, device="cpu", generator=generator,
                                   axis_name=None).named_parameters())
        specs = gpt_param_specs(self)
        sizes, coords = ({ps.TENSOR_AXIS: ax.size},
                         {ps.TENSOR_AXIS: ax.index})
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name not in params:
                    raise KeyError(f"params lack {name}")
                p.copy_(shard_tensor(params[name].to("cpu"), specs[name],
                                     sizes, coords))
        self.to(dev)


def _layer_of(model: nn.Module, i: int) -> nn.Module:
    if isinstance(model.layers, nn.ModuleDict):
        return model.layers[str(i)]
    return model.layers[i]


def _embed(model: nn.Module, tokens: torch.Tensor) -> torch.Tensor:
    """``GPTModel``'s embedding on one microbatch: tokens (mb, s) ->
    hidden (s, mb, h) in the compute dtype."""
    cfg = model.config
    x = model.embedding(tokens.long())
    pos = model.position_embedding[None, :tokens.shape[1]]
    return (x + pos.to(cfg.dtype)).transpose(0, 1)


def _run_layers(model: nn.Module, x: torch.Tensor, ids: Sequence[int],
                remat: bool) -> torch.Tensor:
    for i in ids:
        layer = _layer_of(model, i)
        if remat and torch.is_grad_enabled():
            x = checkpoint(layer, x, use_reentrant=False)
        else:
            x = layer(x)
    return x


def _head_loss(model: nn.Module, y: torch.Tensor,
               labels: torch.Tensor) -> torch.Tensor:
    """``GPTModel``'s final LayerNorm, tied fp32 LM head (over the local
    vocab shard) and ``gpt_loss_fn`` on one microbatch's last output."""
    from apex_tpu_torch.models.gpt import KERNEL_OPS, _norm, gpt_loss_fn
    from apex_tpu_torch.transformer.tensor_parallel import \
        copy_to_tensor_model_parallel_region

    x = _norm(KERNEL_OPS, model.final_norm, y)
    x = copy_to_tensor_model_parallel_region(x, model.axis)
    logits = torch.matmul(x.float(), model.embedding.weight.float().t())
    return gpt_loss_fn(logits, labels, axis_name=model.axis)


def _microbatches(spec: PipelineSpec, tokens, labels):
    b = tokens.shape[0]
    m = spec.num_microbatches
    if b % m:
        raise ValueError(
            f"global batch {b} not divisible by num_microbatches {m}")
    return tokens.chunk(m), labels.chunk(m)


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    """``v`` as a 0-d fp32 tensor on ``like``'s device (a CUDA tensor
    divided by a Python number is multiplied by its reciprocal)."""
    return torch.full((), float(v), dtype=torch.float32, device=like.device)


# -- one pipe rank: all S stage rows locally ----------------------------------


def _local_loss(model, spec: PipelineSpec, tokens, labels,
                remat: bool) -> torch.Tensor:
    """The synchronous schedules' loss with every stage row on this rank
    (``model`` the whole ``GPTModel``), differentiable: each microbatch
    through the layers in order, its mean cross entropy summed in
    microbatch order, divided by M."""
    spec.stage_layers(model.config.num_layers)
    toks, labs = _microbatches(spec, tokens, labels)
    acc = None
    for tb, lb in zip(toks, labs):
        y = _run_layers(model, _embed(model, tb),
                        range(model.config.num_layers), remat)
        loss = _head_loss(model, y, lb)
        acc = loss if acc is None else acc + loss
    return acc / _scalar(spec.num_microbatches, acc)


def _async_local_loss(model, spec: PipelineSpec, tokens, labels,
                      carry: Optional[List[torch.Tensor]], tick0: int,
                      remat: bool):
    """The asynchronous schedule with every stage row on this rank: M
    ticks, row ``s`` applying chunk ``s`` to its buffer row each tick;
    row 0 injects microbatch ``j``; row S-1's output at tick ``j`` is
    scored against labels ``(j - (S - 1)) mod M`` when ``tick0 + j >=
    S - 1``. Returns ``(loss, new carry)``, the carry detached."""
    cfg = model.config
    S, m = spec.num_stages, spec.num_microbatches
    toks, labs = _microbatches(spec, tokens, labels)
    rows = [list(spec.chunk_layers(cfg.num_layers, s)) for s in range(S)]
    buf = list(carry) if carry is not None else [
        torch.zeros((toks[0].shape[1], toks[0].shape[0], cfg.hidden_size),
                    dtype=cfg.dtype, device=tokens.device)] * S
    acc, cnt = None, 0
    for j in range(m):
        buf[0] = _embed(model, toks[j])
        out = [_run_layers(model, buf[s], rows[s], remat) for s in range(S)]
        if tick0 + j >= S - 1:
            loss = _head_loss(model, out[S - 1], labs[(j - (S - 1)) % m])
            acc = loss if acc is None else acc + loss
            cnt += 1
        buf = [out[S - 1]] + out[:-1]
    if acc is None:
        acc = torch.zeros((), dtype=torch.float32, device=tokens.device)
    return acc / _scalar(max(cnt, 1), acc), [b.detach() for b in buf]


# -- the schedules' tick plans -------------------------------------------------


Action = Tuple[str, int, int]           # ("F" | "B", microbatch, global chunk)


def _one_f_one_b(fw: List[Action], bw: List[Action], warmup: int
                 ) -> List[Action]:
    out = fw[:warmup]
    for j in range(len(fw) - warmup):
        out += [fw[warmup + j], bw[j]]
    return out + bw[len(fw) - warmup:]


def rank_order(spec: PipelineSpec, stage: int) -> List[Action]:
    """The order in which stage ``stage`` runs its forward and backward
    units (microbatch, global chunk) in one step of a synchronous
    schedule."""
    S, M, V = spec.num_stages, spec.num_microbatches, spec.num_model_chunks
    if spec.schedule == "gpipe":
        return ([("F", i, stage) for i in range(M)]
                + [("B", i, stage) for i in range(M)])
    if spec.schedule == "1f1b":
        return _one_f_one_b([("F", i, stage) for i in range(M)],
                            [("B", i, stage) for i in range(M)],
                            min(S - stage - 1, M))
    if spec.schedule != "interleaved_1f1b":
        raise ValueError(f"{spec.schedule!r} has no synchronous order")
    group = S * V

    def unit(n: int, forward: bool) -> Tuple[int, int]:
        c = (n % group) // S
        return (n // group) * S + n % S, (c if forward else V - 1 - c) * S \
            + stage

    total = M * V
    return _one_f_one_b([("F", *unit(n, True)) for n in range(total)],
                        [("B", *unit(n, False)) for n in range(total)],
                        min((S - stage - 1) * 2 + (V - 1) * S, total))


@functools.lru_cache(maxsize=64)
def tick_plan(spec: PipelineSpec, forward_only: bool = False
              ) -> List[List[Action]]:
    """The lock-step ticks of one synchronous step: each tick the units
    that run (at most one a stage), each as soon as its input has
    arrived in an earlier tick and every unit before it on its stage has
    run. The same on every rank (cached: callers only read it)."""
    S, K = spec.num_stages, spec.num_chunks
    orders = [[a for a in rank_order(spec, s)
               if not forward_only or a[0] == "F"] for s in range(S)]
    done: Dict[Action, int] = {}
    pos = [0] * S
    ticks: List[List[Action]] = []
    while any(pos[s] < len(orders[s]) for s in range(S)):
        t = len(ticks)
        now = []
        for s in range(S):
            if pos[s] == len(orders[s]):
                continue
            kind, i, k = a = orders[s][pos[s]]
            if kind == "F":
                dep = ("F", i, k - 1) if k > 0 else None
            else:
                dep = ("B", i, k + 1) if k < K - 1 else ("F", i, k)
            if dep is None or done.get(dep, t) < t:
                now.append(a)
        if not now:
            raise RuntimeError(f"the {spec.schedule} plan stalls at tick {t}")
        for a in now:
            done[a] = t
            pos[a[2] % S] += 1
        ticks.append(now)
    return ticks


def _transfer_of(spec: PipelineSpec, a: Action):
    """The boundary tensor a unit sends: ``(kind, microbatch, chunk it
    feeds, src stage, dst stage)``, or None."""
    kind, i, k = a
    S, K = spec.num_stages, spec.num_chunks
    if kind == "F" and k < K - 1:
        return ("act", i, k + 1, k % S, (k + 1) % S)
    if kind == "B" and k > 0:
        return ("grad", i, k - 1, k % S, (k - 1) % S)
    return None


# -- the boundary transfer ----------------------------------------------------


@dataclasses.dataclass
class TransferStats:
    """One rank's boundary transfers in a step: tensors sent and
    received, their bytes, and (metered steps only) the synchronised
    seconds spent in the exchanges, waits on the neighbours included."""

    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0


def _exchange(sends: Sequence[Tuple[torch.Tensor, int]],
              recvs: Sequence[Tuple[tuple, torch.dtype, torch.device, int]],
              *, stats: TransferStats, meter: bool = False
              ) -> List[torch.Tensor]:
    """One tick's boundary transfers on this rank, the counterpart of the
    reference's roll: ``sends`` ``(tensor, destination rank)`` and
    ``recvs`` ``(shape, dtype, device, source rank)``, posted together
    (``batch_isend_irecv``: NCCL groups them, gloo posts each) in the
    order given, which both sides of a pair derive from one plan. On
    gloo the host waits, each wait bounded by ``TRANSFER_TIMEOUT_S``; on
    NCCL the current stream waits on NCCL's and the host runs on (the
    process group's own timeout bounds a hang), except when ``meter``
    times the exchange. A transfer that fails or times out raises.
    gloo's point-to-point takes host tensors, so a CUDA tensor over gloo
    is staged through a pinned host buffer. Returns the received tensors
    on their devices."""
    if not sends and not recvs:
        return []
    t0 = time.perf_counter()
    if meter and torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
    backend = dist.get_backend()
    host = backend == "gloo"
    ops, outs = [], []
    for t, dst in sends:
        buf = t.detach().contiguous()
        if host and buf.is_cuda:
            buf = _to_host(buf)
        ops.append(dist.P2POp(dist.isend, buf, dst))
        stats.bytes += buf.numel() * buf.element_size()
    for shape, dtype, dev, src in recvs:
        on_host = host and dev.type == "cuda"
        buf = torch.empty(shape, dtype=dtype,
                          device="cpu" if on_host else dev,
                          pin_memory=on_host)
        ops.append(dist.P2POp(dist.irecv, buf, src))
        outs.append(buf)
        stats.bytes += buf.numel() * buf.element_size()
    stats.calls += len(ops)
    timeout = datetime.timedelta(seconds=TRANSFER_TIMEOUT_S)
    stream_ordered = backend == "nccl" and not meter
    for work in dist.batch_isend_irecv(ops):
        if stream_ordered:
            work.wait()
        elif not work.wait(timeout):
            raise RuntimeError("a pipeline boundary transfer did not "
                               "complete")
    outs = [b.to(dev) if b.device != dev else b
            for b, (_, _, dev, _) in zip(outs, recvs)]
    if meter:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        stats.seconds += time.perf_counter() - t0
    return outs


def _to_host(t: torch.Tensor) -> torch.Tensor:
    buf = torch.empty(t.shape, dtype=t.dtype, device="cpu", pin_memory=True)
    buf.copy_(t)
    return buf


# -- the loss function ----------------------------------------------------------


def make_pipeline_loss_fn(model, spec: PipelineSpec, *, remat: bool = True):
    """The pipelined GPT LM loss, ``loss_fn(model, tokens, labels) ->
    0-d fp32``: the mean over equal microbatches of each microbatch's
    mean cross entropy, in microbatch order, the reference's value.
    Where the pipe group is one rank, ``model`` is the whole ``GPTModel``
    and the loss is differentiable (every stage row runs here). Over a
    pipe group of S ranks, ``model`` is this rank's :class:`GPTStage`:
    the schedule's forward runs over the ranks, without gradients, and
    every rank returns the loss. ``model`` given here is only read for
    its config."""
    if spec.schedule == "async_1f1b":
        raise ValueError(
            "async_1f1b carries state across steps — build it with "
            "make_mesh_pipeline_train_step, not as a bare loss_fn")
    spec.stage_layers(model.config.num_layers)

    def loss_fn(stage_model, tokens, labels):
        group, ranks = ps.axis_group(ps.PIPELINE_AXIS)
        if len(ranks) == 1:
            return _local_loss(stage_model, spec, tokens, labels, remat)
        with torch.no_grad():
            loss = _Schedule(stage_model, spec, ranks, remat=remat).run(
                tokens, labels, backward=False)
        return _broadcast_loss(loss, ranks, group, tokens.device)

    return loss_fn


class _Schedule:
    """One pipe rank's side of a synchronous schedule over the pipe
    group's ``ranks`` (global ranks in pipe order); ``stage_model`` is
    this rank's :class:`GPTStage`."""

    def __init__(self, stage_model, spec: PipelineSpec,
                 ranks: Sequence[int], *, remat: bool):
        if len(ranks) != spec.num_stages:
            raise ValueError(
                f"a pipe group of {len(ranks)} ranks cannot hold "
                f"num_stages={spec.num_stages}")
        self.model, self.spec, self.ranks = stage_model, spec, list(ranks)
        self.stage = self.ranks.index(dist.get_rank())
        self.remat = remat
        self.stats = TransferStats()
        self.meter = False

    def _shape(self, tokens_mb):
        cfg = self.model.config
        return (tokens_mb.shape[1], tokens_mb.shape[0], cfg.hidden_size)

    def _chunk(self, k: int) -> List[int]:
        return self.model.chunk_ids[k // self.spec.num_stages]

    def _forward_unit(self, i, k, x, toks, labs):
        """``(input, output)`` of unit (i, k); the output of the last
        chunk is the microbatch's loss."""
        m = self.model
        if k == 0:
            x = _embed(m, toks[i])
        elif torch.is_grad_enabled():
            x.requires_grad_(True)
        y = _run_layers(m, x, self._chunk(k), self.remat)
        if k == self.spec.num_chunks - 1:
            y = _head_loss(m, y, labs[i])
        return x, y

    def run(self, tokens, labels, *, backward: bool,
            loss_scale: Optional[torch.Tensor] = None
            ) -> Optional[torch.Tensor]:
        """Every tick of the plan on this rank: this rank's units and
        the tick's transfers. Returns the loss (on the last stage; None
        elsewhere): the microbatches' losses summed in order over M."""
        spec, S, K = self.spec, self.spec.num_stages, self.spec.num_chunks
        toks, labs = _microbatches(spec, tokens, labels)
        shape = self._shape(toks[0])
        dev, dtype = tokens.device, self.model.config.dtype
        inputs: Dict[Tuple[int, int], torch.Tensor] = {}
        grads: Dict[Tuple[int, int], torch.Tensor] = {}
        saved: Dict[Tuple[int, int], tuple] = {}
        losses: Dict[int, torch.Tensor] = {}
        for tick in tick_plan(spec, forward_only=not backward):
            sent = {}
            for a in tick:
                kind, i, k = a
                if k % S != self.stage:
                    continue
                if kind == "F":
                    x, y = self._forward_unit(i, k, inputs.pop((i, k), None),
                                              toks, labs)
                    if k == K - 1:
                        losses[i] = y.detach()
                    if backward:
                        saved[(i, k)] = (x, y)
                    sent[a] = y
                else:
                    x, y = saved.pop((i, k))
                    g = loss_scale if k == K - 1 else grads.pop((i, k))
                    torch.autograd.backward(y, g)
                    sent[a] = x.grad if k > 0 else None
            sends, recvs, keys = [], [], []
            for a in tick:
                tr = _transfer_of(spec, a)
                if tr is None:
                    continue
                kind, i, k, src, dst = tr
                if src == self.stage:
                    sends.append((sent[a], self.ranks[dst]))
                elif dst == self.stage:
                    recvs.append((shape, dtype, dev, self.ranks[src]))
                    keys.append((kind, i, k))
            got = _exchange(sends, recvs, stats=self.stats, meter=self.meter)
            for (kind, i, k), t in zip(keys, got):
                (inputs if kind == "act" else grads)[(i, k)] = t
        if not losses:
            return None
        acc = None
        for i in range(spec.num_microbatches):
            acc = losses[i] if acc is None else acc + losses[i]
        return acc / _scalar(spec.num_microbatches, acc)


def _broadcast_loss(loss, ranks, group, dev) -> torch.Tensor:
    """The last pipe rank's loss on every rank of the pipe group."""
    if loss is None:
        loss = torch.zeros((), dtype=torch.float32, device=dev)
    else:
        loss = loss.detach().clone()
    dist.broadcast(loss, src=ranks[-1], group=group)
    return loss


# -- the pipelined train step ---------------------------------------------------


class MeshPipelineTrainStep(MeshTrainStep):
    """:class:`~apex_tpu_torch.mesh.mesh.MeshTrainStep` running a
    :class:`PipelineSpec` schedule: ``state, loss = step(state, tokens,
    labels)`` with the whole batch; the loss is the whole batch's on
    every rank.

    Over a pipe axis of S ranks (``num_stages == pipe``) ``model`` is
    this rank's :class:`GPTStage` (or the full ``GPTModel``, whose stage
    is cut here), its parameters views into this rank's flat master and
    their ``.grad`` into one flat gradient (``PretrainStep``'s
    ``FlatSpace.bind``). A step takes this data rank's rows, runs the
    schedule's forwards and backwards into the flat gradient (each
    microbatch's loss scaled by 1/M), sums the tied embedding's gradient
    over the first and last pipe ranks (both copies then take the same
    elementwise update and stay bitwise equal), all-reduces the flat
    gradient over the data group (``DistributedDataParallel``), then
    ``opt.step_flat``. With a pipe axis of one rank (any ``num_stages``)
    ``model`` is the whole ``GPTModel`` and every stage row runs here.

    The async schedule carries the boundary tensors across steps;
    ``reset_pipeline`` drops them (the next step warms up again).
    ``meter = True`` synchronises around each transfer and the tied
    all-reduce and times them (``last_transfers``, ``last_tied``), and the
    step's parts (``last_phases``: the schedule, the tied sum, the data
    all-reduce, the update, the loss's broadcast, in ms). The
    compile plane and goodput of the reference's step are ROADMAP A 10.
    """

    FN = "mesh_pipeline_step"

    def __init__(self, model, optimizer, plan: ShardingPlan,
                 spec: PipelineSpec, *, remat: bool = True):
        from apex_tpu_torch.models.gpt import GPTModel

        self.spec = spec
        self.remat = remat
        self.last_bubble_fraction: Optional[float] = None
        self.last_step_ms: Optional[float] = None
        self.last_transfers = TransferStats()
        self.last_tied = TransferStats()
        self.last_phases: Dict[str, float] = {}
        self.meter = False
        self._async = spec.schedule == "async_1f1b"
        self._pipe_buf = None
        self._tick0 = 0
        sizes, coords = plan.mesh.shape, plan.mesh.coords
        pipe = sizes[PIPE_AXIS]
        if pipe > 1 and spec.num_stages != pipe:
            raise ValueError(
                f"num_stages ({spec.num_stages}) must equal the mesh's pipe "
                f"size ({pipe}), or the pipe axis must be one rank (every "
                "stage row on it)")
        spec.stage_layers(model.config.num_layers)
        if pipe > 1 and isinstance(model, GPTModel):
            if model.axis.size > 1:
                raise ValueError("pass the full model (a GPTModel built "
                                 "with axis_name=None) or a GPTStage")
            dev = next(model.parameters()).device
            model = GPTStage(model.config, spec, coords[PIPE_AXIS],
                             params=dict(model.named_parameters()),
                             device=dev)
        self._pipe = pipe
        loss_fn = None
        if pipe == 1:
            loss_fn = (self._async_local if self._async else
                       make_pipeline_loss_fn(model, spec, remat=remat))
        super().__init__(model, optimizer, plan, loss_fn=loss_fn)
        if pipe > 1:
            self._pipe_ranks = plan.mesh.group(PIPE_AXIS)
            self._tied = _tied_embedding_group(plan.mesh)
            self._sched = None if self._async else _Schedule(
                self.model, spec, self._pipe_ranks[1], remat=remat)
            dist.barrier()

    def _check_layout(self, sizes) -> None:
        """Every pipe size runs here (the base class refuses pipe > 1)."""

    # -- async ---------------------------------------------------------------

    def reset_pipeline(self) -> None:
        """Drop the async carried boundary tensors (the next step warms
        up again)."""
        self._pipe_buf = None
        self._tick0 = 0

    def _async_local(self, model, tokens, labels):
        loss, self._pipe_buf = _async_local_loss(
            model, self.spec, tokens, labels, self._pipe_buf, self._tick0,
            self.remat)
        return loss

    def _need(self, s: int, j: int) -> bool:
        """Whether unit (stage s, tick j) of this async step reaches a
        scored output within the step (so gets a gradient)."""
        S, m = self.spec.num_stages, self.spec.num_microbatches
        d = S - 1 - s
        return j + d < m and self._tick0 + j + d >= S - 1

    def _async_step(self, tokens, labels) -> Optional[torch.Tensor]:
        """This rank's M ticks of the asynchronous schedule: forwards
        tick by tick (each rank's input the previous rank's output of
        the tick before, the first tick's the carried one), then the
        backwards in reverse tick order over the units that reach a
        scored output in this step. Returns the loss on the last
        stage."""
        spec, model = self.spec, self.model
        S, m = spec.num_stages, spec.num_microbatches
        group, ranks = self._pipe_ranks
        s = ranks.index(dist.get_rank())
        toks, labs = _microbatches(spec, tokens, labels)
        cfg = model.config
        shape = (toks[0].shape[1], toks[0].shape[0], cfg.hidden_size)
        dev = tokens.device
        stats = self.last_transfers
        ids = model.chunk_ids[0]
        if self._pipe_buf is None:
            self._pipe_buf = torch.zeros(shape, dtype=cfg.dtype, device=dev)
        cnt = sum(1 for j in range(m) if self._tick0 + j >= S - 1)
        count = _scalar(max(cnt, 1), tokens)
        scale = _scalar(1.0, tokens) / count
        carry, saved, acc = self._pipe_buf, {}, None
        for j in range(m):
            need = self._need(s, j)
            with torch.set_grad_enabled(need):
                if s == 0:
                    x = _embed(model, toks[j])
                else:
                    x = carry.requires_grad_(need)
                y = _run_layers(model, x, ids, self.remat)
                if s == S - 1 and self._tick0 + j >= S - 1:
                    loss = _head_loss(model, y, labs[(j - (S - 1)) % m])
                    acc = loss.detach() if acc is None else \
                        acc + loss.detach()
                    y = loss
            if need:
                saved[j] = (x, y)
            got = _exchange(
                [(y, ranks[s + 1])] if s < S - 1 else [],
                [(shape, cfg.dtype, dev, ranks[s - 1])] if s > 0 else [],
                stats=stats, meter=self.meter)
            if s > 0:
                carry = got[0]
        self._pipe_buf = carry
        grad = None
        for j in reversed(range(m)):
            if j in saved:
                x, y = saved.pop(j)
                torch.autograd.backward(y, scale if s == S - 1 else grad)
            send = s > 0 and j >= 1 and self._need(s, j)
            recv = s < S - 1 and j >= 1 and self._need(s + 1, j)
            got = _exchange(
                [(x.grad, ranks[s - 1])] if send else [],
                [(shape, cfg.dtype, dev, ranks[s + 1])] if recv else [],
                stats=stats, meter=self.meter)
            grad = got[0] if recv else None
        self._tick0 += m
        if acc is None:
            return None if s < S - 1 else torch.zeros(
                (), dtype=torch.float32, device=dev)
        return acc / count

    # -- the step ------------------------------------------------------------

    def _pipelined(self, state, tokens, labels) -> torch.Tensor:
        """Over the pipe ranks: the schedule into the flat gradient, the
        tied embedding's sum, the data group's all-reduce, the update.
        Returns the data rank's loss on every pipe rank."""
        inner = self.inner
        if state.master is not inner._bound:
            inner._bind(state)
        dev = state.master.device
        tokens = torch.as_tensor(tokens, device=dev)
        labels = torch.as_tensor(labels, device=dev)
        inner._grad.zero_()
        self.last_transfers = TransferStats()
        self.last_tied = TransferStats()
        self.last_phases = {}
        mark = self._clock(dev)
        if self._async:
            loss = self._async_step(tokens, labels)
        else:
            self._sched.stats = self.last_transfers
            self._sched.meter = self.meter
            scale = _scalar(1.0, inner._grad) / _scalar(
                self.spec.num_microbatches, inner._grad)
            loss = self._sched.run(tokens, labels, backward=True,
                                   loss_scale=scale)
        mark("schedule")
        self._reduce_tied()
        mark("tied")
        if inner.grad_reduce is not None:
            inner.grad_reduce(inner._grad)
        mark("data")
        self._new_state = self.opt.step_flat(state, inner._grad)[1]
        mark("update")
        group, ranks = self._pipe_ranks
        loss = _broadcast_loss(loss, ranks, group, dev)
        mark("loss")
        return loss

    def _clock(self, dev):
        """``mark(name)``: with ``meter`` on, the synchronised ms since the
        last mark into ``last_phases[name]``; else nothing."""
        if not self.meter:
            return lambda name: None
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.synchronize(dev)
        last = [time.perf_counter()]

        def mark(name):
            if cuda:
                torch.cuda.synchronize(dev)
            now = time.perf_counter()
            self.last_phases[name] = (now - last[0]) * 1e3
            last[0] = now

        return mark

    def _reduce_tied(self) -> None:
        group, ranks = self._tied
        if group is None or not hasattr(self.model, "embedding"):
            return
        g = self.model.embedding.weight.grad
        t0 = time.perf_counter()
        if self.meter and g.is_cuda:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        dist.all_reduce(g, group=group)
        if self.meter and g.is_cuda:
            torch.cuda.synchronize()
        self.last_tied.calls += 1
        self.last_tied.bytes += g.numel() * g.element_size()
        if self.meter:
            self.last_tied.seconds += time.perf_counter() - t0

    def step(self, state, tokens, labels):
        from apex_tpu_torch.telemetry import timeline as _timeline

        observe = _timeline.global_enabled()
        t0 = time.perf_counter()
        if self._pipe == 1:
            out = super().step(state, tokens, labels)
            if self._async:
                self._tick0 += self.spec.num_microbatches
        else:
            loss = self._pipelined(state, self.plan.shard_batch(tokens),
                                   self.plan.shard_batch(labels))
            out = (self._new_state, self._data_mean(loss))
            self._new_state = None
        if observe:
            _timeline.sync_tensor(out[1])
        wall_s = time.perf_counter() - t0
        self._emit_telemetry(t0, wall_s, tokens, observe=observe)
        return out

    __call__ = step

    def _emit_telemetry(self, t0: float, wall_s: float, tokens, *,
                        observe: bool) -> None:
        """Per-stage spans, the bubble gauges, the ``pipeline`` info blob
        and the ``ppermute`` ledger record for one completed step (span
        geometry: the schedule's analytic activity scaled by the
        measured wall)."""
        from apex_tpu_torch.telemetry import metrics as _metrics
        from apex_tpu_torch.telemetry import timeline as _timeline

        spec = self.spec
        T = spec.ticks
        busy = spec.busy_ticks_per_stage
        bf = spec.bubble
        self.last_bubble_fraction = bf
        self.last_step_ms = wall_s * 1e3
        tick_s = wall_s / max(T, 1)
        reg = _metrics.registry()
        g = reg.gauge("pipeline_bubble_fraction",
                      "measured per-stage pipeline bubble fraction")
        stages = []
        for s in range(spec.num_stages):
            # stage s's busy window: ticks [s, s + busy)
            fill = min(s, T - busy) if spec.schedule != "async_1f1b" else 0
            span_t0 = t0 + fill * tick_s
            span_dur = busy * tick_s
            stages.append({"stage": s, "busy_ticks": busy,
                           "t0_ms": round(fill * tick_s * 1e3, 4),
                           "dur_ms": round(span_dur * 1e3, 4)})
            g.set(bf, schedule=spec.schedule, stage=str(s))
            if observe:
                _timeline.record_global_span(
                    f"pipeline:stage{s}", span_t0, span_dur,
                    category="pipeline",
                    args={"schedule": spec.schedule, "stage": s,
                          "busy_ticks": busy, "ticks": T,
                          "bubble_fraction": round(bf, 6),
                          "geometry": "analytic-activity-x-measured-wall"})
        reg.gauge("pipeline_ticks", "pipeline scan ticks per step").set(
            T, schedule=spec.schedule)
        reg.set_info("pipeline", {**spec.detail(),
                                  "step_ms": round(wall_s * 1e3, 4),
                                  "stages": stages})
        self._price_boundary_transfers(t0, wall_s, tokens)

    def _price_boundary_transfers(self, t0: float, wall_s: float,
                                  tokens) -> None:
        """One comms-ledger record a step for the boundary transfers, the
        reference's pricing: ``ticks`` transfers of one (seq, mb, hidden)
        slab, wire bytes by the ``ppermute`` model over the pipe size;
        the duration is the step's wall (a lower bound on the link)."""
        from apex_tpu_torch.telemetry import comms as _comms

        tracer = _comms.get_tracer()
        if tracer is None:
            return
        cfg = self.model.config
        B, seq = int(tokens.shape[0]), int(tokens.shape[1])
        mbs = B // self.spec.num_microbatches
        itemsize = torch.empty((), dtype=cfg.dtype).element_size()
        payload = seq * mbs * cfg.hidden_size * itemsize * self.spec.ticks
        wire = _comms.wire_bytes("ppermute", payload, int(self._pipe))
        tracer.record("ppermute", "p2p", payload, wire, t0, wall_s)


def _tied_embedding_group(mesh) -> Tuple[Optional[object], Tuple[int, ...]]:
    """This rank's group of the first and last pipe ranks of its (data,
    tensor) coordinate: the two copies of the tied embedding. Every
    rank makes every such group, in one order; ``(None, ())`` on a
    middle stage."""
    grid = mesh.topology.grid
    world = int(grid.size)
    me = dist.get_rank()
    mine = (None, ())
    for ranks in ps.axis_rank_lists(grid, ps.PIPELINE_AXIS):
        pair = (ranks[0], ranks[-1])
        g = ps._make_group(pair, world)
        if me in pair:
            mine = (g, pair)
    return mine


def make_mesh_pipeline_train_step(
        model, optimizer, plan: ShardingPlan,
        spec: Optional[PipelineSpec] = None, *,
        schedule: str = "1f1b", num_microbatches: int = 4,
        num_model_chunks: int = 1,
        remat: bool = True) -> MeshPipelineTrainStep:
    """The pipelined train step of ``model`` over ``plan``: pass a
    :class:`PipelineSpec`, or the knobs; ``num_stages`` defaults to the
    mesh's pipe size, at least 2 (a pipeline of one stage row is the
    plain mesh step, ``make_mesh_train_step``)."""
    if spec is None:
        stages = max(int(plan.mesh.shape[PIPE_AXIS]), 2)
        spec = PipelineSpec(schedule=schedule, num_stages=stages,
                            num_microbatches=num_microbatches,
                            num_model_chunks=num_model_chunks)
    return MeshPipelineTrainStep(model, optimizer, plan, spec, remat=remat)


__all__ = [
    "SCHEDULES", "GPTStage", "MeshPipelineTrainStep", "PipelineSpec",
    "TransferStats", "bubble_fraction", "make_mesh_pipeline_train_step",
    "make_pipeline_loss_fn", "rank_order", "stage_param_names", "tick_plan",
]
