"""Pipeline-parallel utilities.

Counterpart of ``apex_tpu/transformer/pipeline_parallel/utils.py``
(:1-217): the process-global microbatch calculator and its getters,
:func:`get_kth_microbatch`, :func:`average_losses_across_data_parallel_group`
(one all-reduce over this rank's data group, ``transformer.parallel_state``),
:func:`calc_params_l2_norm` (a sum over the tensor group when the leaves
are shards), :func:`get_ltor_masks_and_position_ids` and
:class:`Timers`. The reference's ``pmean`` / ``psum`` inside a trace are
collectives over the axis's process group here; in a world of one they
are the identity.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Iterable, Optional, Sequence

import torch
import torch.distributed as dist

from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.parallel_state import DATA_AXIS, TENSOR_AXIS
from apex_tpu_torch.transformer.pipeline_parallel.microbatches import (
    build_num_microbatches_calculator,
)

_GLOBAL_NUM_MICROBATCHES_CALCULATOR = None
_GLOBAL_TIMERS = None


def setup_microbatch_calculator(
    global_batch_size: int,
    micro_batch_size: int,
    data_parallel_size: int,
    rampup_batch_size: Optional[Sequence[int]] = None,
) -> None:
    """Arm the process-global calculator (every rank builds its own)."""
    global _GLOBAL_NUM_MICROBATCHES_CALCULATOR
    _GLOBAL_NUM_MICROBATCHES_CALCULATOR = build_num_microbatches_calculator(
        global_batch_size, micro_batch_size, data_parallel_size,
        rampup_batch_size)


def _ensure_calculator():
    if _GLOBAL_NUM_MICROBATCHES_CALCULATOR is None:
        raise RuntimeError("call setup_microbatch_calculator first")
    return _GLOBAL_NUM_MICROBATCHES_CALCULATOR


def get_num_microbatches() -> int:
    return _ensure_calculator().get()


def get_current_global_batch_size() -> int:
    return _ensure_calculator().get_current_global_batch_size()


def get_micro_batch_size() -> int:
    return _ensure_calculator().micro_batch_size


def update_num_microbatches(consumed_samples: int,
                            consistency_check: bool = True) -> None:
    _ensure_calculator().update(consumed_samples, consistency_check)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def get_kth_microbatch(batch: Any, k: int, micro_batch_size: int) -> Any:
    """Rows ``[k * mbs, (k + 1) * mbs)`` of every leaf of ``batch`` (a
    tensor, or a dict, list or tuple of them)."""
    lo = k * micro_batch_size
    return _tree_map(lambda x: x[lo:lo + micro_batch_size], batch)


def average_losses_across_data_parallel_group(
        losses: Sequence[torch.Tensor], axis_name: str = DATA_AXIS
) -> torch.Tensor:
    """Each loss's fp32 mean, stacked, averaged over this rank's group
    of ``axis_name`` (one all-reduce)."""
    stacked = torch.stack([torch.mean(l.float()) for l in losses])
    group, ranks = ps.axis_group(axis_name)
    if group is None:
        return stacked
    dist.all_reduce(stacked, group=group)
    return stacked / torch.full((), float(len(ranks)), device=stacked.device)


def _param_leaves(params: Any) -> Iterable[torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return [p for _, p in params.named_parameters()]
    if isinstance(params, torch.Tensor):
        return [params]
    if isinstance(params, dict):
        return [t for k in sorted(params) for t in _param_leaves(params[k])]
    return [t for x in params for t in _param_leaves(x)]


def calc_params_l2_norm(params: Any, axis_name: str = TENSOR_AXIS,
                        params_sharded: bool = True) -> torch.Tensor:
    """The global parameter L2 norm: fp32 sums of squares over the
    leaves (a module, a tensor, or a dict, list or tuple of them),
    summed over this rank's group of ``axis_name`` when the leaves are
    shards (``params_sharded``); replicated leaves are counted once."""
    leaves = list(_param_leaves(params))
    sumsq = torch.zeros((), dtype=torch.float32,
                        device=leaves[0].device if leaves else None)
    for leaf in leaves:
        sumsq = sumsq + torch.sum(torch.square(leaf.detach().float()))
    if params_sharded:
        group, _ = ps.axis_group(axis_name)
        if group is not None:
            dist.all_reduce(sumsq, group=group)
    return torch.sqrt(sumsq)


def get_ltor_masks_and_position_ids(
    data: torch.Tensor,
    eod_token: Optional[int] = None,
    reset_position_ids: bool = False,
    reset_attention_mask: bool = False,
    eod_mask_loss: bool = False,
):
    """Left-to-right masks and positions of ``data`` (b, s): the
    attention mask (b, 1, s, s) bool, True where a key is MASKED (after
    the query, or, with ``reset_attention_mask``, in another document);
    the loss mask (b, s) fp32, 0 at EOD tokens with ``eod_mask_loss``;
    the position ids (b, s), restarting after each EOD with
    ``reset_position_ids`` (an EOD belongs to the document it ends)."""
    b, s = data.shape
    dev = data.device
    causal = torch.triu(torch.ones((s, s), dtype=torch.bool, device=dev),
                        diagonal=1)
    attention_mask = causal.expand(b, 1, s, s)
    loss_mask = torch.ones((b, s), dtype=torch.float32, device=dev)
    if eod_mask_loss and eod_token is not None:
        loss_mask = torch.where(data == eod_token, 0.0, loss_mask)
    arange = torch.arange(s, device=dev)
    position_ids = arange.expand(b, s)
    if eod_token is not None and (reset_position_ids or reset_attention_mask):
        is_eod = (data == eod_token).long()
        seg = torch.cumsum(is_eod, dim=1) - is_eod
        same_seg = seg[:, :, None] == seg[:, None, :]
        if reset_position_ids:
            seg_start = torch.where(same_seg, arange[None, None, :],
                                    s).amin(dim=-1)
            position_ids = arange[None, :] - seg_start
        if reset_attention_mask:
            attention_mask = attention_mask | ~same_seg[:, None, :, :]
    return attention_mask, loss_mask, position_ids


def _sync(barrier_data) -> None:
    """Wait for the device work behind ``barrier_data`` (a tensor, or a
    dict, list or tuple of them); with none, for the whole card, where
    CUDA is in use."""
    if barrier_data is None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        return
    devices = set()
    _tree_map(lambda t: devices.add(t.device)
              if isinstance(t, torch.Tensor) and t.is_cuda else None,
              barrier_data)
    for d in devices:
        torch.cuda.synchronize(d)


class _Timer:
    """A named host timer that synchronises the device before it reads
    the clock. Every ``stop()`` also records the interval as a span of
    category ``timers`` in the global timeline when that is enabled."""

    def __init__(self, name: str):
        self.name = name
        self.elapsed_ = 0.0
        self.started_ = False
        self.start_time = 0.0
        self._span_t0 = 0.0

    def start(self, barrier_data=None):
        assert not self.started_
        _sync(barrier_data)
        self.start_time = time.time()
        self._span_t0 = time.perf_counter()
        self.started_ = True

    def stop(self, barrier_data=None):
        assert self.started_
        _sync(barrier_data)
        self.elapsed_ += time.time() - self.start_time
        self.started_ = False
        from apex_tpu_torch.telemetry import timeline as _timeline

        _timeline.record_global_span(
            self.name, self._span_t0, time.perf_counter() - self._span_t0,
            category="timers")

    def reset(self):
        self.elapsed_ = 0.0
        self.started_ = False

    def elapsed(self, reset=True):
        started = self.started_
        if started:
            self.stop()
        e = self.elapsed_
        if reset:
            self.reset()
        if started:
            self.start()
        return e


class Timers:
    """Named timers: ``timers("fwd").start()``, ``.stop()``,
    ``timers.log(["fwd"])``."""

    def __init__(self):
        self.timers: Dict[str, _Timer] = {}

    def __call__(self, name: str) -> _Timer:
        if name not in self.timers:
            self.timers[name] = _Timer(name)
        return self.timers[name]

    def log(self, names: Sequence[str], normalizer: float = 1.0) -> str:
        parts = [
            f"{n}: {self.timers[n].elapsed(reset=False) * 1000.0 / normalizer:.2f}"
            for n in names if n in self.timers]
        return "time (ms) | " + " | ".join(parts)


def get_timers() -> Timers:
    global _GLOBAL_TIMERS
    if _GLOBAL_TIMERS is None:
        _GLOBAL_TIMERS = Timers()
    return _GLOBAL_TIMERS


__all__ = [
    "Timers", "average_losses_across_data_parallel_group",
    "calc_params_l2_norm", "get_current_global_batch_size",
    "get_kth_microbatch", "get_ltor_masks_and_position_ids",
    "get_micro_batch_size", "get_num_microbatches", "get_timers",
    "setup_microbatch_calculator", "update_num_microbatches",
]
