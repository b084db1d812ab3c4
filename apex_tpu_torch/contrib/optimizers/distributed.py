"""ZeRO-style sharded fused optimizers over a ``parallel_state`` axis.

Counterpart of ``apex_tpu/contrib/optimizers/distributed.py``
(``DistFlatOptState``, ``DistributedFusedAdam``, ``DistributedFusedLAMB``).
The reference runs inside ``shard_map`` and XLA places its collectives;
the port's mesh is the explicit one, each process one rank of the
``parallel_state`` grid, and each collective is a call over the group of
``shard_axis`` (``ps.axis_group``, the data axis by default; every other
axis is replicated, as in the reference :22-25):

- the flat space (``FlatSpace``) is padded to ``round_up(total, world x
  128)`` and each rank owns one contiguous shard of ``padded_total /
  world`` elements, the reference's layout (``_shard_layout``, :146);
- ``lax.psum_scatter(tiled=True)`` of the padded flat gradient is a
  reduce-scatter, then the division by world (:206-218);
- ``lax.all_gather(tiled=True)`` of the updated shard is an all-gather,
  in ``param_sync_dtype`` when set (an fp8 wire travels as ``uint8``
  words; the fp32 -> e5m2 cast rounds as ``ml_dtypes`` does, NaN
  included), then cast to fp32 (:220-229);
- ``lax.pmax`` of ``found_inf`` is an all-reduce MAX, so every shard
  skips alike (:268); ``lax.psum`` of the norms an all-reduce SUM
  (:290-300, ``parallel.sharded_norms.group_sum``);
- the ``lax.cond`` keep/take is the port's skip path: new buffers, one
  host read of ``found_inf``, swapped in only when it is 0.

On gloo, which takes host tensors for these collectives, a CUDA buffer
is staged through pinned host memory; on NCCL the buffers go as they
are. The step count is a host integer, as in the single-device
optimizers; the SR seed is ``count x world + shard`` (:136-144) and
each shard's stream runs over its own indices from 0.

**LAMB over a shard.** A shard starts at a multiple of 128 elements, not
of the kernels' 2048-element subtile, so a subtile counted from the
shard's start could straddle two leaves. The port keeps each LAMB
buffer (master, m, v, and the step's gradient and update term) in a
*window*: the shard with zeros before and after it out to the subtiles
the shard touches. The window is laid out like the full space's
subtiles, so LAMB stage 1 emits per-subtile partials that never straddle
a leaf, the ``leaf_sum`` kernel sums them by leaf over the window's
runs, and stage 2 reads each subtile's trust ratio through the window's
slice of the space's subtile map. The zeros stay zeros (stage 1 of a
zero p, m, v and g is a zero update). No per-element leaf map lives on
the device; :attr:`DistFlatOptState.leaf_ids` gives the reference's
per-element map as a CPU view. The reference's stage 2 is plain XLA
(``master - lr * r * u``, :455-464): here kernel ``lamb_stage2`` on the
fp32 window, then with SR the ``stochastic_round`` kernel over the
shard, as the reference casts it.

``step`` takes and returns the reference's gradient and parameter trees
(name -> tensor mappings); ``step_flat`` is the training path: the local
flat gradient in, the gathered flat fp32 parameters out (into ``out``
when given, so that a model's parameters bound to it as views follow
with no copy). The reference's ``impl`` argument has no counterpart: a
CUDA buffer runs the kernels, a CPU one their plain versions.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from apex_tpu_torch.multi_tensor import FlatSpace
from apex_tpu_torch.multi_tensor.engine import (LANES, fused_sumsq_partials,
                                                sqrt_rn,
                                                stochastic_round_cast)
from apex_tpu_torch.multi_tensor.flat_buffer import DEFAULT_ALIGN, _round_up
from apex_tpu_torch.multi_tensor.ops import (_dev_f32, fused_adam_update,
                                             fused_lamb_update)
from apex_tpu_torch.optimizers.fused import (Schedule, _mv_slots,
                                             _resolve_lr, check_leaf_dtypes,
                                             validate_master_dtype)
from apex_tpu_torch.parallel.sharded_norms import (ShardedNorms, group_max,
                                                   group_sum)
from apex_tpu_torch.transformer import parallel_state as ps

_SUB = DEFAULT_ALIGN            # the kernels' per-leaf subtile
_FP8 = tuple(getattr(torch, n) for n in ("float8_e5m2", "float8_e4m3fn")
             if hasattr(torch, n))


# -- the shard layout -----------------------------------------------------------


class ShardLayout:
    """Where this rank's shard lies in the padded flat space of ``space``
    over ``world`` ranks: ``padded_total``, ``shard``, ``start``, and the
    LAMB window around it (``lead`` zeros before the shard, ``window``
    elements from the global element ``win_start``, a multiple of the
    2048-element subtile)."""

    def __init__(self, space: FlatSpace, world: int, rank: int):
        self.space, self.world, self.rank = space, int(world), int(rank)
        self.padded_total = _round_up(space.total, self.world * LANES)
        self.shard = self.padded_total // self.world
        self.start = self.rank * self.shard
        self.lead = self.start % _SUB
        self.win_start = self.start - self.lead
        self.window = _round_up(self.lead + self.shard, _SUB)
        self._window_space = None

    def leaf_ids(self) -> np.ndarray:
        """The reference's ``leaf_ids`` of this shard (int32, one an
        element; padding maps to the last leaf), on the host."""
        sp = self.space
        ids = np.repeat(np.arange(sp.num_leaves, dtype=np.int32),
                        np.asarray(sp.padded_sizes))
        if self.padded_total > ids.shape[0]:
            ids = np.concatenate([ids, np.full(
                self.padded_total - ids.shape[0],
                ids[-1] if ids.size else 0, np.int32)])
        return ids[self.start:self.start + self.shard]

    @property
    def window_space(self) -> FlatSpace:
        """The leaves' runs within the window (each leaf's part of it,
        empty where it lies outside; the last leaf takes the padding, as
        in the reference): a ``FlatSpace`` whose subtile map and
        ``leaf_sum`` runs are the window's."""
        if self._window_space is None:
            sp, lo, hi = self.space, self.win_start, self.win_start + \
                self.window
            offs, sizes = [], []
            n = sp.num_leaves
            for i, (off, size) in enumerate(zip(sp.offsets,
                                                sp.padded_sizes)):
                end = max(off + size, hi) if i == n - 1 else off + size
                a, b = min(max(off, lo), hi), min(max(end, lo), hi)
                offs.append(a - lo)
                sizes.append(b - a)
            self._window_space = FlatSpace(
                names=sp.names, shapes=sp.shapes, dtypes=sp.dtypes,
                offsets=tuple(offs), sizes=tuple(sizes),
                padded_sizes=tuple(sizes), total=self.window, align=_SUB)
        return self._window_space

    def shard_of(self, win: torch.Tensor) -> torch.Tensor:
        return win[self.lead:self.lead + self.shard]

    def new_window(self, like: torch.Tensor, dtype=None) -> torch.Tensor:
        return torch.zeros(self.window, dtype=dtype or like.dtype,
                           device=like.device)


class DistFlatOptState(NamedTuple):
    """One rank's shard of a ZeRO-sharded optimizer (the reference's
    fields; ``count`` a host integer).

    ``master`` and every slot hold only this rank's contiguous shard of
    the flat space (``shard`` elements): ZeRO's saving. ``layout`` is the
    shard's :class:`ShardLayout`; ``buffers`` the LAMB windows that
    ``master`` and the slots are views into (None for Adam)."""

    space: FlatSpace
    master: torch.Tensor
    slots: Dict[str, torch.Tensor]
    count: int
    found_inf: torch.Tensor
    l2_grad_norm: torch.Tensor
    layout: Optional[ShardLayout] = None
    buffers: Optional[Dict[str, torch.Tensor]] = None

    @property
    def leaf_ids(self) -> np.ndarray:
        """The reference's per-element leaf map of this shard (a host
        array: the port keeps none on the device)."""
        return self.layout.leaf_ids()


# -- the wire -------------------------------------------------------------------


def e5m2_bits(x: torch.Tensor) -> torch.Tensor:
    """``x`` cast to float8_e5m2 as ``ml_dtypes`` rounds it (to nearest
    even, inf past the top), its bits as ``uint8``. PyTorch's cast agrees
    but for NaN, which it writes as 0x7F; ``ml_dtypes`` writes the sign
    and 0x7E."""
    bits = x.to(torch.float8_e5m2).view(torch.uint8)
    nan = torch.isnan(x)
    if bool(nan.any()):
        sign = (torch.signbit(x).to(torch.uint8) << 7)
        bits = torch.where(nan, sign | 0x7E, bits)
    return bits


def _to_wire(x: torch.Tensor, dtype) -> torch.Tensor:
    """``x`` as it travels: ``dtype`` itself, or an fp8 dtype's words as
    ``uint8`` (neither gloo nor NCCL carries fp8)."""
    if dtype is None or x.dtype == dtype:
        return x
    if dtype in _FP8:
        if dtype == torch.float8_e5m2:
            return e5m2_bits(x)
        return x.to(dtype).view(torch.uint8)
    return x.to(dtype)


def _from_wire(x: torch.Tensor, dtype) -> torch.Tensor:
    return x.view(dtype) if dtype in _FP8 else x


class _Wire:
    """The shard axis's collectives, staged through pinned host memory on
    gloo for CUDA buffers; with ``meter`` on, each synchronised and timed
    (``stats``: calls, bytes, seconds by op)."""

    def __init__(self, axis: str):
        self.axis = axis
        self.meter = False
        self.stats: Dict[str, list] = {}
        self._host: Dict[Tuple[int, torch.dtype], torch.Tensor] = {}

    def group(self):
        group, ranks = ps.axis_group(self.axis)
        me = dist.get_rank() if dist.is_available() and \
            dist.is_initialized() else ranks[0]
        return group, len(ranks), list(ranks).index(me)

    def _staged(self, t: torch.Tensor, group) -> bool:
        return t.is_cuda and dist.get_backend(group) == "gloo"

    def _pinned(self, n: int, dtype, slot: int) -> torch.Tensor:
        key = (n, dtype, slot)
        buf = self._host.get(key)
        if buf is None:
            buf = self._host[key] = torch.empty(n, dtype=dtype,
                                                pin_memory=True)
        return buf

    def _timed(self, op: str, nbytes: int, fn, dev) -> None:
        sync = self.meter and dev.type == "cuda"
        if sync:
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        fn()
        if sync:
            torch.cuda.synchronize(dev)
        rec = self.stats.setdefault(op, [0, 0, 0.0])
        rec[0] += 1
        rec[1] += nbytes
        rec[2] += time.perf_counter() - t0 if self.meter else 0.0

    def reduce_scatter(self, out: torch.Tensor, full: torch.Tensor,
                       group) -> None:
        """``out`` = this rank's shard of ``full`` summed over ``group``."""
        if group is None:
            out.copy_(full)
            return

        def run():
            if self._staged(full, group):
                src = self._pinned(full.numel(), full.dtype, 0)
                dst = self._pinned(out.numel(), out.dtype, 1)
                src.copy_(full)
                dist.reduce_scatter_tensor(dst, src, group=group)
                out.copy_(dst)
            else:
                dist.reduce_scatter_tensor(out, full, group=group)

        self._timed("reduce_scatter", full.numel() * full.element_size(),
                    run, full.device)

    def all_gather(self, out: torch.Tensor, mine: torch.Tensor,
                   group) -> None:
        """``out`` = every rank's ``mine``, in rank order."""
        if group is None:
            out.copy_(mine)
            return

        def run():
            if self._staged(mine, group):
                src = self._pinned(mine.numel(), mine.dtype, 2)
                dst = self._pinned(out.numel(), out.dtype, 3)
                src.copy_(mine)
                dist.all_gather_into_tensor(dst, src, group=group)
                out.copy_(dst)
            else:
                dist.all_gather_into_tensor(out, mine, group=group)

        self._timed("all_gather", out.numel() * out.element_size(), run,
                    mine.device)


# -- the optimizers -------------------------------------------------------------


class _DistributedFlatOptimizer:
    """Shared ZeRO plumbing: the shard layout, the gradient's
    reduce-scatter, the parameters' all-gather, the skip."""

    def __init__(self, lr: Schedule, *, shard_axis: str = ps.DATA_AXIS,
                 grad_sync_dtype=None, param_sync_dtype=None,
                 average_grad_sync: bool = True,
                 master_dtype=torch.float32,
                 stochastic_rounding: bool = False):
        if grad_sync_dtype in _FP8:
            raise ValueError("grad_sync_dtype: the wire cannot sum fp8")
        self.lr = lr
        self.shard_axis = shard_axis
        self.grad_sync_dtype = grad_sync_dtype
        self.param_sync_dtype = param_sync_dtype
        self.average_grad_sync = average_grad_sync
        self.stochastic_rounding = bool(stochastic_rounding)
        self.master_dtype = validate_master_dtype(master_dtype,
                                                  self.stochastic_rounding)
        self.wire = _Wire(shard_axis)

    @property
    def meter(self) -> bool:
        """Synchronise and time each collective (``comm_stats``)."""
        return self.wire.meter

    @meter.setter
    def meter(self, on: bool) -> None:
        self.wire.meter = bool(on)

    def comm_stats(self, reset: bool = True) -> Dict[str, dict]:
        """``{op: {"calls", "bytes", "ms"}}`` of the collectives since the
        last reset (ms only while ``meter`` is on)."""
        out = {op: {"calls": c, "bytes": b, "ms": s * 1e3}
               for op, (c, b, s) in self.wire.stats.items()}
        if reset:
            self.wire.stats = {}
        return out

    def _sr_seed(self, state: DistFlatOptState) -> Optional[int]:
        """Per-(step, shard) SR seed, or None without SR (:136-144)."""
        if not self.stochastic_rounding:
            return None
        return state.count * state.layout.world + state.layout.rank

    def _layout(self, space: FlatSpace) -> ShardLayout:
        _, world, rank = self.wire.group()
        return ShardLayout(space, world, rank)

    # -- subclass hooks ----------------------------------------------------

    windowed = False        # LAMB keeps its buffers in windows

    def _pre_sync(self, state, g_local, grads_pre_synced):
        return None

    def _update_shard(self, state, g_win, lr, grad_scale, aux, sumsq,
                      in_place):
        """Return ``(master window or shard, slots, found_inf_local)``."""
        raise NotImplementedError

    # -- public API --------------------------------------------------------

    def init(self, params: Mapping[str, torch.Tensor]) -> DistFlatOptState:
        """This rank's state shard; ``params`` (name -> tensor) the same on
        every rank of the shard axis."""
        check_leaf_dtypes(params, self.master_dtype)
        space = FlatSpace.create(params)
        lay = self._layout(space)
        full = self._pack_padded(lay, params, self.master_dtype)
        dev = full.device
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        if self.windowed:
            win = lay.new_window(full)
            lay.shard_of(win).copy_(full[lay.start:lay.start + lay.shard])
            bufs = {"master": win,
                    **{k: lay.new_window(win, torch.float32)
                       for k in ("m", "v")}}
            master = lay.shard_of(win)
            slots = {k: lay.shard_of(bufs[k]) for k in ("m", "v")}
        else:
            bufs = None
            master = full[lay.start:lay.start + lay.shard].clone()
            slots = _mv_slots(master)
        return DistFlatOptState(space=space, master=master, slots=slots,
                                count=0, found_inf=zero,
                                l2_grad_norm=zero.clone(), layout=lay,
                                buffers=bufs)

    def _pack_padded(self, lay: ShardLayout, tree, dtype) -> torch.Tensor:
        full = torch.zeros(lay.padded_total, dtype=dtype,
                           device=next(iter(tree.values())).device)
        lay.space.pack_into(full, tree)
        return full

    def _padded(self, lay: ShardLayout, flat: torch.Tensor) -> torch.Tensor:
        """The local flat gradient (``space.total`` or ``padded_total``
        elements), fp32, padded to ``padded_total``."""
        if flat.ndim != 1 or flat.numel() not in (lay.space.total,
                                                  lay.padded_total):
            raise ValueError(f"flat_grads of shape {tuple(flat.shape)}: "
                             f"{lay.space.total} or {lay.padded_total} "
                             "elements")
        g = flat.float()
        if g.numel() != lay.padded_total:
            g = torch.nn.functional.pad(g, (0, lay.padded_total - g.numel()))
        return g

    def _sync_grads(self, lay: ShardLayout, g_full: torch.Tensor,
                    out: torch.Tensor) -> None:
        """Reduce-scatter the padded local gradient into ``out`` (this
        rank's shard, fp32), in ``grad_sync_dtype`` on the wire, then
        divide by world (``average_grad_sync``) (:206-218)."""
        group, world, _ = self.wire.group()
        g = g_full
        if self.grad_sync_dtype is not None:
            g = g.to(self.grad_sync_dtype)
        if g.dtype == torch.float32:
            self.wire.reduce_scatter(out, g, group)
        else:
            part = torch.empty(lay.shard, dtype=g.dtype, device=g.device)
            self.wire.reduce_scatter(part, g, group)
            out.copy_(part)
        if self.average_grad_sync:
            out.div_(_dev_f32(float(world), out.device))

    def _gather(self, lay: ShardLayout, master: torch.Tensor,
                out: Optional[torch.Tensor]) -> torch.Tensor:
        """All-gather the updated shards (``param_sync_dtype`` on the wire)
        into the padded fp32 flat parameters (``out`` when given)."""
        group, _, _ = self.wire.group()
        wire_dt = self.param_sync_dtype
        p = _to_wire(master, wire_dt)
        if out is not None and (out.numel() != lay.padded_total
                                or out.dtype != torch.float32):
            raise ValueError(f"out: {lay.padded_total} fp32 elements")
        if p.dtype == torch.float32 and out is not None:
            self.wire.all_gather(out, p.contiguous(), group)
            return out
        full = torch.empty(lay.padded_total, dtype=p.dtype, device=p.device)
        self.wire.all_gather(full, p.contiguous(), group)
        full = _from_wire(full, wire_dt)
        if out is None:
            return full.float()
        out.copy_(full)
        return out

    def step_flat(self, state: DistFlatOptState, flat_grads: torch.Tensor,
                  *, lr: Optional[Schedule] = None, grad_scale=1.0,
                  grads_pre_synced: bool = False,
                  skip_if_nonfinite: bool = False,
                  out: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, DistFlatOptState]:
        """One sharded step on this rank's local flat gradient (laid out
        by ``state.space``): reduce-scatter it, update the shard with the
        single-device kernels, all-gather the parameters. Returns the
        padded flat fp32 parameters (``out`` itself when given) and the
        new state. ``grads_pre_synced``: the gradient is already reduced,
        so it is only sliced."""
        lay = state.layout
        g_full = self._padded(lay, flat_grads)
        aux = self._pre_sync(state, g_full[:lay.space.total],
                             grads_pre_synced)
        g_win = lay.new_window(g_full)
        g = lay.shard_of(g_win)
        if grads_pre_synced:
            g.copy_(g_full[lay.start:lay.start + lay.shard])
        else:
            self._sync_grads(lay, g_full, g)
        del g_full
        group, _, _ = self.wire.group()
        lr_val = _resolve_lr(lr if lr is not None else self.lr, state.count)
        # the synced shard's norm, from the sync the step already did
        # (the reference's L2_grad_norm)
        sumsq = group_sum(torch.sum(fused_sumsq_partials(g)), group)
        gnorm = sqrt_rn(sumsq) / _dev_f32(grad_scale, g.device)
        new_master, new_slots, found = self._update_shard(
            state, g_win, lr_val, grad_scale, aux, sumsq,
            in_place=not skip_if_nonfinite)
        found = group_max(found, group)             # every shard skips alike
        count = state.count + 1
        bufs = state.buffers
        if skip_if_nonfinite and float(found) > 0:
            new_master, new_slots, count = (state.master, state.slots,
                                            state.count)
        elif self.windowed:
            bufs = {"master": new_master, **new_slots}
            new_master = lay.shard_of(new_master)
            new_slots = {k: lay.shard_of(b) for k, b in new_slots.items()}
        new_state = state._replace(master=new_master, slots=new_slots,
                                   count=count, found_inf=found,
                                   l2_grad_norm=gnorm, buffers=bufs)
        return self._gather(lay, new_master, out), new_state

    def step(self, state: DistFlatOptState,
             grads: Mapping[str, torch.Tensor], **kw
             ) -> Tuple[Dict[str, torch.Tensor], DistFlatOptState]:
        """:meth:`step_flat` for the reference's gradient tree (name ->
        tensor, this rank's local gradients): returns the gathered
        parameters by name, each in its own dtype, and the new state."""
        g = state.space.pack(grads, dtype=torch.float32,
                             device=state.master.device)
        full, new_state = self.step_flat(state, g, **kw)
        return state.space.unpack(full[:state.space.total]), new_state

    def l2_grad_norm(self, state: DistFlatOptState,
                     grads: Mapping[str, torch.Tensor], *,
                     grad_scale=1.0) -> torch.Tensor:
        """The global norm of the synced (averaged, with
        ``average_grad_sync``) gradients, over a reduce-scatter of its
        own; after a :meth:`step`, read ``new_state.l2_grad_norm``."""
        lay = state.layout
        g_full = self._padded(lay, state.space.pack(
            grads, dtype=torch.float32, device=state.master.device))
        g = torch.empty(lay.shard, dtype=torch.float32, device=g_full.device)
        self._sync_grads(lay, g_full, g)
        group, _, _ = self.wire.group()
        sumsq = group_sum(torch.sum(fused_sumsq_partials(g)), group)
        return sqrt_rn(sumsq) / _dev_f32(grad_scale, g.device)


class DistributedFusedAdam(_DistributedFlatOptimizer):
    """ZeRO-2 AdamW: sharded moments, reduce-scattered gradients, gathered
    parameters (the reference's ``DistributedFusedAdam``, :314). The
    shard's update is the single-device Adam kernel (``csrc/fused_adam.cu``),
    with SR at ``count x world + shard`` under a bf16 master.

    As the reference's docstring drives it (:318-322)::

        opt = DistributedFusedAdam(lr=1e-3)          # shard_axis="data"
        state = opt.init(params)
        # the local backward into the flat gradient, then
        flat_params, state = opt.step_flat(state, flat_grad, out=flat_params)
    """

    def __init__(self, lr=1e-3, *, bias_correction=True, betas=(0.9, 0.999),
                 eps=1e-8, adam_w_mode=True, weight_decay=0.0,
                 shard_axis: str = ps.DATA_AXIS, grad_sync_dtype=None,
                 param_sync_dtype=None, average_grad_sync=True,
                 master_dtype=torch.float32, stochastic_rounding=False):
        super().__init__(lr, shard_axis=shard_axis,
                         grad_sync_dtype=grad_sync_dtype,
                         param_sync_dtype=param_sync_dtype,
                         average_grad_sync=average_grad_sync,
                         master_dtype=master_dtype,
                         stochastic_rounding=stochastic_rounding)
        self.bias_correction = bias_correction
        self.betas = betas
        self.eps = eps
        self.adam_w_mode = adam_w_mode
        self.weight_decay = weight_decay

    def _update_shard(self, state, g_win, lr, grad_scale, aux, sumsq,
                      in_place):
        p2, m2, v2, found = fused_adam_update(
            state.master, state.slots["m"], state.slots["v"],
            state.layout.shard_of(g_win), lr=lr, beta1=self.betas[0],
            beta2=self.betas[1], eps=self.eps, step=state.count + 1,
            adam_w_mode=self.adam_w_mode,
            bias_correction=self.bias_correction,
            weight_decay=self.weight_decay, grad_scale=grad_scale,
            in_place=in_place, sr_seed=self._sr_seed(state))
        return p2, {"m": m2, "v": v2}, found


class DistributedFusedLAMB(_DistributedFlatOptimizer):
    """Sharded LAMB (the reference's ``DistributedFusedLAMB``, :358): stage
    1 (kernel ``lamb_stage1``) on the shard's window with the per-subtile
    partials of p and u, the per-leaf sums (kernel ``leaf_sum``) summed
    over the shard axis, the trust ratios, stage 2 (kernel
    ``lamb_stage2``; with SR then kernel ``stochastic_round``), the
    gather, optionally in float8_e5m2 (``e5m2_allgather``). The clip
    norm is the synced gradient's (``clip_after_ar=True``) or the max
    over ranks of the local pre-sync gradients' (False; with
    ``grads_pre_synced`` that raises, as in the reference)."""

    windowed = True

    def __init__(self, lr=1e-3, *, bias_correction=True, betas=(0.9, 0.999),
                 eps=1e-6, weight_decay=0.01, grad_averaging=True,
                 adam_w_mode=True, max_grad_norm=1.0, use_nvlamb=False,
                 clip_after_ar=True, e5m2_allgather=False,
                 shard_axis: str = ps.DATA_AXIS, grad_sync_dtype=None,
                 param_sync_dtype=None, average_grad_sync=True,
                 master_dtype=torch.float32, stochastic_rounding=False):
        if e5m2_allgather and param_sync_dtype is None:
            param_sync_dtype = torch.float8_e5m2
        super().__init__(lr, shard_axis=shard_axis,
                         grad_sync_dtype=grad_sync_dtype,
                         param_sync_dtype=param_sync_dtype,
                         average_grad_sync=average_grad_sync,
                         master_dtype=master_dtype,
                         stochastic_rounding=stochastic_rounding)
        self.bias_correction = bias_correction
        self.betas = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.grad_averaging = grad_averaging
        self.adam_w_mode = adam_w_mode
        self.max_grad_norm = max_grad_norm
        self.use_nvlamb = use_nvlamb
        self.clip_after_ar = clip_after_ar

    def _pre_sync(self, state, g_local, grads_pre_synced):
        # clip_after_ar=False: the max over ranks of the local, pre-sync
        # gradients' norms (:404-416)
        if self.clip_after_ar:
            return None
        if grads_pre_synced:
            raise ValueError(
                "clip_after_ar=False needs the pre-reduction local grads; "
                "it cannot be combined with grads_pre_synced=True")
        local = torch.sum(fused_sumsq_partials(g_local))
        group, _, _ = self.wire.group()
        return sqrt_rn(group_max(local, group))

    def _windows(self, state: DistFlatOptState) -> Dict[str, torch.Tensor]:
        """The state's master, m and v windows: its own buffers where the
        shards are still their views, else copies around the shards."""
        lay, bufs = state.layout, state.buffers or {}
        views = {"master": state.master, **state.slots}
        out = {}
        for k, view in views.items():
            win = bufs.get(k)
            if win is None or lay.shard_of(win).data_ptr() != \
                    view.data_ptr() or win.dtype != view.dtype:
                win = lay.new_window(view)
                lay.shard_of(win).copy_(view)
            out[k] = win
        return out

    def _update_shard(self, state, g_win, lr, grad_scale, aux, sumsq,
                      in_place):
        # the single-device LAMB step over the window, its per-leaf norms
        # summed over the shard axis (every leaf counted as split there)
        lay = state.layout
        win = self._windows(state)
        p_w = win["master"]
        group, _, _ = self.wire.group()
        wsp = lay.window_space
        n = wsp.num_leaves
        norms = ShardedNorms(space=wsp, split=(True,) * n,
                             counted=(True,) * n, group=group)
        seed = self._sr_seed(state)
        # with SR, the reference's stage 2 in fp32, then its SR cast over
        # the shard's own indices
        p2f, m2, v2, found = fused_lamb_update(
            p_w if seed is None else p_w.float(), win["m"], win["v"], g_win,
            wsp, lr=lr, beta1=self.betas[0], beta2=self.betas[1],
            eps=self.eps, step=state.count + 1,
            weight_decay=self.weight_decay,
            bias_correction=self.bias_correction,
            grad_averaging=self.grad_averaging,
            max_grad_norm=self.max_grad_norm, adam_w_mode=self.adam_w_mode,
            use_nvlamb=self.use_nvlamb,
            global_grad_norm=aux if aux is not None else sqrt_rn(sumsq),
            grad_scale=grad_scale, in_place=in_place, norms=norms)
        if seed is None:
            return p2f, {"m": m2, "v": v2}, found
        p2 = p_w if in_place else torch.zeros_like(p_w)
        lay.shard_of(p2).copy_(stochastic_round_cast(lay.shard_of(p2f),
                                                     seed))
        return p2, {"m": m2, "v": v2}, found


__all__ = ["DistFlatOptState", "DistributedFusedAdam",
           "DistributedFusedLAMB", "ShardLayout", "e5m2_bits"]
