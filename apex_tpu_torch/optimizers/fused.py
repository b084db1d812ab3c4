"""Fused optimizers over the flat parameter space.

Counterpart of ``apex_tpu/optimizers/fused.py`` (``FlatOptState``,
``FlatFusedOptimizer``, ``FusedAdam``, ``FusedLAMB``, ``FusedSGD``,
``FusedNovoGrad``, ``FusedAdagrad``, ``FusedLARS``). The state holds the
fp32 master copy of every parameter and the optimizer's slots as flat
buffers laid out by a :class:`~apex_tpu_torch.multi_tensor.FlatSpace`
(NovoGrad's ``v``: one value a leaf), and one fused kernel sweep updates
them all.

Where the reference is functional (new buffers each step, donated by
the jitted step), the port updates in place: ``step_flat`` overwrites
the state's master and slots, so parameters bound as views into the
master (``FlatSpace.bind``) change with it, and the returned state holds
the same buffers. The exception is ``skip_if_nonfinite``: the kernel
has written its outputs before it knows whether a gradient was inf or
nan, so a step that may be skipped writes new buffers, reads the
``found_inf`` flag on the host once, and takes the new buffers only
when it is 0 — a skipped step leaves master, slots and count exactly as
they were (the reference's ``lax.cond``, :246-255). That costs a second
master + slots worth of memory during the step and one host
synchronisation; the traffic is the in-place sweep's.

The step count is a host integer (the reference carries an int32 on
the device): the bias corrections are computed on the host from it, in
fp32 as the reference computes them. ``found_inf`` stays a 0-d fp32
tensor on the device. FusedLAMB's clip factor and trust ratios stay on
the device too (the kernels read them by pointer): its step reads
nothing on the host but ``found_inf`` on the skip path; so do FusedSGD's
and FusedLARS's first-run flag and FusedLARS's ratios, FusedNovoGrad's
per-leaf norms and denominators, and FusedAdagrad's gradient scale.

``master_dtype=torch.bfloat16, stochastic_rounding=True`` drops the fp32
master (the reference's master-free mode, :104-130): the parameters live
in one bf16 flat buffer and every update writes p' with stochastic
rounding, seeded by the unskipped step count (:126-130), so a skipped
step leaves the next one the same stream and a resumed state replays
it. The slots stay fp32. The reference's policy holds: SR only with a
bf16 master, a bf16 master only with SR, and every leaf already in the
master's dtype (:64-96, the same errors). On CUDA tensors the updates
launch the kernels' SR variants, nothing else.
"""

from __future__ import annotations

import dataclasses
from typing import (Any, Callable, Dict, Mapping, NamedTuple, Optional,
                    Tuple, Union)

import torch

from apex_tpu_torch.multi_tensor import (
    FlatSpace,
    fused_adagrad_update,
    fused_adam_update,
    fused_lamb_segmented_update,
    fused_lamb_update,
    fused_lars_update,
    fused_novograd_update,
    fused_sgd_update,
)
from apex_tpu_torch.multi_tensor.ops import _dev_f32, _inv_scale
from apex_tpu_torch.multi_tensor.flat_buffer import (
    CHUNK,
    DEFAULT_ALIGN,
    DEFAULT_SEG_SMEM_BUDGET,
    SegmentMeta,
    _round_up,
    segmented_space,
)

Schedule = Union[float, Callable[[int], float]]


class FlatOptState(NamedTuple):
    """State of a flat-space fused optimizer."""

    space: FlatSpace
    master: torch.Tensor            # flat master params: fp32, or bf16
    slots: Dict[str, torch.Tensor]
    count: int                      # successful (unskipped) steps
    found_inf: torch.Tensor         # 0-d fp32 {0, 1} from the last step
    # the SegmentMeta of a segment-aligned space (FusedLAMB with
    # segmented=True), carried with the space it was built for; else None
    seg_meta: Optional[SegmentMeta] = None
    # a state that is one rank's part of the model's (a tensor or pipe
    # shard): the parallel.sharded_norms.ShardedNorms its norms and
    # found_inf are reduced by; None on one rank
    norms: Optional[Any] = None


def validate_master_dtype(master_dtype, stochastic_rounding: bool
                          ) -> torch.dtype:
    """The reference's master-dtype policy (:64-77): a reduced master
    only with stochastic rounding, and only bf16."""
    if stochastic_rounding and master_dtype != torch.bfloat16:
        raise ValueError(
            "stochastic_rounding requires master_dtype=bfloat16 "
            f"(got {master_dtype})")
    if master_dtype != torch.float32 and not stochastic_rounding:
        raise ValueError(
            "a reduced-precision master without stochastic rounding "
            "loses sub-ulp updates to nearest rounding; pass "
            "stochastic_rounding=True (or keep master_dtype=float32)")
    return master_dtype


def check_leaf_dtypes(params: Mapping[str, torch.Tensor],
                      master_dtype) -> None:
    """A reduced master stores every leaf at ``master_dtype``; packing a
    wider leaf would quantize it silently at init, so the reference
    (:80-96) asks for an explicit cast."""
    if master_dtype == torch.float32:
        return
    wider = {str(t.dtype).replace("torch.", "") for t in params.values()
             if t.dtype != master_dtype}
    if wider:
        raise ValueError(
            f"master_dtype={str(master_dtype).replace('torch.', '')} "
            f"requires all param leaves in that dtype; found "
            f"{sorted(wider)} — cast the tree explicitly (mixed per-leaf "
            "masters are not supported)")


def _resolve_lr(lr: Schedule, count: int):
    return lr(count) if callable(lr) else lr


def _small_last(params: Mapping[str, torch.Tensor], seg: int,
                split: frozenset = frozenset()) -> Dict[str, torch.Tensor]:
    """``params`` with the leaves larger than a ``seg``-element segment
    (and those in ``split``) first, each group in the order given."""
    large = {k: t for k, t in params.items()
             if _round_up(max(t.numel(), 1), DEFAULT_ALIGN) > seg
             or k in split}
    return {**large, **{k: t for k, t in params.items() if k not in large}}


def segmented_layout(params: Mapping[str, torch.Tensor], seg_elems: int,
                     split=()) -> Tuple[FlatSpace, SegmentMeta]:
    """FusedLAMB's segmented layout of ``params`` at ``seg_elems``: the
    large leaves and the leaves named in ``split`` (whose norms are
    summed across ranks, or must agree across them) first, each owning
    whole segments, then the small ones packed into shared segments."""
    split = frozenset(split)
    return segmented_space(_small_last(params, seg_elems, split),
                           seg_elems=seg_elems, large=split)


def _mv_slots(master: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The fp32 m and v slots (fp32 under a bf16 master too, as the
    reference keeps them, :57-61)."""
    return {"m": torch.zeros_like(master, dtype=torch.float32),
            "v": torch.zeros_like(master, dtype=torch.float32)}


class FlatFusedOptimizer:
    """Base: one fused kernel sweep over the flat buffers.
    ``master_dtype=torch.bfloat16`` with ``stochastic_rounding=True``: a
    bf16 master written with stochastic rounding (the module
    docstring)."""

    def __init__(self, lr: Schedule, *, master_dtype=torch.float32,
                 stochastic_rounding: bool = False):
        self.lr = lr
        self.stochastic_rounding = bool(stochastic_rounding)
        self.master_dtype = validate_master_dtype(master_dtype,
                                                  self.stochastic_rounding)

    def _sr_seed(self, state: "FlatOptState") -> Optional[int]:
        """The step's stochastic-rounding seed (None without SR): the
        unskipped step count, so each step rounds with a fresh stream and
        a resumed state replays it (:126-130)."""
        return state.count if self.stochastic_rounding else None

    # -- subclass hooks ----------------------------------------------------

    def _init_slots(self, space: FlatSpace, master: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
        """The zeroed slots for ``master`` (laid out by ``space``: a
        per-leaf slot has ``space.num_leaves`` entries)."""
        raise NotImplementedError

    def _update(self, state: FlatOptState, g: torch.Tensor, lr,
                grad_scale, in_place: bool, **kw
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor],
                           torch.Tensor]:
        """Return (new_master, new_slots, found_inf[, grad norms]);
        ``kw`` holds ``global_grad_norm`` / ``with_grad_norm`` when the
        caller passed them (optimizers that take them say so)."""
        raise NotImplementedError

    # -- public API --------------------------------------------------------

    def init(self, params: Mapping[str, torch.Tensor]) -> FlatOptState:
        """The state for ``params`` (a name -> tensor mapping, e.g.
        ``dict(model.named_parameters())``), on the params' device."""
        check_leaf_dtypes(params, self.master_dtype)
        space = FlatSpace.create(params)
        master = space.pack(params, dtype=self.master_dtype)
        return FlatOptState(
            space=space, master=master, slots=self._init_slots(space, master),
            count=0, found_inf=torch.zeros((), dtype=torch.float32,
                                           device=master.device))

    def step(self, state: FlatOptState, grads: Mapping[str, torch.Tensor],
             **kw) -> Tuple[Dict[str, torch.Tensor], FlatOptState]:
        """:meth:`step_flat` for gradients given per parameter name
        (packed into the flat layout first: one extra read and write of
        the gradients). The returned params take each leaf's own dtype
        (the reference's master -> model cast)."""
        g = state.space.pack(grads, dtype=torch.float32,
                             device=state.master.device)
        return self.step_flat(state, g, **kw)

    def step_flat(
        self,
        state: FlatOptState,
        flat_grads: torch.Tensor,
        *,
        lr: Optional[Schedule] = None,
        grad_scale=1.0,
        skip_if_nonfinite: bool = False,
        global_grad_norm=None,
        extra_found_inf=None,
        with_grad_norm: bool = False,
    ) -> Tuple[Dict[str, torch.Tensor], FlatOptState]:
        """One optimizer step on gradients already in the flat layout.

        Returns ``(params, new_state)``, ``params`` being the new master
        by name (views; a leaf whose dtype differs from the master's comes
        back cast to its own). With ``skip_if_nonfinite`` the update is
        discarded when any gradient (or ``extra_found_inf``) is
        non-finite, and the count then counts only unskipped steps.
        ``global_grad_norm`` hands a precomputed (device) norm to an
        optimizer that clips inside its update (FusedLAMB), so no second
        norm pass runs; ``with_grad_norm=True`` returns ``(params,
        new_state, grad_norm_per_tensor)``, the per-tensor norms of the
        raw gradient reduced inside the update (FusedLAMB)."""
        g = flat_grads
        if g.shape != state.master.shape:
            raise ValueError(f"flat_grads shape {tuple(g.shape)} != master "
                             f"{tuple(state.master.shape)}")
        g = g.float()
        lr_val = _resolve_lr(lr if lr is not None else self.lr, state.count)
        extra_kw = {}
        if global_grad_norm is not None:
            extra_kw["global_grad_norm"] = global_grad_norm
        if with_grad_norm:
            extra_kw["with_grad_norm"] = True
        upd = self._update(state, g, lr_val, grad_scale,
                           in_place=not skip_if_nonfinite, **extra_kw)
        new_master, new_slots, found = upd[:3]
        if extra_found_inf is not None:
            found = torch.maximum(found, torch.as_tensor(
                extra_found_inf, dtype=torch.float32, device=found.device))
        if state.norms is not None:
            # every rank of a sharded state skips alike
            found = state.norms.any(found)
        count = state.count + 1
        if skip_if_nonfinite and float(found) > 0:
            new_master, new_slots, count = (state.master, state.slots,
                                            state.count)
        new_state = state._replace(master=new_master, slots=new_slots,
                                   count=count, found_inf=found)
        if with_grad_norm:
            return state.space.unpack(new_master), new_state, upd[3]
        return state.space.unpack(new_master), new_state

    def master_params(self, state: FlatOptState) -> Dict[str, torch.Tensor]:
        """Views of the master weights by name, in the master's dtype (the
        reference's ``master_params``, :265)."""
        return state.space.unpack(state.master, dtype="buffer")

    def state_dict(self, state: FlatOptState) -> Dict[str, Any]:
        return {"master": state.master, "slots": dict(state.slots),
                "count": state.count, "found_inf": state.found_inf}

    def load_state_dict(self, state: FlatOptState,
                        d: Mapping[str, Any]) -> FlatOptState:
        """``d`` copied into ``state``'s buffers in place (so views bound
        to the master stay valid); returns the updated state."""
        with torch.no_grad():
            state.master.copy_(torch.as_tensor(d["master"]))
            for k, buf in state.slots.items():
                buf.copy_(torch.as_tensor(d["slots"][k]))
        return state._replace(
            count=int(d["count"]),
            found_inf=torch.as_tensor(d["found_inf"], dtype=torch.float32,
                                      device=state.master.device).clone())


class FusedAdam(FlatFusedOptimizer):
    """Adam / AdamW in one fused kernel (the reference's ``FusedAdam``)."""

    def __init__(self, lr=1e-3, bias_correction=True, betas=(0.9, 0.999),
                 eps=1e-8, adam_w_mode=True, weight_decay=0.0, *,
                 master_dtype=torch.float32, stochastic_rounding=False):
        super().__init__(lr, master_dtype=master_dtype,
                         stochastic_rounding=stochastic_rounding)
        self.bias_correction = bias_correction
        self.betas = betas
        self.eps = eps
        self.adam_w_mode = adam_w_mode
        self.weight_decay = weight_decay

    def _init_slots(self, space, master):
        return _mv_slots(master)

    def _update(self, state, g, lr, grad_scale, in_place):
        p2, m2, v2, found = fused_adam_update(
            state.master, state.slots["m"], state.slots["v"], g,
            lr=lr, beta1=self.betas[0], beta2=self.betas[1], eps=self.eps,
            step=state.count + 1, adam_w_mode=self.adam_w_mode,
            bias_correction=self.bias_correction,
            weight_decay=self.weight_decay, grad_scale=grad_scale,
            in_place=in_place, sr_seed=self._sr_seed(state))
        return p2, {"m": m2, "v": v2}, found


class FusedLAMB(FlatFusedOptimizer):
    """LAMB with the global-grad-norm clip and per-tensor trust ratios
    (the reference's ``FusedLAMB``, :320).

    ``segmented=True`` (the default) lays the flat space out in
    segments (``multi_tensor.segmented_space``) and runs both LAMB
    stages in one kernel pass (``csrc/lamb_segment.cu``) for every leaf
    that fits a segment: 7 memory accesses an element (8 with
    ``seg_stash_p=False``) against the two-stage schedule's 10. Leaves
    larger than a segment take the two stages over their own slices.
    The small leaves are laid out together after the large ones
    (:meth:`layout`), not in the order given. ``segmented=False`` runs
    the two stages over the whole buffer (``csrc/fused_lamb.cu``). The
    math is the same; the schedule and the flat layout's padding differ.

    Segment knobs, the reference's names (None = chosen from the
    parameters): ``seg_elems`` (elements per segment, a multiple of the
    65,536-element chunk), ``seg_stash_p`` (keep p in shared memory, 7
    accesses, or re-read it, 8), ``seg_vmem_budget`` (bytes of shared
    memory the stash may take across one thread-block cluster of the
    segment kernel; default ``DEFAULT_SEG_SMEM_BUDGET``, eight blocks'
    worth, which fixes the layout), ``seg_u_dtype`` (the update term's stash: fp32, or bf16,
    which halves it at ~2^-9 relative error in u; never chosen unless
    ``seg_allow_bf16_u=True`` or named, as in the reference). With a
    bf16 master the segment pass and the large leaves' stage 2 write p'
    with stochastic rounding (``multi_tensor/segmented.py``).
    """

    def __init__(self, lr=1e-3, bias_correction=True, betas=(0.9, 0.999),
                 eps=1e-6, weight_decay=0.01, grad_averaging=True,
                 adam_w_mode=True, max_grad_norm=1.0, use_nvlamb=False, *,
                 master_dtype=torch.float32, stochastic_rounding=False,
                 segmented=True, seg_elems=None, seg_stash_p=None,
                 seg_u_dtype=None, seg_allow_bf16_u=False,
                 seg_vmem_budget=None):
        super().__init__(lr, master_dtype=master_dtype,
                         stochastic_rounding=stochastic_rounding)
        if seg_u_dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"seg_u_dtype must be float32 or bfloat16, got "
                             f"{seg_u_dtype}")
        self.bias_correction = bias_correction
        self.betas = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.grad_averaging = grad_averaging
        self.adam_w_mode = adam_w_mode
        self.max_grad_norm = max_grad_norm
        self.use_nvlamb = use_nvlamb
        self.segmented = bool(segmented)
        self.seg_elems = seg_elems
        self.seg_stash_p = seg_stash_p
        self.seg_u_dtype = seg_u_dtype
        self.seg_allow_bf16_u = bool(seg_allow_bf16_u)
        self.seg_vmem_budget = seg_vmem_budget

    def _segment_config(self, params: Mapping[str, torch.Tensor],
                        split=()) -> Tuple[int, bool, torch.dtype]:
        """``(seg_elems, stash_p, u_dtype)``: explicit knobs win; the rest
        is chosen for the fewest expected memory accesses an element
        within the budget, as the reference chooses (:368-425), but
        counting the elements each pass sweeps in the layout it would get
        (:meth:`layout`), padding included: 7 accesses an element of the
        small segments (8 without the stash), 10 of the large leaves'
        segments. The reference takes the largest segment that fits and
        counts only the leaves' own sizes, so it cannot see that a large
        leaf rounded up to whole segments sweeps padding (at GPT-2 345M,
        196,608-element segments pad the matrices by 9.6 M elements;
        65,536 pads them by none). Every whole-chunk size up to the
        budget is a candidate; ties go to the smaller stash. The stash
        takes u's size plus 4 bytes of p an element (the reference's
        count, :393-397): a bf16 u is a candidate only with
        ``seg_allow_bf16_u`` or when named."""
        budget = self.seg_vmem_budget or DEFAULT_SEG_SMEM_BUDGET
        if self.seg_elems is not None and self.seg_elems % CHUNK:
            raise ValueError(
                f"seg_elems={self.seg_elems} must be a multiple of the "
                f"kernel chunk ({CHUNK} elements); round up to "
                f"{_round_up(self.seg_elems, CHUNK)}")
        shapes = {k: torch.empty(max(t.numel(), 1), device="meta")
                  for k, t in params.items()}
        total = max(sum(_round_up(t.numel(), DEFAULT_ALIGN)
                        for t in shapes.values()), 1)
        u_dtypes = ((self.seg_u_dtype,) if self.seg_u_dtype is not None
                    else (torch.float32, torch.bfloat16)
                    if self.seg_allow_bf16_u else (torch.float32,))
        best = None
        for stash in ((self.seg_stash_p,) if self.seg_stash_p is not None
                      else (True, False)):
            for u_dt in u_dtypes:
                bpe = (2 if u_dt == torch.bfloat16 else 4) + (4 if stash
                                                               else 0)
                cost = 7 if stash else 8
                if self.seg_elems is not None:
                    segs = (self.seg_elems,)
                    over = self.seg_elems * bpe > budget
                else:
                    top = min((budget // bpe) // CHUNK * CHUNK,
                              _round_up(total, CHUNK))
                    segs = range(CHUNK, top + 1, CHUNK)
                    over = False
                for seg in segs:
                    _, meta = segmented_layout(shapes, seg, split)
                    small = len(meta.small_segments) * seg
                    expected = (cost * small
                                + 10 * (meta.n_segments * seg - small)
                                ) / total
                    key = (over, expected, seg * bpe)
                    if best is None or key < best[0]:
                        best = (key, (seg, bool(stash), u_dt))
        if best is None:
            raise ValueError(f"no segment size fits the budget {budget} "
                             f"(seg_elems={self.seg_elems})")
        return best[1]

    def layout(self, params: Mapping[str, torch.Tensor], split=()
               ) -> Tuple[FlatSpace, SegmentMeta]:
        """The segmented master's layout for ``params``: the space and
        its :class:`SegmentMeta`. The leaves larger than a segment come
        first, in the order given, then every leaf that fits one, so
        the small leaves fill as few segments as they can.
        ``segmented_space`` (as the reference's) starts a fresh segment
        after each large leaf: in module order (ln, qkv.w, qkv.b,
        proj.w, ...) each run of biases and norms would take a mostly
        empty segment of its own, which both LAMB passes would sweep.
        Leaves are bound and loaded by name, so the order is free.
        ``split`` names the leaves whose norms span ranks or must agree
        across them (``mesh.ShardingPlan.cross_rank_names``): the
        segment kernel cannot wait for a sum across ranks, and sums a
        leaf in an order that depends on its segment, so they take the
        two stages as large leaves do."""
        seg, stash_p, u_dtype = self._segment_config(params, split)
        space, meta = segmented_layout(params, seg, split)
        return space, dataclasses.replace(
            meta, stash_p=stash_p,
            u_dtype_name=str(u_dtype).replace("torch.", ""))

    def init(self, params: Mapping[str, torch.Tensor], split=()
             ) -> FlatOptState:
        """The state for ``params``; ``split`` as for :meth:`layout`."""
        if not self.segmented:
            return super().init(params)
        check_leaf_dtypes(params, self.master_dtype)
        space, meta = self.layout(params, split)
        master = space.pack(params, dtype=self.master_dtype)
        return FlatOptState(
            space=space, master=master, slots=self._init_slots(space, master),
            count=0, found_inf=torch.zeros((), dtype=torch.float32,
                                           device=master.device),
            seg_meta=meta)

    def _init_slots(self, space, master):
        return _mv_slots(master)

    def _update(self, state, g, lr, grad_scale, in_place,
                global_grad_norm=None, with_grad_norm=False):
        kw = dict(
            lr=lr, beta1=self.betas[0], beta2=self.betas[1], eps=self.eps,
            step=state.count + 1, weight_decay=self.weight_decay,
            bias_correction=self.bias_correction,
            grad_averaging=self.grad_averaging,
            max_grad_norm=self.max_grad_norm, adam_w_mode=self.adam_w_mode,
            use_nvlamb=self.use_nvlamb, grad_scale=grad_scale,
            global_grad_norm=global_grad_norm, with_grad_norm=with_grad_norm,
            in_place=in_place, sr_seed=self._sr_seed(state),
            norms=state.norms)
        args = (state.master, state.slots["m"], state.slots["v"], g,
                state.space)
        if self.segmented and state.seg_meta is not None:
            outs = fused_lamb_segmented_update(*args, state.seg_meta, **kw)
        else:
            outs = fused_lamb_update(*args, **kw)
        p2, m2, v2, found = outs[:4]
        return (p2, {"m": m2, "v": v2}, found, *outs[4:])


def _first_run_slots(master: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The momentum buffer and the reference's ``initialized`` flag, a
    0-d fp32 tensor on the master's device that the kernels read by
    pointer (its first-run branch, :503), so no step reads it on the
    host."""
    return {"momentum": torch.zeros_like(master, dtype=torch.float32),
            "initialized": torch.zeros((), dtype=torch.float32,
                                       device=master.device)}


def _momentum_slots(state: FlatOptState, mom2: torch.Tensor
                    ) -> Dict[str, torch.Tensor]:
    return {"momentum": mom2,
            "initialized": torch.ones_like(state.slots["initialized"])}


class FusedSGD(FlatFusedOptimizer):
    """SGD with momentum, dampening, nesterov and either weight-decay
    order in one fused kernel (the reference's ``FusedSGD``, :486;
    ``csrc/fused_sgd.cu``). The gradient is multiplied by the fp32
    reciprocal of ``grad_scale`` inside the sweep (:514)."""

    def __init__(self, lr, momentum=0.0, dampening=0.0, weight_decay=0.0,
                 nesterov=False, wd_after_momentum=False, *,
                 master_dtype=torch.float32, stochastic_rounding=False):
        super().__init__(lr, master_dtype=master_dtype,
                         stochastic_rounding=stochastic_rounding)
        self.momentum = momentum
        self.dampening = dampening
        self.weight_decay = weight_decay
        self.nesterov = nesterov
        self.wd_after_momentum = wd_after_momentum

    def _init_slots(self, space, master):
        return _first_run_slots(master)

    def _update(self, state, g, lr, grad_scale, in_place):
        p2, mom2, found = fused_sgd_update(
            state.master, state.slots["momentum"], g, lr=lr,
            momentum=self.momentum, dampening=self.dampening,
            nesterov=self.nesterov, weight_decay=self.weight_decay,
            wd_after_momentum=self.wd_after_momentum,
            scale=_inv_scale(grad_scale, g.device),
            first_run=state.slots["initialized"] == 0, in_place=in_place,
            sr_seed=self._sr_seed(state))
        return p2, _momentum_slots(state, mom2), found


class FusedNovoGrad(FlatFusedOptimizer):
    """NovoGrad with a per-leaf scalar second moment (the reference's
    ``FusedNovoGrad``, :521): the per-leaf norms of the gradient (kernel
    ``sumsq``), the denominators on the device, then one sweep (kernel
    ``fused_novograd``). ``v`` is a ``(num_leaves,)`` fp32 slot. The
    gradient is divided by ``grad_scale`` in a plain pass first where
    the scale is not 1, as in the reference (:542): a 0-d device scale
    through ``torch.where`` (no host read); a host scale of 1 skips the
    pass (g / 1 is g, bit for bit). It has no clip of its own: clip
    first (``contrib.clip_grad.clip_grad_norm_``) or through
    ``make_train_step(max_grad_norm=...)``."""

    def __init__(self, lr=1e-3, betas=(0.95, 0.98), eps=1e-8,
                 weight_decay=0.0, grad_averaging=True, bias_correction=False,
                 *, master_dtype=torch.float32, stochastic_rounding=False):
        super().__init__(lr, master_dtype=master_dtype,
                         stochastic_rounding=stochastic_rounding)
        self.betas = betas
        self.eps = eps
        self.weight_decay = weight_decay
        self.grad_averaging = grad_averaging
        self.bias_correction = bias_correction

    def _init_slots(self, space, master):
        return {"m": torch.zeros_like(master, dtype=torch.float32),
                "v": torch.zeros(space.num_leaves, dtype=torch.float32,
                                 device=master.device)}

    def _update(self, state, g, lr, grad_scale, in_place):
        if isinstance(grad_scale, torch.Tensor):
            gs = _dev_f32(grad_scale, g.device)
            g = torch.where(gs != 1.0, g / gs, g)
        elif grad_scale != 1.0:
            g = g / _dev_f32(grad_scale, g.device)
        p2, m2, v2, found = fused_novograd_update(
            state.master, state.slots["m"], state.slots["v"], g, state.space,
            lr=lr, beta1=self.betas[0], beta2=self.betas[1], eps=self.eps,
            step=state.count + 1, weight_decay=self.weight_decay,
            grad_averaging=self.grad_averaging,
            bias_correction=self.bias_correction, in_place=in_place,
            sr_seed=self._sr_seed(state), norms=state.norms)
        return p2, {"m": m2, "v": v2}, found


class FusedAdagrad(FlatFusedOptimizer):
    """Adagrad in one fused kernel (the reference's ``FusedAdagrad``,
    :555; ``csrc/adagrad_novograd.cu``): L2 weight decay, the gradient
    multiplied by the fp32 reciprocal of ``grad_scale`` inside the sweep
    (a 0-d device scale, as the fused train step gives it, is read by
    pointer)."""

    def __init__(self, lr=1e-2, eps=1e-10, weight_decay=0.0, *,
                 master_dtype=torch.float32, stochastic_rounding=False):
        super().__init__(lr, master_dtype=master_dtype,
                         stochastic_rounding=stochastic_rounding)
        self.eps = eps
        self.weight_decay = weight_decay

    def _init_slots(self, space, master):
        return {"h": torch.zeros_like(master, dtype=torch.float32)}

    def _update(self, state, g, lr, grad_scale, in_place):
        p2, h2, found = fused_adagrad_update(
            state.master, state.slots["h"], g, lr=lr, eps=self.eps,
            weight_decay=self.weight_decay, grad_scale=grad_scale,
            in_place=in_place, sr_seed=self._sr_seed(state))
        return p2, {"h": h2}, found


class FusedLARS(FlatFusedOptimizer):
    """LARS: per-tensor adaptive lr and momentum SGD (the reference's
    ``FusedLARS``, :577): the per-tensor norms of the master and the
    gradient (kernel ``sumsq``), the ratios on the device, then one
    sweep (kernel ``fused_lars``). The gradient is divided by
    ``grad_scale`` before the norms, as the reference divides it (:597);
    by a 0-d tensor, since PyTorch multiplies a CUDA tensor by the
    reciprocal of a Python divisor. A host ``grad_scale`` of 1 skips
    that pass: g / 1 is g, bit for bit."""

    def __init__(self, lr, momentum=0.9, weight_decay=0.0,
                 trust_coefficient=0.02, eps=1e-8, clip=True, *,
                 master_dtype=torch.float32, stochastic_rounding=False):
        super().__init__(lr, master_dtype=master_dtype,
                         stochastic_rounding=stochastic_rounding)
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.trust_coefficient = trust_coefficient
        self.eps = eps
        self.clip = clip

    def _init_slots(self, space, master):
        return _first_run_slots(master)

    def _update(self, state, g, lr, grad_scale, in_place):
        if isinstance(grad_scale, torch.Tensor) or grad_scale != 1.0:
            g = g / _dev_f32(grad_scale, g.device)
        p2, mom2, found = fused_lars_update(
            state.master, state.slots["momentum"], g, state.space, lr=lr,
            momentum=self.momentum, weight_decay=self.weight_decay,
            trust_coefficient=self.trust_coefficient, eps=self.eps,
            clip=self.clip, first_run=state.slots["initialized"] == 0,
            in_place=in_place, sr_seed=self._sr_seed(state),
            norms=state.norms)
        return p2, _momentum_slots(state, mom2), found


class FusedMixedPrecisionLamb(FusedLAMB):
    """LAMB over a tree of fp32 and reduced-precision leaves (the
    reference's ``FusedMixedPrecisionLamb``, :608-647; its own reference
    is apex's ``fused_mixed_precision_lamb.py``). It is FusedLAMB with an
    fp32 master: every leaf is packed into the fp32 master, updated
    there, and ``step`` returns each leaf in its own dtype (the
    master -> model cast for the reduced leaves, the direct fp32 update
    for the rest). ``reduced_precision_dtype`` validates the reference's
    contract at init: every leaf is fp32 or that dtype. It is not a
    stochastic-rounding optimizer: for a bf16 master written with SR,
    use ``FusedLAMB(master_dtype=torch.bfloat16,
    stochastic_rounding=True)``."""

    def __init__(self, *args, reduced_precision_dtype=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.reduced_precision_dtype = reduced_precision_dtype

    def init(self, params: Mapping[str, torch.Tensor]) -> FlatOptState:
        if self.reduced_precision_dtype is not None:
            bad = {str(t.dtype).replace("torch.", "")
                   for t in params.values()
                   if t.dtype not in (torch.float32,
                                      self.reduced_precision_dtype)}
            if bad:
                rp = str(self.reduced_precision_dtype).replace("torch.", "")
                raise ValueError(f"params must be float32 or {rp}; found "
                                 f"{sorted(bad)}")
        return super().init(params)


__all__ = ["FlatFusedOptimizer", "FlatOptState", "FusedAdagrad", "FusedAdam",
           "FusedLAMB", "FusedLARS", "FusedMixedPrecisionLamb",
           "FusedNovoGrad", "FusedSGD", "check_leaf_dtypes",
           "segmented_layout", "validate_master_dtype"]
