"""Fused element-wise engine over flat buffers.

Counterpart of ``apex_tpu/multi_tensor/engine.py`` ``fused_elementwise``.
There one Pallas kernel sweeps the flat buffers with a Python functor
traced into it. A CUDA kernel cannot take a Python functor, so here each
functor that has a kernel registers it (:func:`register_kernel`): on
CUDA tensors ``fused_elementwise`` launches the functor's kernel, and a
functor without one raises. On CPU tensors it runs the functor itself
as plain PyTorch over whole buffers, the reference's
``_fused_elementwise_xla``. So far one functor has a kernel: Adam
(``multi_tensor/ops.py``, ``csrc/fused_adam.cu``).

``check_finite`` and ``found_inf`` keep the reference's meaning (a
float32 0-d tensor in {0, 1} over the named inputs). ``aliases`` maps an
input to the output that is written into it, in place, on both paths
(the reference's ``input_output_aliases``). The plain version also
takes the per-tensor scalars (``tile_ids`` / ``per_tensor``) and the
per-subtile sum-of-squares partials (``sumsq_subtiles``); on CUDA they
raise until their kernels are ported. Stochastic rounding
(``sr_outputs``) raises everywhere: the reference's plain path draws
``jax.random`` threefry bits, which the port does not reproduce yet.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch._backend import uses_kernel

LANES = 128
DEFAULT_TILE_ROWS = 512
# one per-tensor id per PER_TENSOR_TILE_ROWS * LANES elements: the
# FlatSpace alignment quantum
PER_TENSOR_TILE_ROWS = 16

# functor -> its CUDA launcher, launcher(inputs, outputs, scalars, found,
# check_finite); see register_kernel
_KERNELS: Dict[Callable, Callable] = {}


def register_kernel(fn: Callable, launcher: Callable) -> None:
    """Give functor ``fn`` a CUDA kernel. ``launcher(inputs, outputs,
    scalars, found, check_finite)`` gets the input buffers, the output
    buffers (an aliased output is its input), the scalars as Python
    floats already rounded to fp32, and a zeroed fp32 ``found``; it
    launches the kernel or raises on what the kernel does not take."""
    _KERNELS[fn] = launcher


def _pad_to(buf: torch.Tensor, n: int) -> torch.Tensor:
    if buf.shape[0] == n:
        return buf
    return torch.nn.functional.pad(buf, (0, n - buf.shape[0]))


def fused_elementwise(
    fn: Callable,
    inputs: Sequence[torch.Tensor],
    *,
    scalars: Sequence = (),
    num_outputs: int = 1,
    out_dtypes: Optional[Sequence[torch.dtype]] = None,
    check_finite: Sequence[int] = (),
    tile_ids: Optional[np.ndarray] = None,
    per_tensor: Sequence = (),
    tile_rows: Optional[int] = None,
    aliases: Optional[Dict[int, int]] = None,
    sumsq_subtiles: Sequence = (),
    sr_outputs: Sequence[int] = (),
    sr_seed=None,
    kernel: Optional[bool] = None,
) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Run ``fn`` element-wise over same-length 1-D buffers.

    ``fn(ins, scalars, tensor_scalars) -> list of outputs``, with
    ``scalars`` as fp32 0-d tensors and ``tensor_scalars`` broadcastable
    against the blocks (per-tensor values resolved through the
    subtile-granular ``tile_ids``, as in the reference). Returns
    ``(outputs, found_inf)``; ``sumsq_subtiles`` partials, shaped
    ``(num_tiles, tile_rows // PER_TENSOR_TILE_ROWS, LANES)``, follow
    the outputs. ``kernel`` defaults to whether the buffers lie on a
    CUDA device; ``kernel=False`` runs the plain version on any device
    (the yardstick the kernels are held against on the card)."""
    n = inputs[0].shape[0]
    for b in inputs:
        if b.ndim != 1 or b.shape[0] != n:
            raise ValueError("flat buffers must be same-length 1-D")
    if out_dtypes is None:
        out_dtypes = [inputs[0].dtype] * num_outputs
    if sr_outputs or sr_seed is not None:
        raise NotImplementedError(
            "stochastic rounding (sr_outputs) is not ported yet: the "
            "reference's plain path draws jax.random threefry bits")
    tile_rows = DEFAULT_TILE_ROWS if tile_rows is None else tile_rows
    for kind, idx in sumsq_subtiles:
        if kind not in ("in", "out") or not (
                0 <= idx < (len(inputs) if kind == "in" else num_outputs)):
            raise ValueError(f"bad sumsq_subtiles entry {(kind, idx)}")
    if (sumsq_subtiles or tile_ids is not None) \
            and tile_rows % PER_TENSOR_TILE_ROWS:
        raise ValueError(
            f"sumsq_subtiles/tile_ids need tile_rows divisible by "
            f"{PER_TENSOR_TILE_ROWS}, got {tile_rows}")
    aliases = dict(aliases or {})
    for in_idx, out_idx in aliases.items():
        if not (0 <= in_idx < len(inputs) and 0 <= out_idx < num_outputs):
            raise ValueError(
                f"alias {in_idx}->{out_idx} out of range: {len(inputs)} "
                f"inputs, {num_outputs} outputs")
        if inputs[in_idx].dtype != out_dtypes[out_idx]:
            raise TypeError(
                f"alias {in_idx}->{out_idx}: input {inputs[in_idx].dtype} "
                f"cannot hold output {out_dtypes[out_idx]} in place")

    if kernel is None:
        kernel = uses_kernel(inputs[0])
    if kernel:
        return _fused_elementwise_cuda(fn, inputs, scalars, num_outputs,
                                       out_dtypes, check_finite, tile_ids,
                                       per_tensor, aliases, sumsq_subtiles)
    outs, found = _fused_elementwise_torch(
        fn, inputs, scalars, num_outputs, out_dtypes, check_finite,
        tile_ids, per_tensor, tile_rows * LANES, sumsq_subtiles)
    for in_idx, out_idx in aliases.items():
        inputs[in_idx].copy_(outs[out_idx])
        outs[out_idx] = inputs[in_idx]
    return outs, found


def _fused_elementwise_cuda(fn, inputs, scalars, num_outputs, out_dtypes,
                            check_finite, tile_ids, per_tensor, aliases,
                            sumsq_subtiles):
    launcher = _KERNELS.get(fn)
    if launcher is None:
        raise NotImplementedError(
            f"functor {getattr(fn, '__name__', fn)!r} has no CUDA kernel "
            "yet; only the functors with a ported kernel run on CUDA "
            "tensors (it runs on CPU tensors)")
    if tile_ids is not None or per_tensor or sumsq_subtiles:
        raise NotImplementedError(
            "per-tensor scalars (tile_ids/per_tensor) and sumsq_subtiles "
            "have no CUDA kernel yet (they come with the LAMB kernels)")
    dev = inputs[0].device
    n = inputs[0].shape[0]
    by_out = {o: i for i, o in aliases.items()}
    outs = [inputs[by_out[j]] if j in by_out else
            torch.empty(n, dtype=out_dtypes[j], device=dev)
            for j in range(num_outputs)]
    found = torch.zeros((), dtype=torch.float32, device=dev)
    vals = [float(torch.as_tensor(s, dtype=torch.float32)) for s in scalars]
    launcher(list(inputs), outs, vals, found, tuple(check_finite))
    return outs, found


def _fused_elementwise_torch(fn, inputs, scalars, num_outputs, out_dtypes,
                             check_finite, tile_ids, per_tensor, tile,
                             sumsq_subtiles):
    """Plain version (the reference's ``_fused_elementwise_xla``)."""
    n = inputs[0].shape[0]
    dev = inputs[0].device
    sub_elems = PER_TENSOR_TILE_ROWS * LANES
    svals = [torch.as_tensor(s, dtype=torch.float32, device=dev)
             for s in scalars]
    if tile_ids is not None:
        # subtile-granular ids: blocks reshape at subtile granularity and
        # the per-tensor values broadcast as (n_subtiles, 1)
        ids = torch.as_tensor(np.asarray(tile_ids), dtype=torch.long,
                              device=dev)
        padded_n = ids.shape[0] * sub_elems
        bufs = [_pad_to(b, padded_n).reshape(-1, sub_elems) for b in inputs]
        tvals = [torch.as_tensor(p, dtype=torch.float32, device=dev)[ids][
            :, None] for p in per_tensor]
    else:
        bufs = list(inputs)
        tvals = [torch.as_tensor(p, dtype=torch.float32, device=dev)
                 for p in per_tensor]
    found = torch.zeros((), dtype=torch.float32, device=dev)
    for idx in check_finite:
        found = torch.maximum(found, (~torch.isfinite(bufs[idx]).all()).to(
            torch.float32))
    raw = fn(bufs, svals, tvals)
    if len(raw) != num_outputs:
        raise ValueError(f"functor returned {len(raw)} outputs, expected "
                         f"{num_outputs}")
    outs = [(o.reshape(-1)[:n] if tile_ids is not None else o).to(dt)
            for o, dt in zip(raw, out_dtypes)]
    if sumsq_subtiles:
        # the kernel's (num_tiles, sub, LANES) partial layout
        num_tiles = -(-n // tile)
        sub = tile // sub_elems
        for kind, idx in sumsq_subtiles:
            src = (inputs[idx] if kind == "in"
                   else raw[idx].reshape(-1)[:n])
            x = _pad_to(src.float(), num_tiles * tile)
            outs.append(torch.sum(
                x.reshape(num_tiles, sub, PER_TENSOR_TILE_ROWS, LANES) ** 2,
                dim=2))
    return outs, found


__all__ = ["LANES", "DEFAULT_TILE_ROWS", "PER_TENSOR_TILE_ROWS",
           "fused_elementwise", "register_kernel"]
