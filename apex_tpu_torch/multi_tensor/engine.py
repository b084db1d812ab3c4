"""Fused element-wise engine over flat buffers.

Counterpart of ``apex_tpu/multi_tensor/engine.py`` ``fused_elementwise``
and ``fused_sumsq_partials``. There one Pallas kernel sweeps the flat
buffers with a Python functor traced into it. A CUDA kernel cannot take
a Python functor, so here each functor that has a kernel registers it
(:func:`register_kernel`): on CUDA tensors ``fused_elementwise``
launches the functor's kernel, and a functor without one raises. On CPU
tensors it runs the functor itself as plain PyTorch over whole buffers,
the reference's ``_fused_elementwise_xla``. Every functor of
``multi_tensor/ops.py`` has a kernel: scale and axpby
(``csrc/scale_axpby.cu``), Adam (``csrc/fused_adam.cu``), Adagrad and
NovoGrad (``csrc/adagrad_novograd.cu``), the two LAMB stages
(``csrc/fused_lamb.cu``), SGD and LARS (``csrc/fused_sgd.cu``).

``check_finite`` and ``found_inf`` keep the reference's meaning (a
float32 0-d tensor in {0, 1} over the named inputs). ``aliases`` maps an
input to the output that is written into it, in place, on both paths
(the reference's ``input_output_aliases``). Per-tensor scalars (``tile_ids`` / ``per_tensor``) and the
per-subtile sum-of-squares partials (``sumsq_subtiles``) reach the
kernels; on CUDA the partials come one value a 2048-element subtile,
shaped ``(num_tiles, sub, 1)`` (the plain version's 128 lanes are summed
already — every consumer sums the lanes first). A scalar or per-tensor
value that is a tensor on the card stays there: the kernel reads it
through a pointer, so no step waits on a host read.

Stochastic rounding (``sr_outputs``, ``sr_seed``) writes a bf16 output
with E[result] equal to its fp32 value: 16 random bits added below the
bf16 mantissa boundary, then truncated (:func:`stochastic_round_cast`).
The bits are the reference's xla/interpret stream, ``jax.random.bits``
of ``fold_in(PRNGKey(sr_seed), j)`` over the element's flat index for
output ``j`` (``apex_tpu_torch.random``), bitwise on both paths: the
plain path casts the fp32 output, the kernels hash each element in their
epilogue (``csrc/sr_common.cuh``) with the key's two words computed on
the host. The optimizers' functors take SR on output 0, p'; the
reference's compiled-TPU kernels draw the TPU's hardware generator,
which no other device reproduces.

``fused_sumsq_partials`` (the reference's kernels #7 and #8) runs
``csrc/sumsq.cu`` on CUDA tensors (fp32 or bf16) and its plain version on
CPU tensors; ``stochastic_round_cast`` runs ``csrc/stochastic_round.cu``
on CUDA tensors.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch import _build
from apex_tpu_torch._backend import check_kernel_input, uses_kernel
from apex_tpu_torch.multi_tensor.flat_buffer import DEFAULT_ALIGN
from apex_tpu_torch.random import M32, bits as threefry_bits, threefry2x32

LANES = 128
DEFAULT_TILE_ROWS = 512
# one per-tensor id per PER_TENSOR_TILE_ROWS * LANES elements: the
# FlatSpace alignment quantum
PER_TENSOR_TILE_ROWS = 16

SUMSQ_KERNEL = "sumsq"
SUMSQ_SCALED_KERNEL = "sumsq_scaled"
LEAF_SUM_KERNEL = "leaf_sum"
LEAF_SUM_THREADS = 256      # the kernel's block: the width of its order
LEAF_SUM_CHUNK = 2048       # partials a block sums: 8 a thread
SR_CAST_KERNEL = "stochastic_round"

# functor -> its CUDA launcher; see register_kernel
_KERNELS: Dict[Callable, Callable] = {}


def register_kernel(fn: Callable, launcher: Callable) -> None:
    """Give functor ``fn`` a CUDA kernel. ``launcher(inputs, outputs,
    scalars, found, check_finite, per_tensor, tile_ids, sumsq, sr)`` gets
    the input buffers, the output buffers (an aliased output is its
    input), the scalars (:func:`kernel_scalar`: Python floats rounded to
    fp32, or 0-d fp32 tensors on the card), a zeroed fp32 ``found``, the
    per-tensor values as fp32 tensors on the card, the int32 subtile ->
    leaf map on the card (or None), and ``sumsq``, a list of
    ``(kind, idx, partials)`` with one fp32 buffer of ``ceil(n / 2048)``
    or more elements per requested partial, and ``sr``: None, or the
    threefry key words ``(k0, k1)`` of output 0's stochastic rounding
    (:func:`sr_key_words`; output 0 is then bf16). It launches the
    kernel or raises on what the kernel does not take."""
    _KERNELS[fn] = launcher


def kernel_scalar(s, device: torch.device):
    """A scalar as a kernel takes it: a 0-d tensor on ``device`` stays
    there as fp32 (the kernel reads it through its pointer, so nothing
    waits for the device); anything else becomes a Python float rounded
    to fp32."""
    if isinstance(s, torch.Tensor) and s.device.type == "cuda":
        if s.numel() != 1:
            raise ValueError(f"a scalar must have one element, got "
                             f"shape {tuple(s.shape)}")
        if s.device != device:
            raise ValueError(f"scalar on {s.device}, buffers on {device}")
        return s.reshape(()).to(torch.float32).contiguous()
    return float(np.float32(float(s)))


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """``torch.sqrt`` rounded correctly, as the kernels' ``__fsqrt_rn``
    and the reference's XLA sqrt are. PyTorch's fp32 sqrt on the CPU is
    not: its vectorized kernel is an ulp off on some elements, and its
    first call in a process has returned one worker thread's chunk of a
    large tensor far off. So an fp32 CPU tensor takes the root in fp64
    and rounds once, which is exact (53 >= 2 * 24 + 2 bits), through
    numpy's single-threaded, correctly rounded ``sqrt`` rather than any
    of PyTorch's threaded CPU kernels."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        root = np.sqrt(x.detach().numpy().astype(np.float64))
        return torch.from_numpy(np.asarray(root.astype(np.float32)))
    return torch.sqrt(x)


def scalar_pointer(s) -> Tuple[float, Optional[int]]:
    """``(value, pointer)`` of a :func:`kernel_scalar` for a C launcher:
    a device scalar passes its address (and 0.0), a host one its value
    (and a null pointer)."""
    if isinstance(s, torch.Tensor):
        return 0.0, s.data_ptr()
    return s, None


def sr_key_words(seed, salt: int = 0) -> Tuple[int, int]:
    """The two uint32 words of ``fold_in(PRNGKey(seed), salt)``, the key
    of a stochastic-rounding stream (the reference's
    ``stochastic_round_cast``, which reads an int32 ``seed`` as uint32),
    computed on the host."""
    return threefry2x32(0, int(seed) & M32, 0, int(salt) & M32)


def sr_round_bits(x: torch.Tensor, rbits: torch.Tensor) -> torch.Tensor:
    """``x`` (fp32) to bf16 by adding the low 16 bits of ``rbits`` (uint32
    values in an int64 tensor of x's shape) and truncating; non-finite
    values take a nearest cast. The plain version of
    ``csrc/sr_common.cuh`` ``sr_to_bf16``."""
    xf = x.float()
    xi = xf.view(torch.int32).long() & M32
    t = (xi + (rbits & 0xFFFF)) & 0xFFFF0000
    trunc = torch.where(t >= 2 ** 31, t - 2 ** 32, t).to(torch.int32)
    return torch.where(torch.isfinite(xf), trunc.view(torch.float32),
                       xf).to(torch.bfloat16)


def murmur_bits(seed, idx: torch.Tensor) -> torch.Tensor:
    """The segment kernel's counter hash (the reference's
    ``segmented.py`` :244-255, the murmur3 finalizer) of the flat indices
    ``idx`` (int64) under ``seed``, as uint32 values in int64: the index
    wraps at 2^32 as the reference's uint32 iota does."""
    h = (idx & M32) ^ ((int(seed) * 0x9E3779B9) & M32)
    h = ((h ^ (h >> 16)) * 0x85EBCA6B) & M32
    h = ((h ^ (h >> 13)) * 0xC2B2AE35) & M32
    return h ^ (h >> 16)


def stochastic_round_cast(x: torch.Tensor, seed, salt: int = 0, *,
                          plain: bool = False) -> torch.Tensor:
    """fp32 -> bf16 stochastic rounding (the reference's
    ``stochastic_round_cast``, engine.py:48-67): the threefry bits of
    ``fold_in(PRNGKey(seed), salt)`` over each element's flat index,
    their low 16 added below the bf16 mantissa boundary, then truncated;
    E[result] is x. Non-finite values take a nearest cast. On a CUDA
    tensor this launches ``csrc/stochastic_round.cu`` (counted as
    ``stochastic_round``); on a CPU tensor, or with ``plain=True``, the
    plain version."""
    if not plain and uses_kernel(x):
        return _sr_cast_cuda(x, sr_key_words(seed, salt))
    k = sr_key_words(seed, salt)
    return sr_round_bits(x, threefry_bits(k, x.shape, x.device))


def _sr_cast_cuda(x: torch.Tensor, key: Tuple[int, int]) -> torch.Tensor:
    dev = x.device
    x = x.contiguous()
    check_kernel_input("x", x, (torch.float32,), dev)
    y = torch.empty(x.shape, dtype=torch.bfloat16, device=dev)
    P, L, U = _build.P, _build.L, _build.U
    lib = _build.library("stochastic_round", "apex_sr_cast",
                         (P, P, L, U, U, P), "apex_sr_cast_error_string")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.apex_sr_cast(x.data_ptr(), y.data_ptr(), x.numel(), *key,
                               stream)
    if err:
        raise RuntimeError(f"{SR_CAST_KERNEL}: CUDA error {err} at launch: "
                           f"{lib.apex_sr_cast_error_string(err).decode()}")
    _build.count_launch(SR_CAST_KERNEL)
    return y


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
    the outputs (``(num_tiles, sub, 1)`` on CUDA, see the module
    docstring). ``kernel`` defaults to whether the buffers lie on a
    CUDA device; ``kernel=False`` runs the plain version on any device
    (the yardstick the kernels are held against on the card).

    ``sr_outputs`` lists outputs written with stochastic rounding to
    bf16 (their ``out_dtypes`` entry must be bf16, and ``sr_seed`` an
    integer, the reference's int32 seed), output ``j`` from the stream
    of ``fold_in(PRNGKey(sr_seed), j)``; the kernels take it on output 0
    (p') only."""
    n = inputs[0].shape[0]
    for b in inputs:
        if b.ndim != 1 or b.shape[0] != n:
            raise ValueError("flat buffers must be same-length 1-D")
    if out_dtypes is None:
        out_dtypes = [inputs[0].dtype] * num_outputs
    sr_outputs = tuple(sr_outputs)
    if sr_outputs:
        if sr_seed is None:
            raise ValueError("sr_outputs requires sr_seed")
        for j in sr_outputs:
            if not 0 <= j < num_outputs:
                raise ValueError(f"sr output {j} out of range")
            if out_dtypes[j] != torch.bfloat16:
                raise ValueError(
                    f"stochastic rounding targets bfloat16 outputs; "
                    f"output {j} is {out_dtypes[j]}")
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
        if sr_outputs and sr_outputs != (0,):
            raise NotImplementedError(
                f"the kernels write output 0 (p') with stochastic rounding; "
                f"sr_outputs={sr_outputs} is not built")
        return _fused_elementwise_cuda(
            fn, inputs, scalars, num_outputs, out_dtypes, check_finite,
            tile_ids, per_tensor, aliases, sumsq_subtiles, tile_rows,
            sr_key_words(sr_seed, 0) if sr_outputs else None)
    outs, found = _fused_elementwise_torch(
        fn, inputs, scalars, num_outputs, out_dtypes, check_finite,
        tile_ids, per_tensor, tile_rows * LANES, sumsq_subtiles, sr_outputs,
        sr_seed)
    for in_idx, out_idx in aliases.items():
        inputs[in_idx].copy_(outs[out_idx])
        outs[out_idx] = inputs[in_idx]
    return outs, found


def _fused_elementwise_cuda(fn, inputs, scalars, num_outputs, out_dtypes,
                            check_finite, tile_ids, per_tensor, aliases,
                            sumsq_subtiles, tile_rows, sr):
    launcher = _KERNELS.get(fn)
    if launcher is None:
        raise NotImplementedError(
            f"functor {getattr(fn, '__name__', fn)!r} has no CUDA kernel: "
            "on CUDA tensors fused_elementwise runs the functors of "
            "multi_tensor/ops.py, each through its registered kernel; "
            "another functor runs on CPU tensors only")
    dev = inputs[0].device
    n = inputs[0].shape[0]
    by_out = {o: i for i, o in aliases.items()}
    outs = [inputs[by_out[j]] if j in by_out else
            torch.empty(n, dtype=out_dtypes[j], device=dev)
            for j in range(num_outputs)]
    found = torch.zeros((), dtype=torch.float32, device=dev)
    vals = [kernel_scalar(s, dev) for s in scalars]
    ids = None
    if tile_ids is not None:
        ids = (tile_ids if isinstance(tile_ids, torch.Tensor) else
               torch.as_tensor(np.asarray(tile_ids, np.int32)))
        ids = ids.to(dev, torch.int32)
        if ids.shape[0] * PER_TENSOR_TILE_ROWS * LANES < n:
            raise ValueError(f"tile_ids cover {ids.shape[0]} subtiles; "
                             f"{n} elements need more")
    pt = [torch.as_tensor(p, dtype=torch.float32, device=dev).reshape(-1)
          .contiguous() for p in per_tensor]
    tile = tile_rows * LANES
    num_tiles = -(-n // tile)
    sub = tile // (PER_TENSOR_TILE_ROWS * LANES)
    n_sub = -(-n // (PER_TENSOR_TILE_ROWS * LANES))
    sumsq = []
    for kind, idx in sumsq_subtiles:
        part = torch.empty(num_tiles * sub, dtype=torch.float32, device=dev)
        part[n_sub:].zero_()
        sumsq.append((kind, idx, part))
    launcher(list(inputs), outs, vals, found, tuple(check_finite), pt, ids,
             sumsq, sr)
    outs.extend(part.view(num_tiles, sub, 1) for _, _, part in sumsq)
    return outs, found


def _fused_elementwise_torch(fn, inputs, scalars, num_outputs, out_dtypes,
                             check_finite, tile_ids, per_tensor, tile,
                             sumsq_subtiles, sr_outputs=(), sr_seed=None):
    """Plain version (the reference's ``_fused_elementwise_xla``)."""
    n = inputs[0].shape[0]
    dev = inputs[0].device
    sub_elems = PER_TENSOR_TILE_ROWS * LANES
    svals = [torch.as_tensor(s, dtype=torch.float32, device=dev)
             for s in scalars]
    if tile_ids is not None:
        # subtile-granular ids: blocks reshape at subtile granularity and
        # the per-tensor values broadcast as (n_subtiles, 1)
        ids = (tile_ids.to(dev, torch.long)
               if isinstance(tile_ids, torch.Tensor) else
               torch.as_tensor(np.asarray(tile_ids), dtype=torch.long,
                               device=dev))
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
    outs = [o.reshape(-1)[:n] if tile_ids is not None else o for o in raw]
    outs = [stochastic_round_cast(o, sr_seed, j, plain=True)
            if j in sr_outputs else o.to(dt)
            for j, (o, dt) in enumerate(zip(outs, out_dtypes))]
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


# ---------------------------------------------------------------------------
# Per-tile sums of squares (global and per-tensor L2 norms)
# ---------------------------------------------------------------------------


def fused_sumsq_partials(buf: torch.Tensor, tile_rows: Optional[int] = None,
                         scale=None, *, plain: bool = False) -> torch.Tensor:
    """Per-tile partial sums of squares of a flat buffer, ``(num_tiles,)``
    fp32 for tiles of ``tile_rows * 128`` elements (default 512 rows, a
    65,536-element tile, for a global norm; ``PER_TENSOR_TILE_ROWS`` for
    per-tensor norms, whose tiles never straddle a leaf).

    ``buf`` is fp32 or bf16 (a bf16 master's ``||p||``, read as fp32).
    ``scale`` (a number, or a 0-d tensor that may live on the card)
    multiplies every element before it is squared, in the same read:
    the fused train step's unscale. On CUDA tensors this launches
    ``csrc/sumsq.cu`` (counted as ``sumsq``, or ``sumsq_scaled`` with a
    scale, each with ``_bf16`` for a bf16 buffer); on CPU tensors, or with ``plain=True``, the plain version
    (the reference's ``impl="xla"`` branch). The finishing sum is the
    caller's."""
    tile_rows = DEFAULT_TILE_ROWS if tile_rows is None else tile_rows
    tile = tile_rows * LANES
    if buf.ndim != 1:
        raise ValueError("fused_sumsq_partials takes a 1-D buffer")
    n = buf.shape[0]
    num_tiles = -(-n // tile)
    if not plain and uses_kernel(buf):
        return _sumsq_cuda(buf, tile, num_tiles, scale)
    x = _pad_to(buf, num_tiles * tile).float()
    if scale is not None:
        x = x * torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    x = x.reshape(num_tiles, tile)
    return torch.sum(x * x, dim=1)


def _sumsq_cuda(buf, tile, num_tiles, scale) -> torch.Tensor:
    dev = buf.device
    check_kernel_input("buf", buf, (torch.float32, torch.bfloat16), dev)
    out = torch.empty(num_tiles, dtype=torch.float32, device=dev)
    if scale is not None:
        s = kernel_scalar(scale, dev)
        if not isinstance(s, torch.Tensor):     # a fill: no host copy
            s = torch.full((), s, dtype=torch.float32, device=dev)
    P, L = _build.P, _build.L
    lib = _build.library("sumsq", "apex_sumsq", (P, P, L, L, P, _build.I, P),
                         "apex_sumsq_error_string")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.apex_sumsq(buf.data_ptr(), out.data_ptr(), buf.shape[0],
                             tile, None if scale is None else s.data_ptr(),
                             int(buf.dtype == torch.bfloat16), stream)
    name = SUMSQ_KERNEL if scale is None else SUMSQ_SCALED_KERNEL
    if buf.dtype == torch.bfloat16:
        name += "_bf16"             # counted apart: a bf16 master's ||p||
    if err:
        raise RuntimeError(f"{name}: CUDA error {err} at launch: "
                           f"{lib.apex_sumsq_error_string(err).decode()}")
    _build.count_launch(name)
    return out


def leaf_runs(space) -> torch.Tensor:
    """(num_leaves, 2) int32 ``[start, end)`` of each leaf's per-subtile
    partials (subtiles of ``DEFAULT_ALIGN`` elements: no subtile straddles
    two leaves), on the CPU."""
    sub = DEFAULT_ALIGN
    return torch.tensor([[off // sub, (off + size) // sub] for off, size in
                         zip(space.offsets, space.padded_sizes)],
                        dtype=torch.int32).reshape(-1, 2)


def leaf_chunks(runs: torch.Tensor) -> torch.Tensor:
    """(n_chunks, 2) int32 ``[leaf, chunk within the leaf]``, on the CPU:
    each run of ``runs`` cut into ``LEAF_SUM_CHUNK`` partials (an empty
    run is one chunk), a leaf's chunks consecutive and in order."""
    length = (runs[:, 1] - runs[:, 0]).long().cpu()
    n = ((length + LEAF_SUM_CHUNK - 1) // LEAF_SUM_CHUNK).clamp_min(1)
    leaf = torch.repeat_interleave(torch.arange(len(n)), n)
    first = torch.repeat_interleave(torch.cumsum(n, 0) - n, n)
    chunk = torch.arange(len(leaf)) - first
    return torch.stack([leaf, chunk], 1).to(torch.int32)


def _leaf_sum_scratch(runs: torch.Tensor):
    """The kernel's tables for ``runs`` (CPU): each block's span
    ``[lo, hi, leaf, (c << 16) | n]`` (chunk c of its leaf's n), a
    partial a block and a zeroed counter a leaf."""
    chunks = leaf_chunks(runs).long()
    leaf, c = chunks[:, 0], chunks[:, 1]
    start, end = runs[:, 0].long(), runs[:, 1].long()
    n = torch.bincount(leaf, minlength=runs.shape[0])
    if len(n) and int(n.max()) >= 1 << 16:
        raise ValueError(f"a run of {int((end - start).max())} partials "
                         f"passes the kernel's {(1 << 16) - 1} chunks")
    lo = start[leaf] + c * LEAF_SUM_CHUNK
    hi = torch.minimum(lo + LEAF_SUM_CHUNK, end[leaf])
    spans = torch.stack([lo, hi, leaf, (c << 16) | n[leaf]], 1).to(
        torch.int32)
    return (spans, torch.zeros(len(chunks), dtype=torch.float32),
            torch.zeros(runs.shape[0], dtype=torch.int32))


def _leaf_sum_torch(x: torch.Tensor, runs: torch.Tensor) -> torch.Tensor:
    """Plain version of ``leaf_sum``: each run of ``x`` summed in the
    kernel's order. A run is cut into chunks of ``LEAF_SUM_CHUNK``
    (:func:`leaf_chunks`); in a chunk, element j goes to running sum j
    mod ``LEAF_SUM_THREADS``, in turn, from +0, then a halving tree
    (``v[i] += v[i + s]``, s = 128, ..., 1) gives the chunk's sum; a
    leaf's sum is its chunks' sums added in chunk order. Absent elements
    and chunks add +0, which changes no sum started from +0, so the
    result is bitwise the kernel's."""
    dev = x.device
    runs_l = runs.to(dev).long()
    chunks = leaf_chunks(runs).to(dev).long()
    leaf, c = chunks[:, 0], chunks[:, 1]
    lo = runs_l[leaf, 0] + c * LEAF_SUM_CHUNK
    hi = torch.minimum(lo + LEAF_SUM_CHUNK, runs_l[leaf, 1])
    idx = lo[:, None] + torch.arange(LEAF_SUM_CHUNK, device=dev)[None, :]
    vals = torch.where(idx < hi[:, None],
                       x[idx.clamp(0, max(x.shape[0] - 1, 0))],
                       torch.zeros((), dtype=torch.float32, device=dev))
    w = LEAF_SUM_THREADS
    vals = vals.view(-1, LEAF_SUM_CHUNK // w, w)
    acc = torch.zeros(vals.shape[0], w, dtype=torch.float32, device=dev)
    for k in range(vals.shape[1]):
        acc = acc + vals[:, k]
    while w > 1:
        w //= 2
        acc = acc[:, :w] + acc[:, w:2 * w]
    n_leaves = runs.shape[0]
    depth = int(c.max()) + 1 if len(c) else 1
    per_leaf = torch.zeros(n_leaves, depth, dtype=torch.float32, device=dev)
    per_leaf[leaf, c] = acc[:, 0]
    total = per_leaf[:, 0]
    for k in range(1, depth):
        total = total + per_leaf[:, k]
    return total


def leaf_sums(per_subtile: torch.Tensor, space, *,
              plain: bool = False) -> torch.Tensor:
    """(num_leaves,) fp32 sums of per-subtile values by leaf, in one
    fixed order (:func:`_leaf_sum_torch`): the reference's
    ``jax.ops.segment_sum`` over ``tile_leaf_ids``. On a CUDA tensor the
    ``leaf_sum`` kernel of ``csrc/sumsq.cu`` (bitwise the plain version,
    and the same bits on every run); on a CPU tensor, or with
    ``plain=True``, the plain version. The kernel's block spans, its
    per-leaf counters and its chunk scratch are kept with the space, per
    device (:func:`_leaf_sum_scratch`), so calls over one space on one
    device run on one stream."""
    dev = per_subtile.device
    key = ("leaf_runs", dev)
    cached = space._device_ids.get(key)
    if cached is None:
        runs = leaf_runs(space)
        cached = space._device_ids[key] = (runs.to(dev),) + tuple(
            t.to(dev) for t in _leaf_sum_scratch(runs))
    runs, spans, partial, count = cached
    x = per_subtile.float().contiguous()
    if plain or not uses_kernel(x):
        return _leaf_sum_torch(x, runs)
    check_kernel_input("partials", x, (torch.float32,), dev)
    out = torch.empty(runs.shape[0], dtype=torch.float32, device=dev)
    lib = _build.library("sumsq", "apex_leaf_sum",
                         (_build.P,) * 5 + (_build.I, _build.P),
                         "apex_sumsq_error_string")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.apex_leaf_sum(x.data_ptr(), spans.data_ptr(),
                                partial.data_ptr(), count.data_ptr(),
                                out.data_ptr(), spans.shape[0], stream)
    if err:
        raise RuntimeError(f"{LEAF_SUM_KERNEL}: CUDA error {err} at launch: "
                           f"{lib.apex_sumsq_error_string(err).decode()}")
    _build.count_launch(LEAF_SUM_KERNEL)
    return out


__all__ = ["LANES", "DEFAULT_TILE_ROWS", "LEAF_SUM_CHUNK", "LEAF_SUM_KERNEL",
           "PER_TENSOR_TILE_ROWS",
           "SR_CAST_KERNEL", "SUMSQ_KERNEL", "SUMSQ_SCALED_KERNEL",
           "fused_elementwise", "fused_sumsq_partials", "kernel_scalar",
           "leaf_chunks", "leaf_sums",
           "murmur_bits", "register_kernel", "scalar_pointer",
           "sqrt_rn", "sr_key_words", "sr_round_bits",
           "stochastic_round_cast"]
