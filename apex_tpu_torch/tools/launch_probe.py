"""Which launch shapes does the card take? Probes of sm_90's launch
limits for the port's kernels.

Counterpart of ``tools/mosaic_probe.py``, which asks Mosaic which
BlockSpec tilings it accepts. ``probe`` runs ``x * 2`` over each of the
reference's fourteen (array, block, grid) cases (:40-77), one CUDA block
per grid point at the origin its index map gives (``csrc/launch_probe.cu``
``apex_probe_tiles``); then the limits the port's kernels rely on
(``apex_probe_launch``): threads per block 32 to 1024 (2048 must fail),
dynamic shared memory 0 to 227 KB (more must fail), thread-block clusters
of 1 to 8 blocks (portable), 16 (non-portable, with the attribute) and 32
(must fail). ``probe_subtile_gather`` runs the engine's per-subtile scalar
gather and broadcast (:80-125) at the reference's sizes. Each case prints
PASS (launched, the output right), WRONG (launched, the output wrong) or
FAIL (refused, with CUDA's reason), as the reference's do::

    python -m apex_tpu_torch.tools.launch_probe

Needs a CUDA device (raises without one). Every case has a plain version
(:func:`plain_tiles`, :func:`plain_gather`), which the CPU tests hold to
numpy.
"""

from __future__ import annotations

import math
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch import _build

TILES_KERNEL = "launch_probe_tiles"
LIMITS_KERNEL = "launch_probe_limits"
GATHER_KERNEL = "launch_probe_gather"

# sm_90's limits (CUDA C++ Programming Guide, compute capability 9.0)
MAX_THREADS = 1024
MAX_DYNAMIC_SMEM = 232_448          # 227 KB, after the opt-in attribute
MAX_PORTABLE_CLUSTER = 8
MAX_CLUSTER = 16                    # with the non-portable attribute


class Case(NamedTuple):
    name: str
    arr_shape: Tuple[int, ...]
    block_shape: Tuple[int, ...]
    index_map: Callable
    grid: Tuple[int, ...]


# tools/mosaic_probe.py :40-77, the fourteen cases as written there
# (``jnp.minimum`` is ``min``)
CASES = (
    Case("2d (1,128) of (16,256)", (16, 256), (1, 128),
         lambda i, j: (i, j), (16, 2)),
    Case("2d (1,256) of (16,256)", (16, 256), (1, 256),
         lambda i: (i, 0), (16,)),
    Case("3d (1,1,128) of (4,4,256)", (4, 4, 256), (1, 1, 128),
         lambda i, j, k: (i, j, k), (4, 4, 2)),
    Case("2d (8,128) of (16,256)", (16, 256), (8, 128),
         lambda i, j: (i, j), (2, 2)),
    Case("2d (1,1) of (16,16)", (16, 16), (1, 1),
         lambda i, j: (i, j), (16, 16)),
    Case("2d (128,1) of (256,4)", (256, 4), (128, 1),
         lambda i, j: (i, j), (2, 4)),
    Case("3d (1,128,64) of (8,256,64)", (8, 256, 64), (1, 128, 64),
         lambda i, j: (i, j, 0), (8, 2)),
    Case("2d (1,512) of (8,512)", (8, 512), (1, 512),
         lambda i: (i, 0), (8,)),
    Case("3d banded index map", (8, 256, 128), (1, 128, 128),
         lambda i, j: (i, min(j, 1), 0), (8, 2)),
    Case("3d (1,128,1) of (8,256,1)", (8, 256, 1), (1, 128, 1),
         lambda i, j: (i, j, 0), (8, 2)),
    Case("3d (1,1,128) of (8,1,256)", (8, 1, 256), (1, 1, 128),
         lambda i, j: (i, 0, j), (8, 2)),
    Case("2d (8,128) int-ish of (64,256)", (64, 256), (8, 128),
         lambda i, j: (i, j), (8, 2)),
    Case("2d (1,1) of (1,1)", (1, 1), (1, 1), lambda: (0, 0), ()),
    Case("2d (16,128) of (16,128)", (16, 128), (16, 128),
         lambda: (0, 0), ()),
)


class Limit(NamedTuple):
    name: str
    threads: int
    smem: int          # dynamic shared memory bytes
    cluster: int
    valid: bool        # inside sm_90's limits: must PASS, else FAIL


def limit_cases() -> List[Limit]:
    """The launch limits the port's kernels rely on, with the first
    shape past each."""
    out = [Limit(f"threads {t}", t, 0, 1, t <= MAX_THREADS)
           for t in (32, 64, 128, 256, 512, 1024, 2048)]
    for kb in (0, 16, 48, 64, 100, 160, 200, 227):
        out.append(Limit(f"dynamic smem {kb} KB", 256, kb * 1024, 1, True))
    out.append(Limit(f"dynamic smem {MAX_DYNAMIC_SMEM + 1024} B", 256,
                     MAX_DYNAMIC_SMEM + 1024, 1, False))
    for c in (1, 2, 4, 8, 16, 32):
        tag = ("portable" if c <= MAX_PORTABLE_CLUSTER else
               "non-portable" if c <= MAX_CLUSTER else "past the limit")
        out.append(Limit(f"cluster {c} ({tag})", 128, 128 * 4, c,
                         c <= MAX_CLUSTER))
    return out


def _probe_x(shape, seed: int = 0) -> np.ndarray:
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def block_origins(case: Case) -> np.ndarray:
    """(grid points, 3) int64: each block's first element, index map times
    block shape as a BlockSpec places it, padded to three dims."""
    pts = list(np.ndindex(*case.grid)) if case.grid else [()]
    rows = []
    for pt in pts:
        idx = case.index_map(*pt)
        org = [int(i) * b for i, b in zip(idx, case.block_shape)]
        rows.append([0] * (3 - len(org)) + org)
    return np.asarray(rows, dtype=np.int64)


def _pad3(shape) -> Tuple[int, int, int]:
    return tuple([1] * (3 - len(shape)) + list(shape))


def plain_tiles(case: Case, x: torch.Tensor) -> torch.Tensor:
    """Plain version of one tiling case: ``x * 2`` over every element some
    block covers, NaN elsewhere (the reference's output there is
    unwritten)."""
    out = torch.full_like(x, float("nan"))
    s = _pad3(case.arr_shape)
    b = _pad3(case.block_shape)
    xv, ov = x.reshape(s), out.reshape(s)
    for o in block_origins(case):
        sl = tuple(slice(int(a), min(int(a) + n, lim))
                   for a, n, lim in zip(o, b, s))
        ov[sl] = xv[sl] * 2.0
    return out


def _lib():
    P, I, L = _build.P, _build.I, _build.L
    _build.library("launch_probe", "apex_probe_tiles",
                   (P, P, P) + (I,) * 7 + (P,), "apex_probe_error_string")
    _build.library("launch_probe", "apex_probe_launch",
                   (P, P, L, I, I, I, P), "apex_probe_error_string")
    return _build.library("launch_probe", "apex_probe_gather",
                          (P,) * 4 + (I,) * 4 + (P,),
                          "apex_probe_error_string")


def _err(lib, err: int) -> str:
    return lib.apex_probe_error_string(err).decode()


def run_tiles(case: Case, x: torch.Tensor,
              origins: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, int]:
    """The kernel over one tiling case: ``(out, error)``, out NaN where no
    block wrote; error 0 when the launch was taken. ``origins`` are
    :func:`block_origins` already on x's device (made here when None)."""
    dev = x.device
    lib = _lib()
    out = torch.full_like(x, float("nan"))
    org = (torch.from_numpy(block_origins(case)).to(dev) if origins is None
           else origins)
    with torch.cuda.device(dev):
        err = lib.apex_probe_tiles(
            x.data_ptr(), out.data_ptr(), org.data_ptr(), org.shape[0],
            *_pad3(case.arr_shape), *_pad3(case.block_shape),
            torch.cuda.current_stream(dev).cuda_stream)
    if not err:
        _build.count_launch(TILES_KERNEL)
    return out, err


def run_limit(lim: Limit, x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """The kernel at one launch shape: ``(out, error)``."""
    dev = x.device
    lib = _lib()
    out = torch.full_like(x, float("nan"))
    with torch.cuda.device(dev):
        err = lib.apex_probe_launch(
            x.data_ptr(), out.data_ptr(), x.numel(), lim.threads, lim.smem,
            lim.cluster, torch.cuda.current_stream(dev).cuda_stream)
    if not err:
        _build.count_launch(LIMITS_KERNEL)
    return out, err


GATHER_SIZES = dict(tile_rows=512, lanes=128, sub=32, n_tiles=2)


def gather_inputs(device=None):
    """The reference's inputs (:86-90): ids ``arange(64) % 5``, values 1
    to 5, x all ones, 2 tiles of 512 x 128 rows in 32 subtiles."""
    s = GATHER_SIZES
    ids = torch.arange(s["n_tiles"] * s["sub"], dtype=torch.int32) % 5
    vals = torch.arange(5, dtype=torch.float32) + 1.0
    x = torch.ones(s["n_tiles"] * s["tile_rows"], s["lanes"])
    return tuple(t.to(device) for t in (ids, vals, x))


def plain_gather(ids, vals, x, tile_rows: int, sub: int) -> torch.Tensor:
    """Plain version of the subtile gather: each subtile's leaf scalar
    broadcast over its rows, times x (the reference's kernel :92-99)."""
    per_row = vals[ids.long()].repeat_interleave(tile_rows // sub)
    return x * per_row[:, None]


def run_gather(ids, vals, x, tile_rows: int, sub: int
               ) -> Tuple[torch.Tensor, int]:
    dev = x.device
    lib = _lib()
    out = torch.full_like(x, float("nan"))
    n_tiles = x.shape[0] // tile_rows
    with torch.cuda.device(dev):
        err = lib.apex_probe_gather(
            ids.data_ptr(), vals.data_ptr(), x.data_ptr(), out.data_ptr(),
            n_tiles, tile_rows, x.shape[1], sub,
            torch.cuda.current_stream(dev).cuda_stream)
    if not err:
        _build.count_launch(GATHER_KERNEL)
    return out, err


def _verdict(out, want, err, lib) -> Tuple[str, str]:
    if err:
        return "FAIL", _err(lib, err)
    torch.cuda.synchronize()
    ok = torch.equal(torch.nan_to_num(out, nan=-1.0),
                     torch.nan_to_num(want, nan=-1.0))
    return ("PASS" if ok else "WRONG"), ""


def probe_all(device=None, echo: Optional[Callable[[str], None]] = print
              ) -> List[dict]:
    """Every case on the card: a list of ``{"case", "kind", "result",
    "expected", "reason"}`` (``expected`` PASS or FAIL; the tiling and
    gather cases are all expected to PASS)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the launch probe needs a CUDA device")
    lib = _lib()
    results = []

    def note(kind, name, verdict, expected):
        res, why = verdict
        results.append({"case": name, "kind": kind, "result": res,
                        "expected": expected, "reason": why})
        if echo is not None:
            echo(f"  [{res}] {kind}: {name}" + (f": {why}" if why else ""))

    for case in CASES:
        x = torch.from_numpy(_probe_x(case.arr_shape)).to(dev)
        out, err = run_tiles(case, x)
        note("tiles", case.name, _verdict(out, plain_tiles(case, x), err,
                                          lib), "PASS")
    n = 1 << 16
    x = torch.from_numpy(_probe_x((n,))).to(dev)
    for lim in limit_cases():
        out, err = run_limit(lim, x)
        note("limits", lim.name, _verdict(out, x * 2.0, err, lib),
             "PASS" if lim.valid else "FAIL")
    s = GATHER_SIZES
    ids, vals, xg = gather_inputs(dev)
    out, err = run_gather(ids, vals, xg, s["tile_rows"], s["sub"])
    note("gather", f"subtile gather ({s['sub']} subtiles of "
         f"{s['tile_rows']} x {s['lanes']} tiles, {s['n_tiles']} tiles)",
         _verdict(out, plain_gather(ids, vals, xg, s["tile_rows"],
                                    s["sub"]), err, lib), "PASS")
    return results


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("the launch probe needs a CUDA device")
    print(f"device: {torch.cuda.get_device_name(0)}")
    results = probe_all()
    off = [r for r in results if r["result"] != r["expected"]]
    print(f"{len(results) - len(off)} of {len(results)} cases as expected")
    return 1 if off else 0


if __name__ == "__main__":
    raise SystemExit(main())
