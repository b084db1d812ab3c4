"""The optimizer engine's bandwidth ladder on the card: where do the GB/s
go?

Counterpart of ``tools/tpu_kprobe.py``. Each rung adds one factor to the
one before it, over ``--n`` fp32 elements (64,000,000 by default, the
reference's ``--n``), so the fused engine's distance from the byte rate
attributes to a mechanism:

  copy1              one stream in, one out, ``p * 1.0000001``
  multi7             four streams in, three out, no arithmetic
  adam_math          plus the reference's ``adam_body`` arithmetic
  adam_found         plus the ``found_inf`` flag over every block
  adam_alias         the update written in place into p, m and v
  engine_fused_adam  ``csrc/fused_adam.cu`` as it ships (FusedAdam's
                     update: ``fused_adam_update``)
  plain_fused        ``adam_body`` as plain PyTorch ops on the card

The first five are ``csrc/kprobe.cu``; each is bitwise its plain version
here (:func:`plain_rung`), which the CPU tests hold to numpy's fp32
evaluation of the reference's formulas. One JSON record a rung, in the
reference's shape: ``{"what": ..., "ms": ..., "gb_per_sec": ...}``, the
kernel's device time by CUDA-graph replay and the bytes it must move (8
an element for copy1, 28 for the rest) over that time::

    python -m apex_tpu_torch.tools.kprobe            # n = 64,000,000
    python -m apex_tpu_torch.tools.kprobe --n 16777216

Needs a CUDA device (raises without one).
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch import _build
from apex_tpu_torch._backend import check_kernel_input
from apex_tpu_torch.multi_tensor.engine import sqrt_rn

KERNEL_RUNGS = ("copy1", "multi7", "adam_math", "adam_found", "adam_alias")
# the kernel's rung code of each (adam_alias is adam_math in place)
_CODES = {"copy1": 0, "multi7": 1, "adam_math": 2, "adam_found": 3,
          "adam_alias": 2}
# fp32 streams each rung moves, in and out
STREAMS = {"copy1": 2, "multi7": 7, "adam_math": 7, "adam_found": 7,
           "adam_alias": 7, "engine_fused_adam": 7, "plain_fused": 7}
DEFAULT_N = 64_000_000


def kernel_name(rung: str) -> str:
    """The launch counter of a kernel rung."""
    return f"kprobe_{rung}"


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


_CONSTS: Dict[Tuple[float, torch.device], torch.Tensor] = {}


def _const(x: float, device) -> torch.Tensor:
    """The fp32 constant ``x`` as a 0-d tensor on ``device``, made once
    (a timed call captured in a CUDA graph must not copy from the host)."""
    key = (x, torch.device(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = _f32(x).to(device)
    return t


def adam_body(p, m, v, g):
    """``adam_body`` of ``tools/tpu_kprobe.py`` (:121-126) in fp32, one
    rounded operation at a time in the formula's order: ``m2 = 0.9 m +
    0.1 g``, ``v2 = 0.999 v + (0.001 g) g``, ``up = m2 / (sqrt(v2) +
    1e-8) + 0.01 p``, ``p2 = p - 1e-3 up`` (constants rounded to fp32;
    the square root correctly rounded, as ``__fsqrt_rn``)."""
    c = {k: _const(k, p.device) for k in (0.9, 0.1, 0.999, 0.001, 1e-8,
                                          0.01, 1e-3)}
    m2 = c[0.9] * m + c[0.1] * g
    v2 = c[0.999] * v + (c[0.001] * g) * g
    up = m2 / (sqrt_rn(v2) + c[1e-8]) + c[0.01] * p
    return p - c[1e-3] * up, m2, v2


def plain_rung(rung: str, p, m, v, g):
    """Plain version of a kernel rung: ``(outputs, found)``, found a 0-d
    fp32 tensor for adam_found, else None."""
    k = _const(1.0000001, p.device)
    if rung == "copy1":
        return (p * k,), None
    if rung == "multi7":
        return (p * k, m * k, v + g), None
    outs = adam_body(p, m, v, g)
    if rung == "adam_found":
        return outs, (~torch.isfinite(g)).any().to(torch.float32)
    return outs, None


def run_rung(rung: str, p, m, v, g, found: Optional[torch.Tensor] = None
             ) -> Tuple[Tuple[torch.Tensor, ...], Optional[torch.Tensor]]:
    """The kernel of a rung on CUDA tensors: ``(outputs, found)`` like
    :func:`plain_rung`. adam_alias writes p, m and v in place and returns
    them; adam_found writes its flag into ``found`` (a zeroed 0-d fp32
    tensor on the card, allocated when None)."""
    dev = p.device
    names = ("p",) if rung == "copy1" else ("p", "m", "v", "g")
    for name, t in zip(names, (p, m, v, g)):
        check_kernel_input(name, t, (torch.float32,), dev)
    n = p.numel()
    if rung == "copy1":
        outs = (torch.empty_like(p),)
        args = (p, None, None, None, outs[0], None, None)
    elif rung == "adam_alias":
        outs = (p, m, v)
        args = (p, m, v, g, p, m, v)
    else:
        outs = tuple(torch.empty_like(p) for _ in range(3))
        args = (p, m, v, g, *outs)
    if rung == "adam_found" and found is None:
        found = torch.zeros((), dtype=torch.float32, device=dev)
    P = _build.P
    lib = _build.library("kprobe", "apex_kprobe",
                         (_build.I,) + (P,) * 8 + (_build.L, P),
                         "apex_kprobe_error_string")
    ptrs = [None if t is None else t.data_ptr() for t in args]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.apex_kprobe(
            _CODES[rung], *ptrs,
            found.data_ptr() if rung == "adam_found" else None, n, stream)
    if err:
        raise RuntimeError(f"{kernel_name(rung)}: CUDA error {err} at launch: "
                           f"{lib.apex_kprobe_error_string(err).decode()}")
    _build.count_launch(kernel_name(rung))
    return outs, (found if rung == "adam_found" else None)


def inputs(n: int, device, seed: int = 0):
    """The reference's buffers: p ~ N(0, 1), g ~ 1e-3 N(0, 1), m = v = 0
    (``tools/tpu_kprobe.py`` :68-71), made on the card from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    p = torch.randn(n, generator=gen, device=device)
    g = torch.randn(n, generator=gen, device=device) * _f32(1e-3).to(device)
    return p, torch.zeros_like(p), torch.zeros_like(p), g


def graph_ms(fn, iters: int = 10, replays: int = 3) -> float:
    """Mean device ms per call of ``fn``: ``iters`` calls captured in a
    CUDA graph, replayed ``replays`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def ladder(n: int = DEFAULT_N, device=None, seed: int = 0,
           timer=graph_ms) -> Dict[str, dict]:
    """Every rung at ``n``: each kernel rung held bitwise against its plain
    version (adam_found also on an injected inf, whose flag must be
    exactly 1, and on finite g, exactly 0), then timed. Returns one record
    a rung: ``what``, ``ms``, ``gb_per_sec``, and for the kernel rungs
    ``bitwise`` and, for adam_found, ``found_clean`` / ``found_inf``."""
    from apex_tpu_torch.multi_tensor import fused_adam_update

    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the kprobe ladder needs a CUDA device")
    p, m, v, g = inputs(n, dev, seed)
    m.normal_(generator=torch.Generator(device=dev).manual_seed(seed + 1))
    v.uniform_(generator=torch.Generator(device=dev).manual_seed(seed + 2))
    gbytes = n * 4 / 1e9
    records = {}
    for rung in KERNEL_RUNGS:
        if rung == "adam_alias":
            ins = [t.clone() for t in (p, m, v)]
            outs, _ = run_rung(rung, *ins, g)
        else:
            outs, found = run_rung(rung, p, m, v, g)
        want, _ = plain_rung(rung, p, m, v, g)
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(outs, want))
        rec = {"what": rung, "bitwise": same}
        if rung == "adam_found":
            rec["found_clean"] = float(found)
            bad = g.clone()
            bad[n // 2] = float("inf")
            _, found_inf = run_rung(rung, p, m, v, bad)
            rec["found_inf"] = float(found_inf)
        if rung == "adam_alias":
            bufs = [t.clone() for t in (p, m, v)]
            fn = lambda: run_rung(rung, *bufs, g)  # noqa: E731
        elif rung == "adam_found":
            flag = torch.zeros((), dtype=torch.float32, device=dev)
            fn = lambda: run_rung(rung, p, m, v, g, flag)  # noqa: E731
        else:
            fn = lambda r=rung: run_rung(r, p, m, v, g)  # noqa: E731
        rec["ms"] = timer(fn)
        records[rung] = rec
    state = [t.clone() for t in (p, m, v)]
    records["engine_fused_adam"] = {"what": "engine_fused_adam", "ms": timer(
        lambda: fused_adam_update(*state, g, lr=1e-3, step=2,
                                  weight_decay=0.01))}
    records["plain_fused"] = {"what": "plain_fused", "ms": timer(
        lambda: adam_body(p, m, v, g))}
    for name, rec in records.items():
        rec["gb_per_sec"] = STREAMS[name] * gbytes / (rec["ms"] / 1e3)
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=DEFAULT_N)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the kprobe ladder needs a CUDA device")
    print(json.dumps({"what": "config", "n": args.n,
                      "device": torch.cuda.get_device_name(0),
                      "fp32_gb": args.n * 4 / 1e9}), flush=True)
    for rec in ladder(args.n, seed=args.seed).values():
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
