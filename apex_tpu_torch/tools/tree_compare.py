"""The LayerNorm forward and backward and the fp32 flash forward of two
checkouts of the port, side by side on the card.

``save`` runs fixed seeded cases through the wrappers
(``ops.layer_norm._fwd_cuda`` and ``_bwd_cuda``; ``ops.attention._flash_cuda``,
which in fp32 includes the split of q, k and v where the checkout's design
has one) of the checkout at ``--root``, each checkout in its own process so
that each loads its own build, and saves every output's SHA-256 with the
call's device time. The backward's cases hash dx alone and keep dw and db
as values (2 x h floats), since their summing order is the design's.
``compare`` then says, case by case, whether two saves are bitwise equal
(dx, for the backward), prints dw's and db's largest difference relative to
their largest |value|, and both times:

    python apex_tpu_torch/tools/tree_compare.py save --root OLD old.json
    python apex_tpu_torch/tools/tree_compare.py save --root . new.json
    python apex_tpu_torch/tools/tree_compare.py compare old.json new.json

``--only layer_norm`` (or ``flash``) saves those cases alone. Run the saves
in turns (old, new, new, old) to see the spread of the times. Device time:
``--iters`` calls captured in one CUDA graph, replayed five times between
CUDA events. That replay keeps the inputs in the card's 50 MB L2 where they
fit, so the LayerNorm cases also give a cold time (``cold_ms``: the calls
of the graph rotate over enough copies of the inputs that x alone passes
200 MB; none under 1 MB of x) and the time of the one PyTorch call that
computes the same function (``lib_ms``: ``F.layer_norm``,
``native_layer_norm_backward``, on weights in x's dtype; none for RMSNorm).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys

# LayerNorm (rows, h, dtype, affine, rms): the serving and training rows of
# GPT-2 345M, fp16 and fp32, rows of single elements (h 1000), no affine,
# RMS, and fewer rows than a block has warps
LN_CASES = (
    (4096, 1024, "bfloat16", True, False),
    (8192, 1024, "bfloat16", True, False),
    (8192, 1024, "float16", True, False),
    (8192, 1024, "float32", True, False),
    (8199, 1000, "bfloat16", True, False),
    (8192, 1024, "bfloat16", False, False),
    (8192, 1024, "bfloat16", True, True),
    (5, 1024, "bfloat16", True, False),
)
# the fp32 flash forward (name, b, h, sq, sk, d, causal, dropout, key
# padding): GPT-2 345M's training shape, with dropout 0.1, the multi-head
# attention stacks' 64 tokens with a key-padding bias, decode, head width 128
FLASH_CASES = (
    ("train", 8, 16, 1024, 1024, 64, True, False, False),
    ("train_dropout", 8, 16, 1024, 1024, 64, True, True, False),
    ("mha_bias", 120, 16, 64, 64, 64, False, False, True),
    ("decode", 8, 16, 1, 1025, 64, False, False, False),
    ("d128", 4, 16, 1024, 1024, 128, True, False, False),
)


# the cold time's inputs: copies of x enough to pass this many bytes, four L2s
COLD_BYTES = 200e6


def _device_ms(torch, fns, iters: int) -> float:
    """Device ms a call: ``iters`` calls (rounded up to a whole number of
    turns over ``fns``, one function or a list that the calls rotate
    over) captured in one CUDA graph, replayed five times."""
    fns = fns if isinstance(fns, list) else [fns]
    iters = -(-iters // len(fns)) * len(fns)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fns[i % len(fns)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * 5)


def _digest(torch, ts) -> str:
    """The SHA-256 of the tensors' bytes, in order."""
    ints = {2: torch.int16, 4: torch.int32}
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().cpu().view(-1).view(
            ints[t.element_size()]).numpy().tobytes())
    return h.hexdigest()


def _ln_inputs(torch, layer_norm, case):
    """x, g, w, b, mean, rstd of a LayerNorm case (mean and rstd from the
    plain forward, so that both checkouts' backwards read the same)."""
    rows, h, dt, affine, rms = case
    gen = torch.Generator().manual_seed(rows * 7 + h)
    x = (torch.randn(rows, h, generator=gen) * 2 + 0.5).to(
        "cuda", getattr(torch, dt))
    w = (1 + 0.1 * torch.randn(h, generator=gen)).cuda() if affine \
        else None
    b = (0.1 * torch.randn(h, generator=gen)).cuda() \
        if affine and not rms else None
    g = torch.randn(rows, h, generator=gen).to("cuda", x.dtype)
    _, mean, rstd = layer_norm._fwd_torch(x, w, b, 1e-5, rms)
    return x, g, w, b, mean, rstd


def _ln_cases(torch, layer_norm, iters):
    """(key, call, {ms, cold_ms, lib_ms}) of the forward and the backward
    of each case."""
    F = torch.nn.functional
    for case in LN_CASES:
        rows, h, dt, affine, rms = case
        x, g, w, b, mean, rstd = _ln_inputs(torch, layer_norm, case)
        x_bytes = x.numel() * x.element_size()
        copies = max(2, -(-int(COLD_BYTES) // x_bytes))
        sets = [tuple(t.clone() for t in (x, g, mean, rstd))
                for _ in range(copies)] if x_bytes >= 1 << 20 else []
        wl = None if w is None else w.to(x.dtype)
        bl = None if b is None else b.to(x.dtype)
        tag = f"rows={rows} h={h} {dt} affine={affine} rms={rms}"

        def fwd(x_=x):
            return layer_norm._fwd_cuda(x_, w, b, 1e-5, rms)

        def bwd(x_=x, g_=g, m_=mean, r_=rstd):
            return layer_norm._bwd_cuda(x_, w, m_, r_, g_, rms)
        lib_fwd = lib_bwd = None
        if not rms:
            lmean, lrstd = torch.native_layer_norm(x, (h,), wl, bl, 1e-5)[1:]
            mask = [True, affine, affine]
            lib_fwd = lambda: F.layer_norm(x, (h,), wl, bl, 1e-5)  # noqa
            lib_bwd = lambda: torch.ops.aten.native_layer_norm_backward(  # noqa
                g, x, (h,), lmean, lrstd, wl, bl, mask)
        for key, fn, cold, lib in (
                (f"layer_norm {tag}", fwd,
                 [lambda s=s: fwd(s[0]) for s in sets], lib_fwd),
                (f"layer_norm_bwd {tag}", bwd,
                 [lambda s=s: bwd(*s) for s in sets], lib_bwd)):
            yield key, fn, {
                "ms": _device_ms(torch, fn, iters),
                "cold_ms": _device_ms(torch, cold, iters) if cold else None,
                "lib_ms": _device_ms(torch, lib, iters) if lib else None}
        del sets
        torch.cuda.empty_cache()


def _flash_cases(torch, attention, iters):
    for name, b, h, sq, sk, d, causal, drop, pad in FLASH_CASES:
        gen = torch.Generator().manual_seed(sq * 31 + sk + d)
        q, k, v = (torch.randn(b, h, n, d, generator=gen).cuda()
                   for n in (sq, sk, sk))
        bias = None
        if pad:
            bias = torch.where(torch.rand(b, 1, 1, sk, generator=gen) < 0.25,
                               -10000.0, 0.0).cuda()
        rate, seed = (0.1, 1234) if drop else (0.0, None)
        fn = lambda: attention._flash_cuda(  # noqa: E731
            q, k, v, None, None, d ** -0.5, causal, None, rate, seed,
            bias=bias)
        key = (f"flash fp32 {name} b={b} h={h} sq={sq} sk={sk} d={d}"
               + (" dropout 0.1" if drop else "")
               + (" key-padding bias" if pad else ""))
        yield key, fn, {"ms": _device_ms(torch, fn, max(iters // 5, 2))}


def _fmt(v) -> str:
    return "-" if v is None else f"{v:.5f}"


def save(root: str, path: str, iters: int, only=None) -> None:
    sys.path.insert(0, root)
    import torch
    from apex_tpu_torch import _build
    from apex_tpu_torch.ops import attention, layer_norm

    if not torch.cuda.is_available():
        raise SystemExit("tree_compare: no CUDA device")
    # these libraries alone (a checkout with the split pass has its own)
    names = [] if only == "flash" else ["layer_norm"]
    if only != "layer_norm":
        names.append("flash_fwd_fp32")
        if "flash_split3" in _build.SOURCES:
            names.append("flash_split3")
    _build.build_all(names)
    out = {"card": torch.cuda.get_device_name(0), "cases": {}}
    groups = []
    if only != "flash":
        groups.append(_ln_cases(torch, layer_norm, iters))
    if only != "layer_norm":
        groups.append(_flash_cases(torch, attention, iters))
    for cases in groups:
        for key, fn, times in cases:
            got = fn()
            rec = dict(times)
            if key.startswith("layer_norm_bwd"):
                dx, dw, db = got
                rec.update(sha256=_digest(torch, [dx]),
                           dw=dw.float().cpu().tolist(),
                           db=db.float().cpu().tolist())
            else:
                rec["sha256"] = _digest(torch, got)
            out["cases"][key] = rec
            print(f"{key}: " + " ".join(f"{k} {_fmt(v)}"
                                        for k, v in times.items()))
            del got
            torch.cuda.empty_cache()
    with open(path, "w") as f:
        json.dump(out, f, indent=1)


def _rel(a, b) -> float:
    """The largest |a - b| relative to the largest |b|."""
    top = max(abs(v) for v in b) or 1.0
    return max(abs(x - y) for x, y in zip(a, b)) / top


def compare(a_path: str, b_path: str) -> int:
    with open(a_path) as f:
        a = json.load(f)["cases"]
    with open(b_path) as f:
        b = json.load(f)["cases"]
    for key, first in a.items():
        second = b[key]
        what = "dx bitwise" if "dw" in first else "bitwise"
        line = f"{key}: {what} {first['sha256'] == second['sha256']}"
        if "dw" in first:
            line += (f"; dw rel {_rel(second['dw'], first['dw']):.3e}, "
                     f"db rel {_rel(second['db'], first['db']):.3e}")
        for t in ("ms", "cold_ms"):
            if first.get(t) is not None:
                line += (f"; {t} {first[t]:.5f} (first) "
                         f"{_fmt(second.get(t))} (second)")
        if first.get("lib_ms") is not None:
            line += f"; lib_ms {first['lib_ms']:.5f}"
        print(line)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("save")
    s.add_argument("--root", required=True,
                   help="the checkout whose apex_tpu_torch runs")
    s.add_argument("--iters", type=int, default=50)
    s.add_argument("--only", choices=("layer_norm", "flash"))
    s.add_argument("path")
    c = sub.add_parser("compare")
    c.add_argument("first")
    c.add_argument("second")
    args = ap.parse_args(argv)
    if args.cmd == "save":
        save(args.root, args.path, args.iters, args.only)
        return 0
    return compare(args.first, args.second)


if __name__ == "__main__":
    sys.exit(main())
