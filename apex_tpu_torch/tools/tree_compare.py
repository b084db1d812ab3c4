"""The LayerNorm forward and the fp32 flash forward of two checkouts of the
port, side by side on the card.

``save`` runs fixed seeded cases through the public wrappers
(``ops.layer_norm._fwd_cuda``; ``ops.attention._flash_cuda``, which in fp32
includes the split of q, k and v where the checkout's design has one) of
the checkout at ``--root``, each checkout in its own process so that each
loads its own build, and saves every output's SHA-256 with the call's device
time; ``compare`` then says, case by case, whether two saves are bitwise
equal and prints both times:

    python apex_tpu_torch/tools/tree_compare.py save --root OLD old.json
    python apex_tpu_torch/tools/tree_compare.py save --root . new.json
    python apex_tpu_torch/tools/tree_compare.py compare old.json new.json

Run the saves in turns (old, new, new, old) to see the spread of the
times. Device time: ``--iters`` calls captured in one CUDA graph, replayed
five times between CUDA events (the inputs stay in the card's L2 where they
fit).
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


def _device_ms(torch, fn, iters: int) -> float:
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


def _ln_cases(torch, layer_norm, iters):
    for rows, h, dt, affine, rms in LN_CASES:
        gen = torch.Generator().manual_seed(rows * 7 + h)
        x = (torch.randn(rows, h, generator=gen) * 2 + 0.5).to(
            "cuda", getattr(torch, dt))
        w = (1 + 0.1 * torch.randn(h, generator=gen)).cuda() if affine \
            else None
        b = (0.1 * torch.randn(h, generator=gen)).cuda() \
            if affine and not rms else None
        fn = lambda: layer_norm._fwd_cuda(x, w, b, 1e-5, rms)  # noqa: E731
        key = f"layer_norm rows={rows} h={h} {dt} affine={affine} rms={rms}"
        yield key, fn, _device_ms(torch, fn, iters)


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
        yield key, fn, _device_ms(torch, fn, max(iters // 5, 2))


def save(root: str, path: str, iters: int) -> None:
    sys.path.insert(0, root)
    import torch
    from apex_tpu_torch import _build
    from apex_tpu_torch.ops import attention, layer_norm

    if not torch.cuda.is_available():
        raise SystemExit("tree_compare: no CUDA device")
    # these libraries alone (a checkout with the split pass has its own)
    names = ["layer_norm", "flash_fwd_fp32"]
    if "flash_split3" in _build.SOURCES:
        names.append("flash_split3")
    _build.build_all(names)
    out = {"card": torch.cuda.get_device_name(0), "cases": {}}
    for cases in (_ln_cases(torch, layer_norm, iters),
                  _flash_cases(torch, attention, iters)):
        for key, fn, ms in cases:
            got = fn()
            out["cases"][key] = {"sha256": _digest(torch, got), "ms": ms}
            print(f"{key}: {ms:.5f} ms")
            del got
            torch.cuda.empty_cache()
    with open(path, "w") as f:
        json.dump(out, f, indent=1)


def compare(a_path: str, b_path: str) -> int:
    with open(a_path) as f:
        a = json.load(f)["cases"]
    with open(b_path) as f:
        b = json.load(f)["cases"]
    for key, first in a.items():
        second = b[key]
        print(f"{key}: bitwise {first['sha256'] == second['sha256']}; ms "
              f"{first['ms']:.5f} (first) {second['ms']:.5f} (second)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("save")
    s.add_argument("--root", required=True,
                   help="the checkout whose apex_tpu_torch runs")
    s.add_argument("--iters", type=int, default=50)
    s.add_argument("path")
    c = sub.add_parser("compare")
    c.add_argument("first")
    c.add_argument("second")
    args = ap.parse_args(argv)
    if args.cmd == "save":
        save(args.root, args.path, args.iters)
        return 0
    return compare(args.first, args.second)


if __name__ == "__main__":
    sys.exit(main())
