"""The LayerNorm forward and backward, the fp32 flash forward, the one-pass
LAMB segment kernel, the per-leaf sum and the softmax forwards of two
checkouts of the port, side by side on the card.

``save`` runs fixed seeded cases through the wrappers
(``ops.layer_norm._fwd_cuda`` and ``_bwd_cuda``; ``ops.attention._flash_cuda``,
which in fp32 includes the split of q, k and v where the checkout's design
has one; ``multi_tensor.segmented._small_segment_pass``;
``multi_tensor.engine.leaf_sums``) of the checkout at ``--root``, each
checkout in its own process so that each loads its own build, and saves
every output's SHA-256 with the call's device time. The backward's cases
hash dx alone and keep dw and db as values (2 x h floats), since their
summing order is the design's. The segment cases (GPT-2 345M's and
BERT-Large's FusedLAMB layouts: the stash on and off, with_grad_norm, u fp32
and bf16, an fp32 master and a bf16 master with stochastic rounding) hash m'
and v', p' and the per-slot g^2 sums apart, and check each against the
checkout's own plain version there and then (m', v' bitwise, p' within
1e-5 of each parameter's step plus one rounding, the sums within 1e-5; p'
and the sums bitwise or not); their trust ratios come from sums whose order
is the design's. ``compare`` then says, case by case, whether two saves are
bitwise equal (dx, for the backward; m' and v', then p' and the sums apart,
for the segment pass), prints dw's and db's largest difference relative to
their largest |value|, each save's own check, and both times:

    python apex_tpu_torch/tools/tree_compare.py save --root OLD old.json
    python apex_tpu_torch/tools/tree_compare.py save --root . new.json
    python apex_tpu_torch/tools/tree_compare.py compare old.json new.json

The softmax cases (``SOFTMAX_CASES``: T5-base's decoder and cross
attention, GPT-2 345M's causal scores, BERT-Large's masked and unmasked
ones, one 8-column row for the launch floor; bf16 and fp16) call
``ops.softmax._fwd_cuda`` with the mask as ``scaled_masked_softmax`` passes
it (through ``_masked_args``), and save the output's hash, its own check
against the checkout's plain version (the largest excess over one ulp), a
repeated call's bitwise equality, the device allocations a call makes (1:
the output alone, no copy of the mask), replay and cold ms, the library
call's ms (``torch._masked_softmax``, ``torch.softmax``), the bound and,
where the checkout has ``softmax.fwd_route``, the kernel's route
(lanes a row, blocks, registers, spills).

``--only layer_norm`` (or ``flash``, ``lamb_segment``, ``leaf_sum``,
``softmax``, or a comma-separated list of them) saves those cases alone. Run the saves in
turns (old, new, new, old) to see the spread of the times. Device time:
``--iters`` calls captured in one CUDA graph, replayed five times between
CUDA events. That replay keeps the inputs in the card's 50 MB L2 where they
fit, so the LayerNorm cases also give a cold time (``cold_ms``: the calls
of the graph rotate over enough copies of the inputs that x alone passes
200 MB; none under 1 MB of x) and the time of the one PyTorch call that
computes the same function (``lib_ms``: ``F.layer_norm``,
``native_layer_norm_backward``, on weights in x's dtype; none for RMSNorm;
``index_add_`` for the per-leaf sum, by atomics). The segment cases also
save the call's host time (CUDA events around back-to-back calls:
``host_ms``), where the checkout reports it the kernel's route, and the
library's ``-Xptxas -v`` log (registers and spills) once a save.
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

# the softmax forwards (name, mode, x shape, mask): T5-base's decoder (16 x
# 12 heads, 128 queries, causal) and its cross attention (128 queries over
# 512 encoder keys, the (b, 1, 1, 512) key mask as the model passes it, and
# the same mask made dense, as the kernel alone read it before strides),
# GPT-2 345M's causal scores (8 x 16, 1024, 1024), BERT-Large's (8, 16, 512,
# 512) under its padded outer-product mask (mask batch 8, and one
# sequence's broadcast from batch 1) and unmasked, and one 8-column row:
# the launch of the kernel alone, its floor. Each in bf16 and fp16.
SOFTMAX_CASES = (
    ("t5_decoder", "causal", (192, 128, 128), None),
    ("gpt", "causal", (128, 1024, 1024), None),
    ("t5_cross", "masked", (16, 12, 128, 512), "t5_keys"),
    ("t5_cross_dense_mask", "masked", (16, 12, 128, 512), "t5_dense"),
    ("bert", "masked", (8, 16, 512, 512), "bert"),
    ("bert_mask_batch_1", "masked", (8, 16, 512, 512), "bert_1"),
    ("bert_scaled", "scaled", (8, 16, 512, 512), None),
    ("floor", "scaled", (1, 8), None),
)
SOFTMAX_DTYPES = ("bfloat16", "float16")
# real lengths of BERT-Large's eight sequences of 512 (chip_smoke.BERT_LENS)
# and of T5's sixteen encoder sequences of 512
BERT_LENS = (512, 448, 384, 320, 512, 256, 480, 200)
T5_LENS = (512, 301, 451, 128, 389, 512, 260, 477, 333, 498, 175, 512, 402,
           287, 466, 350)


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


def _keep(torch, lens, s=512):
    return (torch.arange(s)[None, :] < torch.tensor(lens)[:, None]).cuda()


def _softmax_mask(torch, kind, sq):
    """The bool mask (True masking out) of a masked case, as its model
    builds it, and the bytes the kernel must read of it (the unrepeated
    mask)."""
    if kind in ("t5_keys", "t5_dense"):
        m = ~_keep(torch, T5_LENS)[:, None, None, :]       # (b, 1, 1, sk)
        need = m.numel()
        if kind == "t5_dense":
            m = m.expand(-1, 1, sq, -1).contiguous()
        return m, need
    keep = _keep(torch, BERT_LENS)                          # (8, 512)
    m = ~(keep[:, None, :, None] & keep[:, None, None, :])  # (b, 1, s, s)
    if kind == "bert_1":
        m = m[7:8]
    return m, m.numel()


def _softmax_check(torch, y, want, dtype) -> float:
    """The largest |y - y_plain| beyond one ulp of the larger |value| (bf16
    2^-7, fp16 2^-10 with 2^-24 below fp16's normals); <= 0 passes."""
    tol, floor = {"bfloat16": (2.0 ** -7, 0.0),
                  "float16": (2.0 ** -10, 2.0 ** -24)}[dtype]
    a, b = y.float(), want.float()
    return float(((a - b).abs() - tol * torch.maximum(a.abs(), b.abs())
                  ).max()) - floor


def _allocations(torch, fn) -> int:
    """Device allocations one call of ``fn`` makes: 1 where the output is
    all it allocates (no copy of an input on the way)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_stats()["allocation.all.allocated"]
    out = fn()
    n = torch.cuda.memory_stats()["allocation.all.allocated"] - before
    del out
    return n


def _softmax_cases(torch, iters):
    """(key, record) of each softmax forward case: the output's hash, its
    own check against the checkout's plain version, a repeated call's
    bitwise equality, device ms by replay and cold (inputs rotated past
    200 MB), the library call's ms, the bound, allocations a call and,
    where the checkout reports it, the kernel's route."""
    from apex_tpu_torch.ops import softmax
    for (name, mode, shape, mkind), dt in (
            (c, d) for c in SOFTMAX_CASES for d in SOFTMAX_DTYPES):
        dtype = getattr(torch, dt)
        gen = torch.Generator().manual_seed(sum(shape) + len(name))
        x = (3 * torch.randn(*shape, generator=gen)).to("cuda", dtype)
        mask, mask_bytes = (None, 0) if mkind is None else _softmax_mask(
            torch, mkind, shape[-2])

        def run(x_=x, m_=mask):
            m = None if m_ is None else softmax._masked_args(x_, m_)
            return softmax._fwd_cuda(x_, m, 1.0, mode)
        y, again = run(), run()
        m_full = None if mask is None else softmax._masked_args(x, mask)
        want = softmax._fwd_torch(x, m_full, 1.0, mode)
        esize = x.element_size()
        if mode == "causal":
            a, sq, sk = shape
            live = a * sum(min(q + 1, sk) for q in range(sq))
            need = esize * (live + x.numel())
        else:
            need = 2 * esize * x.numel() + mask_bytes
        rec = {"sha256": _digest(torch, [y]),
               "plain_ulp_excess": _softmax_check(torch, y, want, dt),
               "repeat_bitwise": torch.equal(y, again),
               "allocations": _allocations(torch, run),
               "bound_ms": need / 3.35e12 * 1e3}
        del y, again, want, m_full
        rec["ms"] = _device_ms(torch, run, iters)
        copies = max(2, -(-int(COLD_BYTES) // (x.numel() * esize)))
        if x.numel() * esize >= 1 << 20:
            sets = [(x.clone(), None if mask is None else mask.clone())
                    for _ in range(copies)]
            rec["cold_ms"] = _device_ms(
                torch, [lambda s=s: run(*s) for s in sets], 2 * copies)
            del sets
        if mode == "scaled":
            lib = lambda: torch.softmax(x, -1)  # noqa: E731
        elif mode == "causal":
            a, sq, sk = shape
            upper = torch.triu(torch.ones(sq, sk, dtype=torch.bool,
                                          device="cuda"), 1)
            x4 = x.view(1, a, sq, sk)
            lib = lambda: torch._masked_softmax(x4, upper, 3, 0)  # noqa
        else:
            full = mask.expand(shape[0], *shape[1:]).contiguous()
            lib = lambda: torch._masked_softmax(x, full, 3, 2)  # noqa
        rec["lib_ms"] = _device_ms(torch, lib, iters)
        if hasattr(softmax, "fwd_route"):
            rec["route"] = softmax.fwd_route(
                x, None if mask is None else softmax._masked_args(x, mask),
                mode)
        yield f"softmax {mode} {name} {tuple(shape)} {dt}", rec
        del x, mask, lib
        torch.cuda.empty_cache()


GROUPS = ("layer_norm", "flash", "lamb_segment", "leaf_sum", "softmax")
# the segment cases: (layout, master, stash_p, with_grad_norm, u dtype)
SEGMENT_CASES = tuple(
    [("gpt2_345m", "fp32", st, gn, u) for st, gn, u in (
        (True, False, "float32"), (True, True, "float32"),
        (False, False, "float32"), (False, True, "float32"),
        (True, False, "bfloat16"), (False, False, "bfloat16"))]
    + [("bert_large", "fp32", st, gn, "float32")
       for st, gn in ((True, False), (False, True))]
    + [("bert_large", "bf16_sr", st, False, u)
       for st in (True, False) for u in ("float32", "bfloat16")])


def _gpt_leaves(torch, cfg) -> dict:
    """GPT of ``cfg``'s parameters in module order, as shapes on the
    meta device (``chip_smoke.gpt_leaves``)."""
    h, f = cfg.hidden_size, cfg.ffn
    qkv = (cfg.num_heads + 2 * cfg.kv_heads) * cfg.head_dim
    layer = [(h,), (h,), (qkv, h), (qkv,), (h, h), (h,), (h,), (h,),
             (f, h), (f,), (h, f), (h,)]
    shapes = [(cfg.vocab_size, h), (cfg.max_seq_len, h)] \
        + layer * cfg.num_layers + [(h,), (h,)]
    return {f"{i:03d}": torch.empty(s_, device="meta")
            for i, s_ in enumerate(shapes)}


def _bert_leaves(torch, models, cfg) -> dict:
    """BERT of ``cfg``'s parameters in module order, as shapes on the meta
    device, from a one-layer model's names (``chip_smoke.bert_leaves``)."""
    import dataclasses
    one = models.BertModel(dataclasses.replace(cfg, num_layers=1),
                           device="cpu")
    items = [(k, tuple(p_.shape)) for k, p_ in one.named_parameters()]
    layer = [(k[len("layers.0."):], s_) for k, s_ in items
             if k.startswith("layers.0.")]
    out = {}
    for k, s_ in items:
        if k.startswith("layers.0."):
            if k == "layers.0." + layer[0][0]:
                for i in range(cfg.num_layers):
                    for name, shp in layer:
                        out[f"layers.{i}.{name}"] = torch.empty(
                            shp, device="meta")
        else:
            out[k] = torch.empty(s_, device="meta")
    return out


def _host_ms(torch, fn, iters: int) -> float:
    """Host ms a call: CUDA events around ``iters`` back-to-back calls
    (the wrapper's issue time, where it exceeds the kernel's)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _segment_cases(torch, iters):
    """(key, record) of each segment case: hashes, its own check against
    the plain version, device, host and plain ms, the route."""
    from apex_tpu_torch import models
    from apex_tpu_torch.multi_tensor import segmented
    from apex_tpu_torch.optimizers import FusedLAMB
    layouts = {
        "gpt2_345m": _gpt_leaves(torch, models.GPTConfig.gpt2_345m()),
        "bert_large": _bert_leaves(torch, models,
                                   models.BertConfig.bert_large()),
    }
    for name, leaves in layouts.items():
        space, meta = FusedLAMB(lr=1e-4, weight_decay=0.01, max_grad_norm=1.0,
                                use_nvlamb=name == "bert_large").layout(leaves)
        n = space.total
        gen = torch.Generator(device="cuda").manual_seed(len(name))
        p32 = torch.randn(n, generator=gen, device="cuda").mul_(2e-2)
        m = torch.randn(n, generator=gen, device="cuda").mul_(1e-3)
        v = torch.rand(n, generator=gen, device="cuda").mul_(1e-6)
        g = torch.randn(n, generator=gen, device="cuda").mul_(1e-2)
        small = torch.cat([torch.arange(s_ * meta.seg_elems,
                                        (s_ + 1) * meta.seg_elems,
                                        device="cuda")
                           for s_ in meta.small_segments])
        large_ids = {l_ for l_, _, _ in meta.large}
        live = torch.cat([torch.arange(off, off + size, device="cuda")
                          for i, (off, size) in enumerate(zip(space.offsets,
                                                              space.sizes))
                          if i not in large_ids])
        for lay, master, stash, gn, u in SEGMENT_CASES:
            if lay != name:
                continue
            p = p32 if master == "fp32" else p32.bfloat16()
            u_dt = getattr(torch, u)
            kw = dict(meta=meta, scalars=(0.9, 0.999, 0.1, 1e-6, 0.01, 0.271,
                                          0.002997, 1.0),
                      inv_scale=torch.tensor(1.75, device="cuda"), lr=1e-3,
                      use_nvlamb=name == "bert_large", wd_is_zero=False,
                      stash_p=stash, with_grad_norm=gn, u_dtype=u_dt,
                      sr_seed=None if master == "fp32" else 17)
            outs = [t.clone() for t in (p, m, v)]
            ref = [t.clone() for t in (p, m, v)]
            _, gg = segmented._small_segment_pass(p, m, v, g, outs, **kw)
            _, wgg = segmented._small_segment_pass(p, m, v, g, ref,
                                                   plain=True, **kw)
            torch.cuda.synchronize()
            got_p, want_p = outs[0][live].float(), ref[0][live].float()
            step = (p[live].float() - want_p).abs()
            ulp = (2.0 ** (-7 if master != "fp32" else -23)
                   * torch.maximum(got_p.abs(), want_p.abs()))
            rec = {
                "sha256": _digest(torch, [t[small] for t in outs[1:]]),
                "p_sha256": _digest(torch, [outs[0][small]]),
                "gg_sha256": None if gg is None else _digest(torch, [gg]),
                "mv_plain_bitwise": all(torch.equal(a[small], b[small])
                                        for a, b in zip(outs[1:], ref[1:])),
                "p_plain_bitwise": torch.equal(outs[0][small], ref[0][small]),
                "p_within_tol": bool(((got_p - want_p).abs()
                                      <= 1e-5 * step + ulp).all()),
                "gg_plain_rel": None if gg is None else float(
                    ((gg - wgg).abs() / wgg.abs().clamp_min(1e-30)).max()),
            }
            del got_p, want_p, step, ulp, ref
            def run(kw=kw, outs=outs):
                return segmented._small_segment_pass(p, m, v, g, outs, **kw)
            rec["ms"] = _device_ms(torch, run, iters)
            rec["host_ms"] = _host_ms(torch, run, 20)
            if hasattr(segmented, "segment_route"):
                rec["route"] = segmented.segment_route(
                    meta, stash_p=stash, p_dtype=p.dtype, u_dtype=u_dt,
                    device=torch.device("cuda"))
            key = (f"lamb_segment {name} {master} stash_p={stash} "
                   f"with_grad_norm={gn} u={u}")
            yield key, rec
            del outs
        del p32, m, v, g, small, live
        torch.cuda.empty_cache()


def _leaf_sum_cases(torch, iters):
    """(key, record) of GPT-2 345M's 292 leaves' sum: its hash, the plain
    version's, two calls', device ms and ``index_add_``'s."""
    from apex_tpu_torch import models
    from apex_tpu_torch.multi_tensor import FlatSpace, engine
    space = FlatSpace.create(_gpt_leaves(torch, models.GPTConfig.gpt2_345m()))
    n_sub = space.total // 2048
    gen = torch.Generator(device="cuda").manual_seed(71)
    x = torch.rand(n_sub, generator=gen, device="cuda")
    a = engine.leaf_sums(x, space)
    b = engine.leaf_sums(x, space)
    pl = engine.leaf_sums(x, space, plain=True)
    ids = space.device_subtile_leaf_ids("cuda").long()
    out = torch.zeros(space.num_leaves, device="cuda")
    yield "leaf_sum gpt2_345m 292 leaves", {
        "sha256": _digest(torch, [a]),
        "plain_bitwise": torch.equal(a, pl),
        "repeat_bitwise": torch.equal(a, b),
        "ms": _device_ms(torch, lambda: engine.leaf_sums(x, space), iters),
        "lib_ms": _device_ms(torch, lambda: out.zero_().index_add_(
            0, ids, x[:len(ids)]), iters)}


def _card(torch) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them (a
    card may be set below its 700 W), else its name alone."""
    import subprocess
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True)
        return got.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(0)


def _fmt(v) -> str:
    return "-" if v is None else f"{v:.5f}"


def save(root: str, path: str, iters: int, only=None) -> None:
    sys.path.insert(0, root)
    import torch
    from apex_tpu_torch import _build
    from apex_tpu_torch.ops import attention, layer_norm

    if not torch.cuda.is_available():
        raise SystemExit("tree_compare: no CUDA device")
    groups_on = set(only or GROUPS)
    # these libraries alone (a checkout with the split pass has its own)
    names = []
    if "layer_norm" in groups_on:
        names.append("layer_norm")
    if "flash" in groups_on:
        names.append("flash_fwd_fp32")
        if "flash_split3" in _build.SOURCES:
            names.append("flash_split3")
    if "lamb_segment" in groups_on:
        names += ["lamb_segment", "sumsq"]
    if "leaf_sum" in groups_on and "sumsq" not in names:
        names.append("sumsq")
    if "softmax" in groups_on:
        names.append("softmax")
    _build.build_all(names)
    out = {"card": _card(torch), "cases": {}}
    for lib_name in ("lamb_segment", "softmax"):
        if lib_name in groups_on:
            out[f"build_log_{lib_name}"] = _build.build_log(lib_name)
    groups = []
    if "layer_norm" in groups_on:
        groups.append(_ln_cases(torch, layer_norm, iters))
    if "flash" in groups_on:
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
    records = []
    if "lamb_segment" in groups_on:
        records.append(_segment_cases(torch, iters))
    if "leaf_sum" in groups_on:
        records.append(_leaf_sum_cases(torch, iters))
    if "softmax" in groups_on:
        records.append(_softmax_cases(torch, iters))
    for cases in records:
        for key, rec in cases:
            out["cases"][key] = rec
            print(f"{key}: " + " ".join(
                f"{k} {_fmt(v) if isinstance(v, float) else v}"
                for k, v in rec.items() if not k.endswith("sha256")))
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
        if key.startswith("lamb_segment"):
            what = "m'/v' bitwise"
        elif "dw" in first:
            what = "dx bitwise"
        else:
            what = "bitwise"
        line = f"{key}: {what} {first['sha256'] == second['sha256']}"
        if "dw" in first:
            line += (f"; dw rel {_rel(second['dw'], first['dw']):.3e}, "
                     f"db rel {_rel(second['db'], first['db']):.3e}")
        for h in ("p_sha256", "gg_sha256"):
            if first.get(h) is not None:
                line += f"; {h[:-7]} bitwise {first[h] == second.get(h)}"
        for c in ("mv_plain_bitwise", "p_plain_bitwise", "p_within_tol",
                  "gg_plain_rel", "plain_bitwise", "plain_ulp_excess",
                  "repeat_bitwise", "allocations"):
            if c in first:
                line += f"; {c} {first[c]} / {second.get(c)}"
        for t in ("ms", "cold_ms", "host_ms"):
            if first.get(t) is not None:
                line += (f"; {t} {first[t]:.5f} (first) "
                         f"{_fmt(second.get(t))} (second)")
        for t in ("lib_ms", "bound_ms"):
            if first.get(t) is not None:
                line += f"; {t} {first[t]:.5f}"
        for r in (first.get("route"), second.get("route")):
            if r is not None:
                line += f"; route {r}"
        print(line)
    return 0


def _groups(text: str):
    names = tuple(t for t in text.split(",") if t)
    bad = [t for t in names if t not in GROUPS]
    if bad or not names:
        raise argparse.ArgumentTypeError(
            f"--only takes a comma-separated list of {', '.join(GROUPS)}")
    return names


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("save")
    s.add_argument("--root", required=True,
                   help="the checkout whose apex_tpu_torch runs")
    s.add_argument("--iters", type=int, default=50)
    s.add_argument("--only", type=_groups,
                   help=f"a comma-separated list of {', '.join(GROUPS)}")
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
