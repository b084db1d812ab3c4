"""The flash attention's additive bias, global positions and lse
cotangent: apex_tpu_torch against apex_tpu.

The same numpy inputs and cotangents go through the reference's
``flash_attention`` (``jax.vjp`` of its XLA path and of its Pallas
kernels in interpret mode) and the port's, whose CPU tensors take the
plain forward and ``_FlashFn``'s plain backward (``_flash_bwd_torch``,
and ``_dbias`` for the bias) — the versions the CUDA kernels are held
against on the card (``tests/test_torch_kernels_cuda.py``). The plain
backward is also held directly against the reference's
``_flash_bwd_pallas`` in interpret mode, with small blocks so that
position bounds and bias blocks span several tiles.

Tolerances, in fp32: outputs and the lse within 2e-5 absolute (fp32
softmax, sums and exponentials in other orders, online and blockwise on
the interpret side); dq, dk, dv and dbias within 2e-5 of each one's
largest |value| (products and sums in other orders; dbias sums up to a
(b, h, sq) broadcast of dS).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from apex_tpu.ops.attention import _flash_bwd_pallas
from apex_tpu.ops.attention import flash_attention as ref_flash
from apex_tpu.transformer.context_parallel import zigzag_indices

from apex_tpu_torch.ops import attention as port

ATOL = 2e-5
GRAD_RTOL = 2e-5

# the bias's broadcast classes: each dimension 1 or full
BIAS_SHAPES = {
    "q_k": lambda b, h, sq, sk: (1, 1, sq, sk),
    "key_padding": lambda b, h, sq, sk: (b, 1, 1, sk),
    "full": lambda b, h, sq, sk: (b, h, sq, sk),
    "heads": lambda b, h, sq, sk: (1, h, sq, sk),
    "heads_rows": lambda b, h, sq, sk: (1, h, sq, 1),
    "batch_rows": lambda b, h, sq, sk: (b, 1, sq, 1),
}


def _arrays(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def _vjp_both(q, k, v, g, impl, bias=None, glse=None, **kw):
    """(out, [lse], grads) of the reference (``impl``) and of the port;
    grads are (dq, dk, dv[, dbias]). With ``glse`` the call returns the
    lse too and both cotangents flow."""
    with_lse = glse is not None
    jkw = {n: (jnp.asarray(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()}
    tkw = {n: (torch.from_numpy(a) if isinstance(a, np.ndarray) else a)
           for n, a in kw.items()}
    args = [q, k, v] + ([] if bias is None else [bias])

    def f(*a):
        bb = a[3] if bias is not None else None
        return ref_flash(*a[:3], bias=bb, impl=impl, return_lse=with_lse,
                         **jkw)
    want_out, vjp = jax.vjp(f, *(jnp.asarray(a) for a in args))
    cot = (jnp.asarray(g), jnp.asarray(glse)) if with_lse else jnp.asarray(g)
    want = [np.asarray(c) for c in vjp(cot)]
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    got_out = port.flash_attention(
        *leaves[:3], bias=leaves[3] if bias is not None else None,
        return_lse=with_lse, **tkw)
    if with_lse:
        out, lse = got_out
        (out * torch.from_numpy(g)).sum().add(
            (lse * torch.from_numpy(glse)).sum()).backward()
    else:
        got_out.backward(torch.from_numpy(g))
    got = [t.grad.numpy() for t in leaves]
    return want_out, got_out, want, got


def _close_grads(got, want, names=("dq", "dk", "dv", "dbias")):
    # a bias constant along the keys has an exactly-zero true gradient (a
    # per-row constant leaves the softmax as it is): both sides then read
    # fp32 noise, held against the largest of the other gradients
    floor = max(float(np.abs(w).max()) for w in want[:3])
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, (name, a.shape, b.shape)
        scale = max(float(np.abs(b).max()),
                    floor if name == "dbias" else 1e-6)
        err = float(np.abs(a - b).max())
        assert err <= GRAD_RTOL * scale, (name, err, scale)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape", sorted(BIAS_SHAPES))
def test_bias_broadcast_forward_and_grads(impl, shape):
    b, h, sq, sk, d = 2, 2, 24, 24, 8
    bshape = BIAS_SHAPES[shape](b, h, sq, sk)
    q, k, v, g, bias = _arrays(1, (b, h, sq, d), (b, h, sk, d),
                               (b, h, sk, d), (b, h, sq, d), bshape)
    want_out, got_out, want, got = _vjp_both(q, k, v, g, impl,
                                             bias=bias * 0.5, causal=True)
    _close(got_out, want_out)
    _close_grads(got, want)


@pytest.mark.parametrize("case", ["segments", "gqa", "non_causal_offset"])
def test_bias_with_segments_gqa_and_offsets(impl, case):
    b, h, hk, sq, sk, d = 2, 4, 4, 16, 16, 8
    kw = {"causal": True}
    if case == "gqa":
        hk = 2
    elif case == "non_causal_offset":
        sk, kw = 24, {}
    q, k, v, g, bias = _arrays(2, (b, h, sq, d), (b, hk, sk, d),
                               (b, hk, sk, d), (b, h, sq, d),
                               (b, h, sq, sk))
    if case == "segments":
        seg = np.zeros((b, sq), np.int32)
        seg[:, sq // 2:] = 1
        kw.update(segment_ids=seg)
    want_out, got_out, want, got = _vjp_both(q, k, v, g, impl, bias=bias,
                                             **kw)
    _close(got_out, want_out)
    _close_grads(got, want)


@pytest.mark.parametrize("shape", ["key_padding", "full"])
def test_bias_with_dropout_same_mask(impl, shape):
    b, h, sq, d = 2, 2, 16, 8
    q, k, v, g, bias = _arrays(3, (b, h, sq, d), (b, h, sq, d),
                               (b, h, sq, d), (b, h, sq, d),
                               BIAS_SHAPES[shape](b, h, sq, sq))
    key = jax.random.PRNGKey(5)
    kd = np.asarray(jax.random.key_data(key)).astype(np.uint32).ravel()
    jq, jk, jv, jb = (jnp.asarray(a) for a in (q, k, v, bias))
    want_out, vjp = jax.vjp(
        lambda *a: ref_flash(*a[:3], bias=a[3], causal=True,
                             dropout_rate=0.25, dropout_rng=key, impl=impl),
        jq, jk, jv, jb)
    want = [np.asarray(c) for c in vjp(jnp.asarray(g))]
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v, bias)]
    out = port.flash_attention(*leaves[:3], bias=leaves[3], causal=True,
                               dropout_rate=0.25, dropout_rng=kd)
    out.backward(torch.from_numpy(g))
    _close(out, want_out)
    _close_grads([t.grad.numpy() for t in leaves], want)


def test_bf16_bias_reads_as_fp32_and_dbias_keeps_its_dtype():
    b, h, sq, d = 1, 2, 16, 8
    q, k, v, g, bias = _arrays(4, (b, h, sq, d), (b, h, sq, d),
                               (b, h, sq, d), (b, h, sq, d), (1, 1, sq, sq))
    bias16 = np.array(jnp.asarray(bias).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    _, got_out, want, got = _vjp_both(q, k, v, g, "xla", bias=bias16,
                                      causal=True)
    tb = torch.from_numpy(bias16).to(torch.bfloat16).requires_grad_()
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = port.flash_attention(tq, tk, tv, bias=tb, causal=True)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(out.detach().numpy(),
                                  got_out.detach().numpy())
    assert tb.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(tb.grad.float().numpy(), got[3], rtol=2 ** -8,
                               atol=1e-6)


def test_dbias_only_when_the_bias_needs_one():
    q, k, v, bias = _arrays(5, (1, 2, 8, 8), (1, 2, 8, 8), (1, 2, 8, 8),
                            (1, 1, 8, 8))
    tq = torch.from_numpy(q).requires_grad_()
    tb = torch.from_numpy(bias)
    port.flash_attention(tq, torch.from_numpy(k), torch.from_numpy(v),
                         bias=tb).sum().backward()
    assert tb.grad is None and tq.grad is not None
    # a bias alone needing a gradient still takes the flash backward
    tb.requires_grad_()
    out = port.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), bias=tb)
    assert "FlashFn" in type(out.grad_fn).__name__
    out.sum().backward()
    assert tb.grad.shape == (1, 1, 8, 8)


def _zigzag_positions(seq, cp, shard_q, shard_k):
    perm, _ = zigzag_indices(seq, cp)
    n = seq // cp
    return (perm[shard_q * n:(shard_q + 1) * n].astype(np.int32),
            perm[shard_k * n:(shard_k + 1) * n].astype(np.int32))


@pytest.mark.parametrize("case", ["zigzag_past", "zigzag_mixed",
                                  "zigzag_future", "windowed"])
def test_positions_forward_and_grads(impl, case):
    b, h, d = 1, 2, 8
    if case == "windowed":
        qp = np.arange(16, 32, dtype=np.int32)
        kp = np.arange(8, 32, dtype=np.int32)
        kw = {"window_size": 6}
    else:
        # 64 tokens over 4 zig-zag shards of 16 (chunks of 8): shard 1
        # holds chunks 1 and 6, shard 3 chunks 3 and 4
        shard_k = {"zigzag_past": 0, "zigzag_mixed": 1,
                   "zigzag_future": 3}[case]
        qp, kp = _zigzag_positions(64, 4, 1, shard_k)
        if case == "zigzag_future":
            qp = qp[:8]          # chunk 1: every key of shard 3 is later
        kw = {}
    q, k, v, g = _arrays(6, (b, h, len(qp), d), (b, h, len(kp), d),
                         (b, h, len(kp), d), (b, h, len(qp), d))
    glse = np.zeros((b, h, len(qp)), np.float32)
    want_out, got_out, want, got = _vjp_both(
        q, k, v, g, impl, glse=glse, causal=True, q_positions=qp,
        kv_positions=kp, **kw)
    _close(got_out[0], want_out[0])
    wl, gl = np.asarray(want_out[1]), got_out[1].detach().numpy()
    live = wl > port.NEG_INF * 0.5
    assert np.array_equal(live, gl > port.NEG_INF * 0.5)
    np.testing.assert_allclose(gl[live], wl[live], rtol=0, atol=ATOL)
    assert (gl[~live] == port.NEG_INF).all()
    _close_grads(got, want)
    if case == "zigzag_future":
        # every key in every query's future: nothing attends, nothing flows
        assert (got_out[0].detach().numpy() == 0).all()
        assert all((a == 0).all() for a in got)


@pytest.mark.parametrize("case", ["plain", "bias_gqa", "positions"])
def test_lse_cotangent(impl, case):
    b, h, hk, sq, d = 2, 4, 4, 16, 8
    kw, bias = {"causal": True}, None
    if case == "bias_gqa":
        hk = 2
        bias = _arrays(7, (b, 1, sq, sq))[0]
    if case == "positions":
        qp, kp = _zigzag_positions(64, 4, 1, 0)
        kw.update(q_positions=qp, kv_positions=kp)
    q, k, v, g, glse = _arrays(8, (b, h, sq, d), (b, hk, sq, d),
                               (b, hk, sq, d), (b, h, sq, d), (b, h, sq))
    want_out, got_out, want, got = _vjp_both(q, k, v, g, impl, bias=bias,
                                             glse=glse, **kw)
    _close(got_out[0], want_out[0])
    _close(got_out[1], want_out[1])
    _close_grads(got, want)


@pytest.mark.parametrize("case", ["bias", "positions_glse", "all"])
def test_plain_backward_matches_pallas_interpret(case):
    """``_flash_bwd_torch`` against the reference's backward kernels
    (interpret mode, 8 x 8 blocks) on the same forward statistics."""
    b, h, hk, sq, sk, d = 1, 4, 2, 32, 32, 8
    q, k, v, g, glse, bias = _arrays(9, (b, h, sq, d), (b, hk, sk, d),
                                     (b, hk, sk, d), (b, h, sq, d),
                                     (b, h, sq), (1, h, sq, sk))
    use_bias = case in ("bias", "all")
    qp = kp = None
    if case != "bias":
        qp, kp = _zigzag_positions(64, 2, 0, 1)
        glse_t = torch.from_numpy(glse)
    else:
        glse, glse_t = None, None
    jb = jnp.asarray(bias) if use_bias else None
    out, lse = ref_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         bias=jb, causal=True, return_lse=True,
                         q_positions=qp, kv_positions=kp, impl="xla")
    delta = jnp.sum(out * jnp.asarray(g), axis=-1)
    res = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb, None, None,
           out, lse)
    want = _flash_bwd_pallas(
        res, jnp.asarray(g), delta, None, d ** -0.5, True, None, 0.0, 8, 8,
        True, glse=None if glse is None else jnp.asarray(glse),
        q_pos=qp, k_pos=kp)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    got = port._flash_bwd_torch(
        t(q), t(k), t(v), t(lse), t(g), t(delta), None, None, d ** -0.5,
        True, None, bias=t(bias) if use_bias else None, glse=glse_t,
        q_pos=None if qp is None else t(qp),
        k_pos=None if kp is None else t(kp))
    _close_grads([a.numpy() for a in got], [np.asarray(w) for w in want])
