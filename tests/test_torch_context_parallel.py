"""The ring attention's chunk helpers of apex_tpu_torch against
apex_tpu's (``transformer/context_parallel.py``).

``zigzag_indices`` must be the reference's permutation. The ring's
serial schedule on one device — every zig-zag q shard against every kv
shard through ``_chunk_attn``, merged by ``_merge`` — and the chunk
gradients of ``_chunk_grads`` against the global lse and delta go
through the reference's functions (its XLA path, and its Pallas kernels
in interpret mode) and the port's plain versions on the same numpy
inputs, and sum to the unchunked attention and its gradients.

Tolerances, in fp32: outputs, lse and the merged results within 2e-5
absolute; per-chunk and summed gradients within 2e-5 of each one's
largest |value| (sums in other orders, online and blockwise on the
interpret side).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from apex_tpu.transformer import context_parallel as ref_cp

from apex_tpu_torch.ops import attention as port_attention
from apex_tpu_torch.transformer import context_parallel as port_cp

ATOL = 2e-5
GRAD_RTOL = 2e-5
SEQ, CP = 64, 4


@pytest.mark.parametrize("seq,cp", [(64, 4), (48, 3), (8, 1), (40, 2)])
def test_zigzag_indices_are_the_references(seq, cp):
    perm, inv = port_cp.zigzag_indices(seq, cp)
    want_perm, want_inv = ref_cp.zigzag_indices(seq, cp)
    np.testing.assert_array_equal(perm, want_perm)
    np.testing.assert_array_equal(inv, want_inv)
    np.testing.assert_array_equal(perm[inv], np.arange(seq))


def test_zigzag_needs_two_chunks_per_shard():
    with pytest.raises(ValueError, match="divisible by 2"):
        port_cp.zigzag_indices(30, 4)


def _shards(seed, h=4, hk=2, d=8):
    """q, k, v, g of SEQ tokens in the zig-zag order, cut into CP shards,
    with each shard's global positions."""
    rng = np.random.RandomState(seed)
    perm, _ = port_cp.zigzag_indices(SEQ, CP)
    full = [rng.randn(1, n, SEQ, d).astype(np.float32)
            for n in (h, hk, hk, h)]
    n = SEQ // CP
    cut = lambda a, i: np.ascontiguousarray(  # noqa: E731
        a[:, :, perm][:, :, i * n:(i + 1) * n])
    shards = [[cut(a, i) for a in full] for i in range(CP)]
    pos = [perm[i * n:(i + 1) * n].astype(np.int32) for i in range(CP)]
    return full, shards, pos, perm


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=ATOL)


def _close_rel(got, want, name):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= GRAD_RTOL * scale, (name, err, scale)


def _ring_forward(shards, pos, qi, chunk_attn, merge, asarray):
    """The ring's serial schedule for q shard ``qi``: its own kv shard
    first, then the others as they would arrive."""
    q = asarray(shards[qi][0])
    acc = None
    for step in range(CP):
        j = (qi - step) % CP
        part = chunk_attn(q, asarray(shards[j][1]), asarray(shards[j][2]),
                          asarray(pos[qi]), asarray(pos[j]))
        acc = part if acc is None else merge(acc, part)
    return acc


@pytest.mark.parametrize("qi", range(CP))
def test_chunk_attn_and_merge_over_four_shards(impl, qi):
    full, shards, pos, perm = _shards(0)
    scale = 8 ** -0.5
    want = _ring_forward(
        shards, pos, qi, lambda *a: ref_cp._chunk_attn(
            *a, scale, True, impl=impl), ref_cp._merge, jnp.asarray)
    got = _ring_forward(
        shards, pos, qi, lambda *a: port_cp._chunk_attn(*a, scale, True),
        port_cp._merge, torch.from_numpy)
    _close(got[0], want[0])
    _close(got[1], want[1])
    # and the unchunked attention of the same queries
    n = SEQ // CP
    rows = perm[qi * n:(qi + 1) * n]
    out, lse = port_attention.flash_attention(
        *(torch.from_numpy(a) for a in full[:3]), causal=True,
        return_lse=True)
    _close(got[0], out[:, :, rows])
    _close(got[1], lse[:, :, rows])


@pytest.mark.parametrize("qi", range(CP))
def test_chunk_grads_sum_to_the_unchunked_gradient(impl, qi):
    full, shards, pos, perm = _shards(1)
    scale = 8 ** -0.5
    t = torch.from_numpy
    out, lse = _ring_forward(
        shards, pos, qi, lambda *a: port_cp._chunk_attn(*a, scale, True),
        port_cp._merge, t)
    q, g = shards[qi][0], shards[qi][3]
    delta = (out * t(g)).sum(-1)
    dq = torch.zeros(q.shape)
    dkv = []
    for j in range(CP):
        got = port_cp._chunk_grads(t(q), t(shards[j][1]), t(shards[j][2]),
                                   t(pos[qi]), t(pos[j]), t(g), lse, delta,
                                   scale, True)
        want = ref_cp._chunk_grads(
            jnp.asarray(q), jnp.asarray(shards[j][1]),
            jnp.asarray(shards[j][2]), jnp.asarray(pos[qi]),
            jnp.asarray(pos[j]), jnp.asarray(g), jnp.asarray(lse.numpy()),
            jnp.asarray(delta.numpy()), scale, True, impl, bq=8, bk=8)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            assert a.dtype == torch.float32
            _close_rel(a, b, f"{name} of kv shard {j}")
        dq += got[0]
        dkv.append(got[1:])
    # summed over the kv shards: the unchunked dq of these queries; each
    # kv shard's share: the unchunked dk, dv of its keys from these rows
    leaves = [t(a).requires_grad_() for a in full[:3]]
    n = SEQ // CP
    rows = perm[qi * n:(qi + 1) * n]
    gfull = torch.zeros(full[3].shape)
    gfull[:, :, rows] = t(g)
    port_attention.flash_attention(*leaves, causal=True).backward(gfull)
    _close_rel(dq, leaves[0].grad[:, :, rows], "dq")
    for i, name in ((0, "dk"), (1, "dv")):
        total = torch.zeros_like(leaves[1 + i].grad)
        for j in range(CP):
            keys = torch.from_numpy(perm[j * n:(j + 1) * n])
            total.index_add_(2, keys, dkv[j][i])
        _close_rel(total, leaves[1 + i].grad, name)


def test_chunk_grads_without_causal_mask():
    _, shards, _, _ = _shards(2)
    t = torch.from_numpy
    q, k, v, g = shards[0]
    lse = torch.from_numpy(np.full((1, 4, 16), 3.0, np.float32))
    delta = torch.from_numpy(np.full((1, 4, 16), 0.1, np.float32))
    got = port_cp._chunk_grads(t(q), t(k), t(v), None, None, t(g), lse,
                               delta, 0.35, False)
    want = ref_cp._chunk_grads(*(jnp.asarray(a) for a in (q, k, v)), None,
                               None, jnp.asarray(g), jnp.asarray(lse.numpy()),
                               jnp.asarray(delta.numpy()), 0.35, False, "xla")
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        _close_rel(a, b, name)
