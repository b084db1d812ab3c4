"""Context parallelism: the per-chunk compute of ring attention
(counterpart of ``apex_tpu/transformer/context_parallel.py`` :57-240).

Ring attention keeps Q on its device and passes (K, V) shards around
the ring; each visiting shard's (out, lse) partial merges exactly into
an online-softmax carry through ``logaddexp``, and the backward
recomputes each shard's gradient against the *global* (lse, delta).
Causality comes from global token positions, which makes zig-zag load
balancing a pure input permutation. This module holds the pieces that
run on one device:

- :func:`zigzag_indices`: the balancing permutation and its inverse;
- :func:`_chunk_attn`: local Q against one kv shard through
  ``flash_attention`` with positions and ``return_lse=True`` (on a CUDA
  tensor the flash forward kernel, tiles skipped by their positions);
- :func:`_merge`: the exact ``logaddexp`` combine of two partials;
- :func:`_chunk_grads`: one shard's share of (dq, dk, dv) from the
  global lse and delta, through the flash backward kernels with
  positions on a CUDA tensor.

``ring_attention``, ``ring_attention_sharded`` and Ulysses attention
need the distributed plane (the ring's neighbour exchange and the
all-to-all) and wait for it; a single device can run the ring's serial
schedule with these helpers.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from apex_tpu_torch._backend import uses_kernel
from apex_tpu_torch.ops.attention import (_flash_bwd_cuda, _flash_bwd_torch,
                                          as_positions, flash_attention)


def zigzag_indices(seq_len: int, cp_size: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Permutation (and its inverse) that balances causal work over the
    ring: device i holds chunks (i, 2 cp - 1 - i), one early and one late.
    ``x[perm]`` is the balanced order to shard; ``y[inv]`` restores the
    original order."""
    if seq_len % (2 * cp_size):
        raise ValueError(
            f"zig-zag needs seq_len divisible by 2*cp ({2 * cp_size}); "
            f"got {seq_len}")
    piece = seq_len // (2 * cp_size)
    chunks = np.arange(seq_len).reshape(2 * cp_size, piece)
    order = []
    for i in range(cp_size):
        order.append(chunks[i])
        order.append(chunks[2 * cp_size - 1 - i])
    perm = np.concatenate(order)
    return perm, np.argsort(perm)


def _chunk_attn(q, k_c, v_c, qpos, kpos, scale, causal):
    """One ring step: local Q against a visiting kv chunk, returning the
    (out fp32, lse) partial. A row that sees no key of the chunk (the
    chunk wholly in its causal future) carries lse = NEG_INF (zero
    mass), so its zero output never survives the merge."""
    out, lse = flash_attention(
        q, k_c, v_c, causal=causal,
        q_positions=qpos if causal else None,
        kv_positions=kpos if causal else None,
        softmax_scale=scale, return_lse=True)
    return out.float(), lse


def _merge(a, p):
    """The exact combine of two (out, lse) partials of the same rows."""
    o_a, l_a = a
    o_p, l_p = p
    l_new = torch.logaddexp(l_a, l_p)
    return (o_a * torch.exp(l_a - l_new)[..., None]
            + o_p * torch.exp(l_p - l_new)[..., None], l_new)


def _chunk_grads(q, k_c, v_c, qpos, kpos, g, lse, delta, scale, causal):
    """One visiting kv chunk's share of ``(dq, dk_c, dv_c)``, against the
    *global* softmax statistics: with P = exp(S - lse) over this chunk
    and delta = rowsum(out * g) of the global output, the per-chunk flash
    backward gives exactly this chunk's share, and the shares sum to the
    full gradient.

    On a CUDA tensor the flash backward kernels with positions; on a
    CPU tensor their plain version. Both return the input's dtype (the
    kernels' output), so a bf16 chunk is rounded once per chunk, as the
    reference's kernel path does; fp32 inputs keep fp32."""
    pos = {}
    if causal:
        pos = dict(q_pos=as_positions(qpos, q.device),
                   k_pos=as_positions(kpos, q.device))
    bwd = _flash_bwd_cuda if uses_kernel(q) else _flash_bwd_torch
    return bwd(q, k_c, v_c, lse.float().contiguous(), g,
               delta.float().contiguous(), None, None, scale, causal, None,
               **pos)


__all__ = ["zigzag_indices"]
