"""Prefill, chunked prefill and decode steps over the paged KV cache.

Counterpart of ``apex_tpu/serving/decode.py`` (:88-356). Each step runs
the model over the batch, writes this call's K/V into the cache pools
in place, and returns the last real token's fp32 logits, the selected
next token and a per-lane all-finite flag, by which the scheduler
quarantines a lane whose logits are not finite while the rest of its
batch keeps its tokens:

- ``prefill``: whole right-padded prompts (full causal attention);
- ``prefill_chunk``: one chunk per sequence resuming at ``starts``,
  attending the already-written context plus itself causally;
- ``decode``: one token per sequence against its cached context.

Token selection is :func:`select_token`, the reference's fused
sampler (:106-152) in plain PyTorch (the reference has no Pallas kernel
there): greedy argmax on ``temperature == 0`` lanes, and on the others a
temperature / top-k / top-p gumbel-max draw keyed on
``fold_in(PRNGKey(seed), fold_pos)``, ``fold_pos`` the emitted token's
sequence index, with :mod:`apex_tpu_torch.random`'s threefry2x32, so a
sampled stream is the reference's token for token. A model sharded over
a tensor axis (its ``axis``, tp > 1; the reference's
``tests/test_mesh.py::TestServingSharded``) runs on this rank's kv heads
(``KVCache.for_config`` sizes the pool so), and its vocab-parallel logits
are all-gathered over the tensor group before the selection, so every
rank emits the same token. PyTorch runs eagerly,
so the reference's per-shape compile cache and compile-tracker hooks
have no counterpart.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from apex_tpu_torch import random as jrandom

from apex_tpu_torch.transformer.tensor_parallel import (
    gather_from_tensor_model_parallel_region,
)
from apex_tpu_torch.serving.kv_cache import (
    KVCache,
    KVCacheState,
    append_kv,
    append_kv_chunk,
    append_kv_prefill,
    gather_kv,
)


class StepOut(NamedTuple):
    """One prefill/decode dispatch's results (tensors on the device)."""

    logits: torch.Tensor      # (batch, vocab) fp32 — the last real token's
    next_token: torch.Tensor  # (batch,) int64 — the selected token
    cache: KVCacheState
    finite: torch.Tensor      # (batch,) bool — every logit of the lane


Sampling = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]


def greedy_sampling(b: int) -> Sampling:
    """The all-greedy sampling arrays for ``b`` lanes — what every
    dispatch uses without ``sampling`` (temperature 0, no top-k, top-p
    1, seed 0)."""
    return (np.zeros(b, np.float32), np.zeros(b, np.int32),
            np.ones(b, np.float32), np.zeros(b, np.uint32))


def _sampling_arrays(b: int, sampling: Optional[Sequence]) -> Sampling:
    if sampling is None:
        return greedy_sampling(b)
    temps, top_ks, top_ps, seeds = sampling
    temps = np.asarray(temps, np.float32)
    if np.any(temps < 0):
        raise ValueError("temperatures must be >= 0")
    top_ps = np.asarray(top_ps, np.float32)
    if np.any((top_ps <= 0) | (top_ps > 1)):
        raise ValueError("top_p must be in (0, 1]")
    return (temps, np.asarray(top_ks, np.int32), top_ps,
            np.asarray(np.asarray(seeds, np.int64) & jrandom.M32, np.uint32))


def select_token(out: torch.Tensor, sampling: Sampling,
                 fold_pos) -> torch.Tensor:
    """The next token of each lane from its (b, vocab) fp32 logits
    ``out``, as the reference's ``select_token`` (:106-152): greedy
    argmax where the lane's temperature is 0 (bitwise the greedy path);
    otherwise the logits divided by the temperature, cut to the top
    ``top_k`` (0: all) and to the nucleus of ``top_p`` (the smallest
    prefix of the descending softmax whose mass before each entry is
    below ``top_p``) at the threshold ``max(kth, pth)``, and drawn by
    gumbel-max under ``fold_in(PRNGKey(seed), fold_pos)``. An all-greedy
    batch never sorts."""
    temps, top_ks, top_ps, seeds = sampling
    greedy = torch.argmax(out, dim=-1)
    if not np.any(temps > 0):
        return greedy
    dev = out.device
    b, v = out.shape
    t = torch.from_numpy(np.where(temps > 0, temps, 1.0).astype(
        np.float32)).to(dev)
    scaled = out.float() / t[:, None]
    sdesc = -torch.sort(-scaled, dim=-1).values
    kk = np.where(top_ks > 0, np.clip(top_ks, 1, v), v).astype(np.int64)
    kth = torch.gather(sdesc, 1, torch.from_numpy(kk - 1).to(dev)[:, None])
    # jax.nn.softmax as written: exp(x - max) / sum
    e = torch.exp(sdesc - sdesc[:, :1])
    cum = torch.cumsum(e / torch.sum(e, dim=-1, keepdim=True), dim=-1)
    ps = torch.from_numpy(top_ps).to(dev)
    keep = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=dev),
                      cum[:, :-1] < ps[:, None]], dim=1)
    n_keep = keep.sum(dim=-1)
    pth = torch.gather(sdesc, 1, (n_keep - 1)[:, None])
    thresh = torch.maximum(kth, pth)
    masked = torch.where(scaled >= thresh, scaled, -torch.inf)
    pos = np.asarray(fold_pos, np.int64).reshape(-1)
    keys = torch.tensor(
        [jrandom.threefry2x32(0, int(sd), 0, int(p) & jrandom.M32)
         for sd, p in zip(seeds, pos)], dtype=torch.int64, device=dev)
    drawn = torch.argmax(masked + jrandom.gumbel(keys, (v,), device=dev),
                         dim=-1)
    return torch.where(torch.from_numpy(temps > 0).to(dev), drawn, greedy)


class DecodeStep:
    """Prefill and decode dispatchers for one (model, cache). The model
    holds its weights; the cache state passed to each method is updated
    in place and returned in ``StepOut.cache``. Runs under
    ``torch.no_grad``."""

    def __init__(self, model, cache: KVCache):
        self.model = model
        self.cache = cache
        self.max_pos = model.config.max_seq_len - 1

    def _dev(self, x, dtype=torch.long) -> torch.Tensor:
        if isinstance(x, np.ndarray) and not x.flags.writeable:
            x = x.copy()
        return torch.as_tensor(x, device=self.cache.device, dtype=dtype)

    def _select(self, out: torch.Tensor, state: KVCacheState, sampling,
                fold_pos) -> StepOut:
        # a tensor-parallel model's logits are its vocab shard: gathered
        # over the tensor group first, so every rank picks the same token
        out = gather_from_tensor_model_parallel_region(
            out, getattr(self.model, "axis", None))
        nxt = select_token(out, _sampling_arrays(out.shape[0], sampling),
                           fold_pos)
        return StepOut(out, nxt, state, torch.isfinite(out).all(dim=-1))

    @torch.no_grad()
    def prefill(self, state: KVCacheState, tokens, lengths, tables,
                sampling=None) -> StepOut:
        """Run the full right-padded prompts ``tokens`` (b, s) with real
        ``lengths`` (b,), write their K/V through ``tables`` (b, w), and
        return the last real token's logits. Dummy batch rows use
        length 0 and an all-trash table. ``sampling``: per-lane
        ``(temperatures, top_ks, top_ps, seeds)`` (None: all greedy);
        the emitted token's index is the prompt length."""
        fold_pos = np.asarray(lengths)
        tokens, lengths = self._dev(tokens), self._dev(lengths)
        b, s = tokens.shape
        logits, (k_new, v_new) = self.model(tokens, return_kv=True)
        append_kv_prefill(state, k_new, v_new, tables, lengths)
        last = torch.clamp(lengths - 1, 0, s - 1)
        out = logits[last, torch.arange(b, device=logits.device)]
        return self._select(out, state, sampling, fold_pos)

    @torch.no_grad()
    def prefill_chunk(self, state: KVCacheState, tokens, starts, lengths,
                      tables, sampling=None) -> StepOut:
        """Resume prefill with one chunk per sequence: row ``i`` of lane
        ``b`` is the prompt token at position ``starts[b] + i``
        (``lengths[b]`` real rows). The chunk attends the cached prefix
        (gathered before its own writes) plus itself causally, then
        writes its K/V at the offset positions. The emitted token's
        index (meaningful on a prompt-completing chunk) is ``starts +
        lengths``."""
        fold_pos = np.asarray(starts) + np.asarray(lengths)
        tokens = self._dev(tokens)
        starts, lengths = self._dev(starts), self._dev(lengths)
        b, s = tokens.shape
        k_ctx, v_ctx = gather_kv(state, tables)
        L = k_ctx.shape[3]
        ar = torch.arange(L, device=tokens.device)
        ctx_mask = ar[None, :] < starts[:, None]
        pos = torch.clamp(
            starts[:, None] + torch.arange(s, device=tokens.device)[None, :],
            0, self.max_pos)
        logits, (k_new, v_new) = self.model(
            tokens, positions=pos, kv_ctx=(k_ctx, v_ctx), ctx_mask=ctx_mask,
            return_kv=True)
        append_kv_chunk(state, k_new, v_new, tables, starts, lengths)
        last = torch.clamp(lengths - 1, 0, s - 1)
        out = logits[last, torch.arange(b, device=logits.device)]
        return self._select(out, state, sampling, fold_pos)

    @torch.no_grad()
    def decode(self, state: KVCacheState, tokens, positions, tables,
               sampling=None) -> StepOut:
        """One token per sequence: ``tokens`` (b,) at ``positions`` (b,)
        (= the cached prefix length) attend their cached context, and
        their K/V are appended at ``positions``. Dummy batch rows use
        position 0 and an all-trash table. The emitted token's index is
        ``positions + 1``."""
        fold_pos = np.asarray(positions) + 1
        tokens, positions = self._dev(tokens), self._dev(positions)
        k_ctx, v_ctx = gather_kv(state, tables)
        L = k_ctx.shape[3]
        ctx_mask = (torch.arange(L, device=tokens.device)[None, :]
                    < positions[:, None])
        pos2 = torch.clamp(positions, 0, self.max_pos)[:, None]
        logits, (k_new, v_new) = self.model(
            tokens[:, None], positions=pos2, kv_ctx=(k_ctx, v_ctx),
            ctx_mask=ctx_mask, return_kv=True)
        append_kv(state, k_new[:, :, :, 0], v_new[:, :, :, 0], tables,
                  positions)
        return self._select(logits[0], state, sampling, fold_pos)


def make_decode_step(model, cache: KVCache) -> DecodeStep:
    """The serving steps for ``model`` (a
    :class:`~apex_tpu_torch.models.gpt.GPTModel`) over ``cache``."""
    return DecodeStep(model, cache)


__all__ = ["DecodeStep", "StepOut", "greedy_sampling", "make_decode_step",
           "select_token"]
