"""Paged KV cache: fixed-size blocks over one preallocated pool.

Counterpart of ``apex_tpu/serving/kv_cache.py``. Every layer's K and V
live in ONE preallocated pool of fixed-size blocks on the device,

    pool: (num_layers, num_blocks + 1, block_size, kv_heads, head_dim)

and each sequence owns an ordered block table. The host-side allocator
(:class:`KVCache`) is a copy of the reference's: LIFO free list,
per-block refcounts, the sha256 hash-chain prefix index with an LRU
cache of zero-ref published blocks, copy-on-write forks at the
divergence block, and dirty-block scrubbing before reuse. Block 0 is the
**trash block**: padded batch rows and padded prompt tails write there,
and unallocated table entries point at it, so the write shapes stay
fixed; no sequence is ever given block 0.

The device operations (:func:`gather_kv`, :func:`append_kv`,
:func:`append_kv_prefill`, :func:`append_kv_chunk`,
:func:`apply_copies`, :func:`scrub_blocks`) write the preallocated pools
in place with ``index_put_`` where the reference returned new arrays
from donated ones; each still returns the state for the same call
shape.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from apex_tpu_torch._backend import DeviceLike, resolve_device
from apex_tpu_torch.transformer.parallel_state import TENSOR_AXIS
from apex_tpu_torch.transformer.tensor_parallel.mappings import tensor_axis

TRASH_BLOCK = 0


class PoolExhausted(RuntimeError):
    """Admission refused: the pool cannot reserve the requested span.

    Carries ``needed`` / ``free`` block counts so the scheduler can
    tell a transient full pool (wait) from an impossible request
    (``needed > capacity``: reject)."""

    def __init__(self, msg: str, *, needed: int, free: int, capacity: int):
        super().__init__(msg)
        self.needed = int(needed)
        self.free = int(free)
        self.capacity = int(capacity)


class KVCacheState(NamedTuple):
    """The device-side pools. The decode step writes them in place
    (``index_put_``), so the cache never holds two copies."""

    k: torch.Tensor  # (num_layers, num_blocks, block_size, kv_heads, head_dim)
    v: torch.Tensor


class PrefixMatch(NamedTuple):
    """What :meth:`KVCache.allocate_prefix` matched for a prompt.

    ``matched`` tokens of the prompt are already resident (shared
    full blocks + ``fork_rows`` copied rows of the divergence block) —
    prefill resumes at position ``matched``. ``copies`` are the pending
    COW row copies ``(src_block, dst_block, rows)`` the engine must
    execute on the device state BEFORE the sequence's first chunk
    (``apply_copies``); until :meth:`KVCache.fork_copied` runs, the
    source blocks hold an extra reference so they cannot be evicted or
    scrubbed out from under the copy."""

    matched: int
    shared_blocks: int
    fork_rows: int
    copies: Tuple[Tuple[int, int, int], ...]


class KVCache:
    """Block allocator + pool factory for one model's KV cache.

    ``num_blocks`` counts usable blocks *excluding* the trash block
    (the pool array holds ``num_blocks + 1``).

    Thread-safety contract: every ALLOCATOR method (allocate / free /
    table / table_array / can_admit and the counters) takes this
    cache's internal lock, so a client thread calling
    ``ContinuousBatcher.submit()`` and the engine thread admitting,
    finishing can interleave freely. The device POOLS (``init_state()``'s
    tensors, on ``device`` — CUDA unless the caller names another) are
    not covered: they are owned by the engine thread and written in
    place by each prefill/decode dispatch — nothing else may touch them
    mid-step.
    """

    def __init__(self, num_layers: int, kv_heads: int, head_dim: int, *,
                 num_blocks: int, block_size: int = 16,
                 dtype: Optional[torch.dtype] = None,
                 device: DeviceLike = None):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        self.num_layers = int(num_layers)
        self.kv_heads = int(kv_heads)
        self.head_dim = int(head_dim)
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.dtype = dtype if dtype is not None else torch.float32
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        # LIFO free list: a freed sequence's blocks are the next handed
        # out (reuse-after-free is the common case under steady load,
        # and LIFO keeps the hot blocks hot)
        self._free: List[int] = list(range(self.num_blocks, 0, -1))
        self._tables: Dict[Any, List[int]] = {}
        # -- prefix-sharing plane (module docstring) -------------------
        self._refs: Dict[int, int] = {}          # block -> refcount
        # published block -> (chain hash, parent hash, block tokens)
        self._meta: Dict[int, Tuple[bytes, bytes, Tuple[int, ...]]] = {}
        self._index: Dict[bytes, int] = {}       # chain hash -> block
        self._children: Dict[bytes, List[int]] = {}
        # zero-ref published blocks, LRU order (prefix cache — these
        # count as reclaimable for admission)
        self._cached: "OrderedDict[int, bytes]" = OrderedDict()
        self._dirty: Set[int] = set()
        self._pending_scrub: List[int] = []      # zero-ref dirty blocks
        self._fork_refs: Dict[Any, List[int]] = {}
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_tokens_saved = 0

    @classmethod
    def for_config(cls, cfg, *, num_blocks: int, block_size: int = 16,
                   dtype: Optional[torch.dtype] = None,
                   device: DeviceLike = None,
                   axis_name=TENSOR_AXIS) -> "KVCache":
        """Size the cache from a ``GPTConfig``-shaped model config:
        ``kv_heads`` (the GQA-narrowed count) x ``head_dim`` blocks —
        GQA pays GQA-sized blocks, never ``num_heads``-sized ones. Over a
        tensor axis (``axis_name``) of tp > 1 ranks the pool holds this
        rank's ``kv_heads / tp`` heads, those of its model shard."""
        tp = tensor_axis(axis_name).size
        if cfg.kv_heads % tp:
            raise ValueError(f"tensor-parallel size {tp} does not divide "
                             f"{cfg.kv_heads} kv heads")
        return cls(cfg.num_layers, cfg.kv_heads // tp,
                   cfg.hidden_size // cfg.num_heads,
                   num_blocks=num_blocks, block_size=block_size,
                   dtype=dtype if dtype is not None else cfg.dtype,
                   device=device)

    # -- pool ---------------------------------------------------------------

    def init_state(self) -> KVCacheState:
        """Allocate the pools on the cache's device (once; +1 block for
        the trash block)."""
        shape = (self.num_layers, self.num_blocks + 1, self.block_size,
                 self.kv_heads, self.head_dim)
        return KVCacheState(
            k=torch.zeros(shape, dtype=self.dtype, device=self.device),
            v=torch.zeros(shape, dtype=self.dtype, device=self.device))

    def pool_bytes(self) -> int:
        n = (self.num_layers * (self.num_blocks + 1) * self.block_size
             * self.kv_heads * self.head_dim)
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return 2 * n * itemsize

    # -- allocator ----------------------------------------------------------

    def blocks_for(self, total_len: int) -> int:
        """Blocks a sequence of ``total_len`` tokens occupies."""
        return -(-max(int(total_len), 1) // self.block_size)

    def can_admit(self, total_len: int) -> bool:
        with self._lock:
            return self.blocks_for(total_len) <= self._reclaimable()

    def _reclaimable(self) -> int:
        # free list + the zero-ref prefix cache (evictable on demand)
        return len(self._free) + len(self._cached)

    @property
    def free_blocks(self) -> int:
        with self._lock:
            return self._reclaimable()

    @property
    def blocks_in_use(self) -> int:
        """Blocks referenced by live sequences (cached prefix blocks
        and pending-scrub blocks are reclaimable, not in use)."""
        with self._lock:
            return len(self._refs)

    def _take_private(self, need: int, seq_id) -> List[int]:
        """Pop ``need`` fresh private blocks — free list first, then
        evict the LRU tail of the prefix cache. Caller holds the
        lock."""
        if need > self._reclaimable():
            raise PoolExhausted(
                f"kv pool exhausted: sequence {seq_id!r} needs {need} "
                f"blocks, {self._reclaimable()} free of "
                f"{self.num_blocks}",
                needed=need, free=self._reclaimable(),
                capacity=self.num_blocks)
        out: List[int] = []
        for _ in range(need):
            if self._free:
                out.append(self._free.pop())
            else:
                blk, _h = self._cached.popitem(last=False)   # LRU evict
                self._unpublish(blk)
                out.append(blk)
        for b in out:
            self._refs[b] = 1
        return out

    def allocate(self, seq_id, total_len: int) -> List[int]:
        """Reserve the full block span for a sequence reaching
        ``total_len`` tokens; raises :class:`PoolExhausted` when the
        free list can't cover it (the admission-control refusal).
        Private blocks only — the prefix-aware admit path is
        :meth:`allocate_prefix`."""
        need = self.blocks_for(total_len)
        with self._lock:
            if seq_id in self._tables:
                raise ValueError(f"sequence {seq_id!r} already allocated")
            blocks = self._take_private(need, seq_id)
            self._tables[seq_id] = blocks
            return list(blocks)

    def allocate_prefix(self, seq_id, prompt: Sequence[int],
                        total_len: int,
                        chunk: Optional[int] = None) -> PrefixMatch:
        """Reserve blocks for a sequence whose prompt is ``prompt``,
        reusing published prefix blocks by reference and COW-forking
        the divergence block.

        ``total_len`` is the full span (prompt + max_new). With
        ``chunk=None`` the whole span is reserved up front (the
        monolithic-admit contract); with a chunk size, reservation is
        STAGED — only ``matched + chunk`` tokens are covered now (the
        full span when that already reaches the end of the prompt),
        and the scheduler grows it via :meth:`extend` chunk by chunk.

        At most ``len(prompt) - 1`` tokens ever match (the last prompt
        token always prefills, so the first-token logits exist).
        Raises :class:`PoolExhausted` (leaking nothing) when the
        private remainder cannot be reserved.
        """
        prompt = tuple(int(t) for t in prompt)
        bs = self.block_size
        with self._lock:
            if seq_id in self._tables:
                raise ValueError(f"sequence {seq_id!r} already allocated")
            hashes = self._chain_hashes(prompt)
            max_full = (len(prompt) - 1) // bs
            shared: List[int] = []
            parent = b""
            for i in range(min(len(hashes), max_full)):
                blk = self._index.get(hashes[i])
                if blk is None or blk in self._dirty:
                    break
                shared.append(blk)
                parent = hashes[i]
            m = len(shared)
            # COW fork: longest common row prefix with a published
            # child of the matched chain (leave >= 1 token to prefill)
            fork_src, fork_rows = None, 0
            budget = len(prompt) - 1 - m * bs
            if budget > 0:
                want = prompt[m * bs: (m + 1) * bs]
                for cand in self._children.get(parent, ()):
                    if cand in self._dirty or cand not in self._meta:
                        continue
                    toks = self._meta[cand][2]
                    f = 0
                    for a, c in zip(toks, want):
                        if a != c:
                            break
                        f += 1
                    f = min(f, budget)
                    if f > fork_rows:
                        fork_src, fork_rows = cand, f
            matched = m * bs + fork_rows
            if chunk is None or matched + chunk >= len(prompt):
                reserve_len = total_len
            else:
                reserve_len = matched + chunk      # staged: first chunk
            need = self.blocks_for(reserve_len) - m
            if need < 0:
                need = 0
            if fork_rows and need < 1:
                need = 1                     # the fork's private block
            # reference the matched blocks FIRST: _take_private evicts
            # the cached LRU, and a matched-but-unreferenced block
            # must not be evicted out from under this admission
            for blk in shared:
                self._ref_locked(blk)
            if fork_rows:
                self._ref_locked(fork_src)   # pin src until the copy
            try:
                priv = self._take_private(need, seq_id)
            except PoolExhausted:
                for blk in shared:           # leak nothing on refusal
                    self._unref_locked(blk, dirty=False)
                if fork_rows:
                    self._unref_locked(fork_src, dirty=False)
                raise
            copies: Tuple[Tuple[int, int, int], ...] = ()
            if fork_rows:
                self._fork_refs[seq_id] = [fork_src]
                copies = ((fork_src, priv[0], fork_rows),)
            self._tables[seq_id] = shared + priv
            if matched > 0:
                self.prefix_hits += 1
                self.prefix_tokens_saved += matched
            else:
                self.prefix_misses += 1
            return PrefixMatch(matched=matched, shared_blocks=m,
                               fork_rows=fork_rows, copies=copies)

    def extend(self, seq_id, total_len: int) -> int:
        """Grow a sequence's reservation to cover ``total_len`` tokens
        (staged per-chunk reservation); returns how many NEW private
        blocks were appended. Raises :class:`PoolExhausted` leaving
        the existing reservation intact."""
        with self._lock:
            table = self._tables[seq_id]
            need = self.blocks_for(total_len) - len(table)
            if need <= 0:
                return 0
            table.extend(self._take_private(need, seq_id))
            return need

    def fork_copied(self, seq_id) -> None:
        """Drop the pin on a COW fork's source blocks (the engine has
        executed the row copies on the device state)."""
        with self._lock:
            for blk in self._fork_refs.pop(seq_id, []):
                self._unref_locked(blk, dirty=False)

    def free(self, seq_id, *, dirty: bool = False,
             clean_blocks: Sequence[int] = ()) -> int:
        """Return a sequence's block references to the pool; returns
        how many blocks were released.

        ``dirty=True`` (the quarantine path) marks every released
        block — except ``clean_blocks``, which the caller already
        scrubbed device-side — as poisoned: it is unpublished at once
        (never matched again) and, when its refcount reaches zero,
        parked on the pending-scrub list instead of the free list
        until :meth:`scrub_done` confirms the device rows were zeroed
        (refcount zero -> scrub -> reuse)."""
        clean = set(int(b) for b in clean_blocks)
        with self._lock:
            blocks = self._tables.pop(seq_id, None)
            if blocks is None:
                return 0
            for blk in self._fork_refs.pop(seq_id, []):
                self._unref_locked(blk, dirty=False)
            for b in blocks:
                self._unref_locked(b, dirty=dirty and b not in clean)
            return len(blocks)

    def _ref_locked(self, blk: int) -> None:
        if blk in self._refs:
            self._refs[blk] += 1
            return
        # revive a zero-ref cached prefix block
        self._cached.pop(blk, None)
        self._refs[blk] = 1

    def _unref_locked(self, blk: int, *, dirty: bool) -> None:
        if dirty and blk not in self._dirty:
            self._dirty.add(blk)
            self._unpublish(blk)             # never matched again
        self._refs[blk] -= 1
        if self._refs[blk] > 0:
            return
        del self._refs[blk]
        if blk in self._dirty:
            self._pending_scrub.append(blk)
        elif blk in self._meta:
            self._cached[blk] = self._meta[blk][0]
            self._cached.move_to_end(blk)
        else:
            self._free.append(blk)

    def _unpublish(self, blk: int) -> None:
        meta = self._meta.pop(blk, None)
        if meta is None:
            return
        h, parent, _toks = meta
        if self._index.get(h) == blk:
            del self._index[h]
        kids = self._children.get(parent)
        if kids and blk in kids:
            kids.remove(blk)
            if not kids:
                del self._children[parent]
        self._cached.pop(blk, None)

    def _chain_hashes(self, prompt: Tuple[int, ...]) -> List[bytes]:
        bs = self.block_size
        out: List[bytes] = []
        h = b""
        for i in range(len(prompt) // bs):
            blk = np.asarray(prompt[i * bs:(i + 1) * bs],
                             np.int64).tobytes()
            h = hashlib.sha256(h + blk).digest()
            out.append(h)
        return out

    def publish_prefix(self, seq_id, prompt: Sequence[int]) -> int:
        """Publish a fully-prefilled sequence's full prompt blocks into
        the prefix index (later prompts with the same token blocks
        share them by reference); returns how many blocks were newly
        published. First publisher wins — blocks whose chain hash is
        already indexed are left alone."""
        prompt = tuple(int(t) for t in prompt)
        bs = self.block_size
        published = 0
        with self._lock:
            table = self._tables.get(seq_id)
            if table is None:
                return 0
            hashes = self._chain_hashes(prompt)
            parent = b""
            for i, h in enumerate(hashes):
                blk = table[i]
                if blk in self._dirty:
                    break
                if h in self._index:
                    parent = h
                    continue                 # first publisher wins
                if blk in self._meta:        # published under another
                    parent = h               # chain (shared-in block)
                    continue
                self._meta[blk] = (h, parent,
                                   prompt[i * bs:(i + 1) * bs])
                self._index[h] = blk
                self._children.setdefault(parent, []).append(blk)
                parent = h
                published += 1
            return published

    def take_pending_scrub(self) -> List[int]:
        """Pop the zero-ref dirty blocks awaiting a device scrub; the
        engine must zero their pool rows and call :meth:`scrub_done`
        before they can be reused."""
        with self._lock:
            out, self._pending_scrub = self._pending_scrub, []
            return out

    def scrub_done(self, blocks: Sequence[int]) -> None:
        """Return device-scrubbed blocks to the free list."""
        with self._lock:
            for b in blocks:
                self._dirty.discard(b)
                self._free.append(b)

    def reset_prefix_cache(self) -> int:
        """Drop every zero-ref cached prefix block back to the free
        list and clear the index (bench runs isolate workloads this
        way); returns how many blocks were reclaimed."""
        with self._lock:
            n = len(self._cached)
            for blk in list(self._cached):
                self._unpublish(blk)
                self._free.append(blk)
            self._cached.clear()
            self.prefix_hits = 0
            self.prefix_misses = 0
            self.prefix_tokens_saved = 0
            return n

    def prefix_match_len(self, prompt: Sequence[int]) -> int:
        """How many leading prompt tokens the prefix index could hand
        out by REFERENCE right now: full published, non-dirty blocks
        along the prompt's sha256 hash chain (capped at
        ``len(prompt) - 1`` like :meth:`allocate_prefix`; COW-fork
        partial rows are not counted — this is a cheap placement
        probe, not a reservation). Read-only: nothing is referenced,
        revived, or evicted."""
        prompt = tuple(int(t) for t in prompt)
        with self._lock:
            hashes = self._chain_hashes(prompt)
            max_full = (len(prompt) - 1) // self.block_size
            m = 0
            for i in range(min(len(hashes), max_full)):
                blk = self._index.get(hashes[i])
                if blk is None or blk in self._dirty:
                    break
                m += 1
            return m * self.block_size

    def prefix_stats(self) -> Dict[str, int]:
        """Prefix-cache accounting for gauges/flight bundles."""
        with self._lock:
            shared = sum(1 for r in self._refs.values() if r > 1)
            return {
                "cached_blocks": len(self._cached),
                "shared_blocks": shared,
                "published_blocks": len(self._meta),
                "pending_scrub": len(self._pending_scrub),
                "hits": self.prefix_hits,
                "misses": self.prefix_misses,
                "tokens_saved": self.prefix_tokens_saved,
            }

    def block_ref(self, blk: int) -> int:
        with self._lock:
            return self._refs.get(int(blk), 0)

    def exclusive_blocks(self, seq_id) -> List[int]:
        """Blocks only this sequence references and nobody can match
        from the index — safe to scrub immediately on quarantine."""
        with self._lock:
            return [b for b in self._tables.get(seq_id, [])
                    if self._refs.get(b) == 1 and b not in self._meta]

    def table(self, seq_id) -> List[int]:
        with self._lock:
            return list(self._tables[seq_id])

    @property
    def sequences(self) -> List[Any]:
        with self._lock:
            return list(self._tables)

    def table_array(self, seq_ids: Sequence[Any],
                    width: int) -> np.ndarray:
        """The batch's block tables as one right-padded ``(len(seq_ids),
        width)`` int32 array — padding points at the trash block."""
        out = np.full((len(seq_ids), int(width)), TRASH_BLOCK, np.int32)
        with self._lock:
            for i, sid in enumerate(seq_ids):
                t = self._tables[sid]
                if len(t) > width:
                    raise ValueError(
                        f"table width {width} < {len(t)} blocks of "
                        f"sequence {sid!r}")
                out[i, :len(t)] = t
        return out

    # -- handoff between engines --------------------------------------------

    @property
    def dtype_name(self) -> str:
        """The pool dtype's name as the reference's numpy payloads spell
        it (``"bfloat16"``, ``"float32"``): what a handoff manifest
        records, whatever array type carries the bytes."""
        return str(self.dtype).replace("torch.", "")

    def export_blocks(self, state: KVCacheState, seq_id, *,
                      length: Optional[int] = None
                      ) -> Tuple[List[int], np.ndarray, np.ndarray]:
        """A sequence's KV rows on the host: ``(blocks, k, v)`` with
        ``k``/``v`` ``(num_layers, n, block_size, kv_heads, head_dim)``.
        ``length`` bounds the export to the blocks that hold tokens;
        ``None`` exports the whole reservation. Read-only.

        numpy has no bfloat16, so a 16-bit pool (bf16 or fp16) exports
        as ``uint16`` views of the pool's bits: ``tobytes()`` is the
        reference's payload byte for byte, and :meth:`import_blocks`
        reinterprets the bits back (:attr:`dtype_name` names the
        dtype). Wider pools export their own dtype."""
        table = self.table(seq_id)
        if length is not None:
            table = table[:self.blocks_for(length)]
        idx = torch.as_tensor(table, dtype=torch.long, device=state.k.device)
        return (list(table), _host_payload(state.k[:, idx]),
                _host_payload(state.v[:, idx]))

    def import_blocks(self, state: KVCacheState, seq_id, k,
                      v) -> KVCacheState:
        """Write exported KV rows into an already-allocated ``seq_id``'s
        blocks (row block ``i`` lands in ``table[i]``), in place; the
        caller has verified the payload. A 16-bit payload (``uint16``
        bits, or a 16-bit float array) into a 16-bit pool is
        reinterpreted bit for bit, never cast by value; any other payload
        is cast to the pool's dtype."""
        table = self.table(seq_id)
        k = _pool_payload(k, state.k.dtype)
        v = _pool_payload(v, state.v.dtype)
        n = k.shape[1]
        if n > len(table):
            raise ValueError(
                f"import_blocks: payload holds {n} blocks but sequence "
                f"{seq_id!r} reserves only {len(table)}")
        idx = torch.as_tensor(table[:n], dtype=torch.long,
                              device=state.k.device)
        state.k[:, idx] = k.to(state.k.device, state.k.dtype)
        state.v[:, idx] = v.to(state.v.device, state.v.dtype)
        return state


_BITS16 = (torch.bfloat16, torch.float16)


def _host_payload(t: torch.Tensor) -> np.ndarray:
    """A pool slice on the host: ``uint16`` bits for a 16-bit float
    pool (numpy cannot hold bfloat16), else its own dtype."""
    if t.dtype in _BITS16:
        return t.view(torch.int16).cpu().numpy().view(np.uint16)
    return t.cpu().numpy()


def _pool_payload(a, dtype: torch.dtype) -> torch.Tensor:
    """A host payload as a CPU tensor ready for a ``dtype`` pool: for a
    16-bit pool, 16-bit integer bits (what :func:`_host_payload` gives)
    or an array of the pool's own dtype (the reference's bfloat16
    arrays) reinterpreted bit for bit; anything else by value."""
    a = np.ascontiguousarray(np.asarray(a))
    if not a.flags.writeable:
        a = a.copy()
    name = str(dtype).replace("torch.", "")
    if dtype in _BITS16 and a.dtype.itemsize == 2 and (
            a.dtype.kind in "iu" or a.dtype.name == name):
        return torch.from_numpy(a.view(np.int16)).view(dtype)
    return torch.as_tensor(a)


# ---------------------------------------------------------------------------
# Device pool ops (what the prefill/decode steps call)
# ---------------------------------------------------------------------------


def _long(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).long()


def gather_kv(state: KVCacheState, tables):
    """Gather each sequence's blocks into contiguous per-batch views.

    ``tables`` (batch, width) -> two ``(num_layers, batch, kv_heads,
    width * block_size, head_dim)`` tensors. Pure data movement: the
    bytes written by :func:`append_kv` come back bitwise. Unallocated
    table entries gather the trash block; the attention mask drops
    them."""
    tables = _long(tables, state.k.device)

    def one(pool):
        g = pool[:, tables]            # (L, b, w, bs, kv, d)
        layers, b, w, bs, kv, d = g.shape
        return g.permute(0, 1, 4, 2, 3, 5).reshape(layers, b, kv, w * bs, d)
    return one(state.k), one(state.v)


def append_kv(state: KVCacheState, k_new, v_new, tables,
              positions) -> KVCacheState:
    """Write one token's K/V per sequence into the pool in place.

    ``k_new``/``v_new`` (num_layers, batch, kv_heads, head_dim);
    ``positions`` (batch,) the 0-based slot each token lands in. Rows
    whose table entry is the trash block (dummy batch rows) write into
    it harmlessly."""
    dev = state.k.device
    tables = _long(tables, dev)
    positions = _long(positions, dev)
    bs = state.k.shape[2]
    w = tables.shape[1]
    blk = torch.gather(
        tables, 1, torch.clamp(positions[:, None] // bs, 0, w - 1))[:, 0]
    slot = positions % bs
    state.k[:, blk, slot] = k_new.to(state.k.dtype)
    state.v[:, blk, slot] = v_new.to(state.v.dtype)
    return state


def append_kv_prefill(state: KVCacheState, k_new, v_new, tables,
                      lengths) -> KVCacheState:
    """Write whole right-padded prompts' K/V ``(num_layers, batch,
    kv_heads, seq, head_dim)`` in place; rows ``>= lengths`` land in the
    trash block."""
    return append_kv_chunk(state, k_new, v_new, tables, None, lengths)


def append_kv_chunk(state: KVCacheState, k_new, v_new, tables, starts,
                    lengths) -> KVCacheState:
    """Write one prefill chunk's K/V per sequence in place: chunk row
    ``i`` of sequence ``b`` lands at position ``starts[b] + i``
    (``starts=None`` means 0); rows ``i >= lengths[b]`` (padding) land
    in the trash block."""
    dev = state.k.device
    tables = _long(tables, dev)
    lengths = _long(lengths, dev)
    bs = state.k.shape[2]
    b, w = tables.shape
    s = k_new.shape[3]
    pos = torch.arange(s, device=dev)[None, :].expand(b, s)
    valid = pos < lengths[:, None]
    if starts is not None:
        pos = pos + _long(starts, dev)[:, None]
    blk = torch.gather(tables, 1, torch.clamp(pos // bs, 0, w - 1))
    blk = torch.where(valid, blk, TRASH_BLOCK)
    slot = pos % bs
    # (L, b, kv, s, d) -> (L, b, s, kv, d) to match pool[:, blk, slot]
    state.k[:, blk, slot] = k_new.permute(0, 1, 3, 2, 4).to(state.k.dtype)
    state.v[:, blk, slot] = v_new.permute(0, 1, 3, 2, 4).to(state.v.dtype)
    return state


def apply_copies(state: KVCacheState,
                 copies: Sequence[Tuple[int, int, int]]) -> KVCacheState:
    """Execute COW fork row copies ``(src_block, dst_block, rows)`` in
    place: the first ``rows`` rows of ``src`` — the common prefix with
    the divergence block — go into the fresh private ``dst``; the shared
    source is never written."""
    for src, dst, rows in copies:
        rows = int(rows)
        for pool in (state.k, state.v):
            pool[:, int(dst), :rows] = pool[:, int(src), :rows]
    return state


def scrub_blocks(state: KVCacheState, blocks) -> KVCacheState:
    """Zero the named pool blocks in place (a freed block must never
    hand a NaN row to its next tenant)."""
    if len(blocks) == 0:
        return state
    idx = torch.as_tensor(sorted(int(x) for x in blocks), dtype=torch.long,
                          device=state.k.device)
    state.k[:, idx] = 0
    state.v[:, idx] = 0
    return state


__all__ = [
    "KVCache",
    "KVCacheState",
    "PoolExhausted",
    "PrefixMatch",
    "TRASH_BLOCK",
    "append_kv",
    "append_kv_chunk",
    "append_kv_prefill",
    "apply_copies",
    "gather_kv",
    "scrub_blocks",
]
