"""Serving resilience: drain snapshots, resume, and live weight swap.

Counterpart of ``apex_tpu/serving/resilience.py`` (the scheduler side is
in ``serving/scheduler.py``):

- **drain snapshots** — :func:`save_snapshot` persists every queued and
  in-flight request (prompt, generated-so-far tokens, deadline,
  sampling knobs and seed, trace id) as one sha256-manifested JSON
  committed through ``resilience.checkpoint.atomic_write_files``
  (tmp -> fsync -> rename). ``SNAPSHOT_FORMAT`` 1, the same payload and
  manifest as the reference's, so a snapshot written by either package
  resumes in the other. :func:`resume_requests` rebuilds the requests
  (each in-flight one re-prefills prompt + generated) and
  :func:`merge_results` stitches the generated prefixes back on.
  :func:`latest_snapshot` skips a snapshot that does not verify.
- **the non-finite drill** — :func:`poison_lane_kv` writes NaN rows in
  place into the cache pools, so the lane's logits go non-finite through
  the real attention kernel.
- **weight identity and swap** — :func:`params_signature`,
  :func:`params_digest` and :func:`params_fingerprint` run over a
  ``state_dict()`` in its own order (the port's parameter names; the
  reference's tree paths cannot be shared). :func:`swap_weights`
  validates a replacement state dict against the serving model's and
  stages it; the engine copies it into the model's parameters at its
  next step boundary. A mismatch raises :class:`WeightSwapError` with
  the structured per-leaf list and leaves the engine untouched.

The reference's goodput-ledger hooks wait for the ledger's port: a
snapshot carries no ``goodput`` key, as the reference's carries none
when no ledger is armed.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from apex_tpu_torch.resilience import faults
from apex_tpu_torch.resilience.checkpoint import atomic_write_files

SNAPSHOT_FORMAT = 1
SNAPSHOT_FILE = "snapshot.json"
SNAPSHOT_MANIFEST = "manifest.json"
_SNAP_RE = re.compile(r"^serving_(\d{12})$")


class SnapshotError(RuntimeError):
    """Unusable serving snapshot (missing, corrupt, or wrong format)."""


class WeightSwapError(RuntimeError):
    """A rejected weight hot-swap. ``mismatches`` is the structured
    per-leaf diff: ``[{"path", "expected", "got"}, ...]`` — shapes/
    dtypes/tree paths that disagree with the serving model's current
    signature (or the fingerprint row that failed)."""

    def __init__(self, msg: str, mismatches: List[Dict[str, Any]]):
        super().__init__(msg)
        self.mismatches = list(mismatches)


# ---------------------------------------------------------------------------
# Drain snapshots
# ---------------------------------------------------------------------------


def snapshot_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"serving_{int(step):012d}")


def save_snapshot(batcher, directory: str, *, step: int,
                  reason: str = "preemption") -> str:
    """Persist every queued + in-flight request of ``batcher`` as one
    atomic snapshot directory; returns the final path.

    The payload is JSON (request ids must be JSON-serializable —
    anything else cannot survive a process death anyway) with a sha256
    manifest; the write goes through the checkpoint discipline
    (tmp→fsync→rename), so a crash mid-drain leaves either nothing or
    a snapshot that verifies. The ``serving_snapshot_corrupt=<idx>``
    fault clause truncates the FINALIZED payload — exactly what
    :func:`latest_snapshot` must refuse.
    """
    entries = batcher._snapshot_entries()
    payload = {
        "format": SNAPSHOT_FORMAT,
        "step": int(step),
        "reason": str(reason),
        "utc": time.strftime("%Y%m%dT%H%M%SZ", time.gmtime()),
        "requests": entries,
    }
    data = json.dumps(payload, sort_keys=True).encode()
    manifest = {
        "format": SNAPSHOT_FORMAT,
        "step": int(step),
        "payload_bytes": len(data),
        "sha256": hashlib.sha256(data).hexdigest(),
        "n_requests": len(entries),
    }
    os.makedirs(directory, exist_ok=True)
    final = snapshot_path(directory, step)
    faults.check("serving_snapshot")
    atomic_write_files(final, {
        SNAPSHOT_FILE: data,
        SNAPSHOT_MANIFEST: json.dumps(manifest, indent=1,
                                      sort_keys=True).encode(),
    })
    idx = batcher._snapshot_count
    batcher._snapshot_count += 1
    if faults.should_snapshot_corrupt(idx):
        # simulated on-disk corruption of the FINALIZED snapshot
        with open(os.path.join(final, SNAPSHOT_FILE), "r+b") as f:
            f.truncate(max(1, len(data) // 2))
    reg = batcher._registry
    reg.counter("serving_snapshots",
                "serving drain snapshots committed").inc()
    reg.event("serving_snapshot_saved", path=final, step=int(step),
              n_requests=len(entries), reason=str(reason))
    return final


def validate_snapshot(path: str) -> Tuple[bool, str]:
    """(ok, reason): re-hash the payload against the manifest, so
    truncation/corruption is detected before a byte is parsed."""
    try:
        with open(os.path.join(path, SNAPSHOT_MANIFEST)) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        return False, f"manifest unreadable: {type(e).__name__}"
    if manifest.get("format") != SNAPSHOT_FORMAT:
        return False, f"unsupported format {manifest.get('format')!r}"
    ppath = os.path.join(path, SNAPSHOT_FILE)
    try:
        size = os.path.getsize(ppath)
    except OSError:
        return False, "payload missing"
    if size != manifest.get("payload_bytes"):
        return False, (f"payload truncated: {size} bytes, manifest says "
                       f"{manifest.get('payload_bytes')}")
    h = hashlib.sha256()
    try:
        with open(ppath, "rb") as f:
            h.update(f.read())
    except OSError as e:
        return False, f"payload unreadable: {type(e).__name__}"
    if h.hexdigest() != manifest.get("sha256"):
        return False, "sha256 mismatch"
    return True, ""


def load_snapshot(path: str) -> Dict[str, Any]:
    """Parse a snapshot that :func:`validate_snapshot` accepts; raises
    :class:`SnapshotError` otherwise — a rotten snapshot must never be
    resumed."""
    ok, reason = validate_snapshot(path)
    if not ok:
        raise SnapshotError(f"{path}: {reason}")
    with open(os.path.join(path, SNAPSHOT_FILE)) as f:
        return json.load(f)


def latest_snapshot(directory: str, *,
                    record_events: bool = True) -> Optional[str]:
    """Newest snapshot under ``directory`` that verifies, scanning
    newest -> oldest; corrupt ones are reported (counter
    ``serving_snapshot_corrupt_skipped`` + event) and skipped — the
    ``latest_valid()`` contract for the serving tier."""
    try:
        names = os.listdir(directory)
    except OSError:
        return None
    steps = sorted(int(m.group(1)) for m in map(_SNAP_RE.match, names)
                   if m)
    for step in reversed(steps):
        path = snapshot_path(directory, step)
        ok, reason = validate_snapshot(path)
        if ok:
            return path
        if record_events:
            from apex_tpu_torch.telemetry import metrics as _metrics

            reg = _metrics.registry()
            reg.counter("serving_snapshot_corrupt_skipped",
                        "corrupt serving snapshots skipped by "
                        "latest_snapshot").inc()
            reg.event("corrupt_serving_snapshot", path=path, step=step,
                      reason=reason)
    return None


def resume_requests(snapshot: Dict[str, Any]):
    """Rebuild the requests a drained engine owed from a snapshot
    payload; returns ``(requests, prior)``.

    In-flight entries resume through the EXISTING prefill path: the
    replay prompt is ``prompt + generated`` (reconstructing the cache
    the dead engine held, bit-for-bit the same K/V the prefill scatter
    writes) and ``max_new_tokens`` shrinks by what was already
    generated, so the resumed engine's first emitted token is exactly
    the next one the uninterrupted run would have produced — for
    SAMPLED streams too: the per-request RNG is counter-based
    (``fold_in(seed, token index)``, serving/decode.py), and the
    snapshot carries the sampling knobs + seed, so the resumed
    engine's draws continue the stream token for token. ``prior``
    maps request id -> the already-generated prefix;
    :func:`merge_results` folds it back so callers see full token
    streams.

    The request plane rides along: each entry's persisted ``trace_id``
    is handed back on the rebuilt request with ``resumed_from`` naming
    the snapshot, so a traced resumed engine CONTINUES the same trace
    (serving/tracing.py) instead of minting a fresh one.
    """
    from apex_tpu_torch.serving.scheduler import Request

    if snapshot.get("format") != SNAPSHOT_FORMAT:
        raise SnapshotError(
            f"unsupported snapshot format {snapshot.get('format')!r}")
    origin = f"serving_{int(snapshot.get('step', 0)):012d}"
    requests: List[Request] = []
    prior: Dict[Any, List[int]] = {}
    for e in snapshot.get("requests", []):
        generated = [int(t) for t in e.get("generated", [])]
        prompt = [int(t) for t in e["prompt"]] + generated
        remaining = int(e["max_new_tokens"]) - len(generated)
        if remaining < 1:          # finished at the snapshot boundary
            continue
        requests.append(Request(
            id=e["id"], prompt=prompt, max_new_tokens=remaining,
            eos_id=e.get("eos_id"), deadline_ms=e.get("deadline_ms"),
            temperature=float(e.get("temperature", 0.0)),
            top_k=int(e.get("top_k", 0)),
            top_p=float(e.get("top_p", 1.0)),
            seed=int(e.get("seed", 0)),
            trace_id=e.get("trace_id"),
            resumed_from=origin))
        prior[e["id"]] = generated
    return requests, prior


def merge_results(results, prior: Dict[Any, List[int]]):
    """Stitch the snapshotted prefixes back onto resumed results: each
    result's ``tokens`` becomes ``prior[id] + tokens`` (ids absent from
    ``prior`` pass through), so the caller-visible stream matches the
    uninterrupted run token for token."""
    import dataclasses

    out = []
    for r in results:
        pre = prior.get(r.id)
        if pre:
            r = dataclasses.replace(r, tokens=list(pre) + list(r.tokens))
        out.append(r)
    return out


# ---------------------------------------------------------------------------
# The decode_nonfinite drill site
# ---------------------------------------------------------------------------


def poison_lane_kv(state, cache, seq_id, position: int):
    """Overwrite one cached K/V row of ``seq_id`` at ``position`` with
    NaN, in place, between dispatches (the serving analog of poisoning
    gradients). The next decode of that lane attends the row, so its
    logits come out non-finite through the real attention path and the
    per-lane finite flag names it."""
    table = cache.table(seq_id)
    bs = cache.block_size
    blk = table[int(position) // bs]
    slot = int(position) % bs
    state.k[:, blk, slot] = float("nan")
    state.v[:, blk, slot] = float("nan")
    return state


# ---------------------------------------------------------------------------
# Live weight hot-swap
# ---------------------------------------------------------------------------


def _leaves(params) -> List[Tuple[str, Any]]:
    """``(name, tensor)`` pairs of a module's ``state_dict()`` or of a
    state dict, in its own order."""
    sd = params.state_dict() if hasattr(params, "state_dict") else params
    return list(sd.items())


def _dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


def _host_bytes(t) -> np.ndarray:
    """The raw bytes of a tensor as a host uint8 array."""
    return (t.detach().reshape(-1).contiguous().view(torch.uint8)
            .cpu().numpy())


def params_signature(params) -> List[Tuple[str, Tuple[int, ...], str]]:
    """The serving model's signature: ``(name, shape, dtype)`` per
    ``state_dict()`` entry, in its order — what a swapped replacement
    must match exactly (values free)."""
    return [(name, tuple(t.shape), _dtype_name(t))
            for name, t in _leaves(params)]


def params_digest(params) -> str:
    """sha256 over every entry's name, shape, dtype and raw bytes in
    ``state_dict()`` order — the weight identity the
    ``serving_weight_swap`` event carries."""
    h = hashlib.sha256()
    for name, t in _leaves(params):
        h.update(name.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(_dtype_name(t).encode())
        h.update(_host_bytes(t).tobytes())
    return h.hexdigest()


def params_fingerprint(params) -> np.ndarray:
    """Per-entry uint32 checksums in ``state_dict()`` order: each
    entry's bytes read as uint32 words (zero-padded) and summed mod
    2^32, the reference's per-leaf reduction."""
    sums = []
    for _, t in _leaves(params):
        raw = _host_bytes(t)
        pad = (-raw.size) % 4
        if pad:
            raw = np.concatenate([raw, np.zeros(pad, np.uint8)])
        words = raw.view(np.uint32).astype(np.uint64)
        sums.append(int(words.sum() % (1 << 32)))
    return np.asarray(sums, np.uint32)


def swap_weights(batcher, new_params, *,
                 expect_fingerprint=None) -> Dict[str, Any]:
    """Validate ``new_params`` (a state dict, or a module) against the
    engine's model and stage it; the engine copies it into the model's
    parameters at its next step boundary, between decode dispatches, so
    no in-flight request is dropped (its cached K/V from the old weights
    stays; generation continues under the new ones). Returns
    ``{"old_digest", "new_digest", "step"}``.

    A name, shape or dtype mismatch against :func:`params_signature`
    (or, with ``expect_fingerprint``, a checksum row that disagrees)
    raises :class:`WeightSwapError` listing every offending entry,
    counts ``serving_weight_swap_rejected`` and dumps a
    ``serving_weight_swap`` flight bundle; the engine is untouched. The
    ``weight_swap_mismatch=<idx>`` clause forces this path.

    The tensors are cloned first, so what is validated and digested is
    what gets installed even if the caller goes on writing to its own
    (a trainer staging its live ``state_dict()``): the reference's
    arrays are immutable, and the clone keeps that contract."""
    from apex_tpu_torch.telemetry import flight as _flight

    if hasattr(new_params, "state_dict"):
        new_params = new_params.state_dict()
    new_params = {k: v.detach().clone() if torch.is_tensor(v) else v
                  for k, v in new_params.items()}
    reg = batcher._registry
    idx = batcher._swap_count
    batcher._swap_count += 1
    old_sig = params_signature(batcher.model)
    new_sig = params_signature(new_params)
    mismatches: List[Dict[str, Any]] = []
    if faults.should_weight_swap_mismatch(idx):
        mismatches.append({"path": "<injected>",
                           "expected": "matching signature",
                           "got": "weight_swap_mismatch fault"})
    old_by_path = dict((p, (s, d)) for p, s, d in old_sig)
    new_by_path = dict((p, (s, d)) for p, s, d in new_sig)
    for p, want in old_by_path.items():
        got = new_by_path.get(p)
        if got is None:
            mismatches.append({"path": p, "expected": list(want),
                               "got": "missing"})
        elif got != want:
            mismatches.append({"path": p, "expected": list(want),
                               "got": list(got)})
    for p in new_by_path:
        if p not in old_by_path:
            mismatches.append({"path": p, "expected": "absent",
                               "got": list(new_by_path[p])})
    if not mismatches and expect_fingerprint is not None:
        want = np.asarray(expect_fingerprint, np.uint32).reshape(-1)
        got = params_fingerprint(new_params)
        if want.shape != got.shape or not np.array_equal(want, got):
            bad = ([int(i) for i in np.nonzero(want != got)[0]]
                   if want.shape == got.shape else "shape")
            mismatches.append({"path": f"<fingerprint leaves {bad}>",
                               "expected": "manifest checksums",
                               "got": "different bits"})
    if mismatches:
        err = WeightSwapError(
            f"weight swap rejected: {len(mismatches)} leaf signature "
            f"mismatch(es), first at {mismatches[0]['path']!r}",
            mismatches)
        reg.counter("serving_weight_swap_rejected",
                    "hot-swaps refused by signature validation").inc()
        reg.event("serving_weight_swap_rejected",
                  n_mismatches=len(mismatches),
                  first=str(mismatches[0]["path"]))
        _flight.notify("serving_weight_swap", error=err, fleet=False,
                       extra={"rejected": True,
                              "mismatches": mismatches[:16]})
        raise err
    info = {"old_digest": params_digest(batcher.model),
            "new_digest": params_digest(new_params),
            "step": batcher.step_idx}
    batcher._stage_params(new_params, info)
    return info


__all__ = [
    "SNAPSHOT_FILE",
    "SNAPSHOT_FORMAT",
    "SNAPSHOT_MANIFEST",
    "SnapshotError",
    "WeightSwapError",
    "latest_snapshot",
    "load_snapshot",
    "merge_results",
    "params_digest",
    "params_fingerprint",
    "params_signature",
    "poison_lane_kv",
    "resume_requests",
    "save_snapshot",
    "snapshot_path",
    "swap_weights",
    "validate_snapshot",
]
