"""Durable JSON records: ``write_record`` and its readers.

Counterpart of the part of ``apex_tpu/records.py`` the telemetry planes
need: :func:`write_record` (one dated, git-stamped JSON file under
:data:`RECORDS_DIR`, claimed with ``O_CREAT|O_EXCL``, fsync'd, then its
directory fsync'd), :func:`latest_record` and :func:`prune_records`
(the flight recorder's keep-last-k retention). Transient disk errors
get three short retries through
:func:`apex_tpu_torch.resilience.retry.retry_call` (site
``record_write``) before the write gives up.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Any, Dict, Optional

RECORDS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "bench_records")


def _git_sha() -> str:
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(RECORDS_DIR), capture_output=True,
            text=True, timeout=10).stdout.strip() or "unknown"
    except Exception:  # noqa: BLE001 — records must never break a bench
        return "unknown"


def write_record(kind: str, payload: Dict[str, Any]) -> Optional[str]:
    """Persist one record of ``kind`` under :data:`RECORDS_DIR`.

    Returns the written path, or None if persistence failed (never
    raises: a failed disk write must not kill the run that records).

    The filename stamp has 1-second resolution, so same-second writes
    collide: the name is claimed with ``O_CREAT|O_EXCL`` and collisions
    fall back to a ``time.monotonic_ns()`` disambiguator, strictly
    increasing, so ``latest_record``'s tiebreak orders same-second
    records by write order. The content is ``fsync``'d and then the
    directory is ``fsync``'d (site ``record_fsync``): the claim is a
    directory entry, and a crash right after the write could otherwise
    lose it. Transient disk errors get three short retries; a failed
    attempt unlinks its claim.
    """
    try:
        stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        rec = {
            "kind": kind,
            "utc": stamp,
            "git_sha": _git_sha(),
            "payload": payload,
        }
        base = f"{kind}_{stamp}_{rec['git_sha']}"
        body = json.dumps(rec, indent=1, sort_keys=True)

        def attempt() -> str:
            from apex_tpu_torch.resilience import faults

            faults.check("record_write")
            os.makedirs(RECORDS_DIR, exist_ok=True)
            path = os.path.join(RECORDS_DIR, f"{base}.json")
            while True:
                try:
                    fd = os.open(path,
                                 os.O_CREAT | os.O_EXCL | os.O_WRONLY,
                                 0o644)
                    break
                except FileExistsError:
                    path = os.path.join(
                        RECORDS_DIR,
                        f"{base}.{time.monotonic_ns()}.json")
            try:
                with os.fdopen(fd, "w") as f:
                    f.write(body)
                    f.flush()
                    os.fsync(f.fileno())
                # the claim is a directory entry: fsync the directory
                # too, or a crash right after this return can erase a
                # record the caller was told exists
                faults.check("record_fsync")
                dfd = os.open(RECORDS_DIR, os.O_RDONLY)
                try:
                    os.fsync(dfd)
                finally:
                    os.close(dfd)
            except BaseException:
                try:
                    os.unlink(path)      # never leave a truncated claim
                except OSError:
                    pass
                raise
            return path

        from apex_tpu_torch.resilience.retry import retry_call

        return retry_call(attempt, retries=3, base_delay=0.02,
                          max_delay=0.25, deadline=2.0,
                          retry_on=(OSError,), site="record_write")
    except Exception:  # noqa: BLE001
        return None


def _uniquifier(name: str) -> int:
    # "kind_stamp_sha.3.json" -> 3; "kind_stamp_sha.json" -> 0.
    parts = name[:-len(".json")].rsplit(".", 1)
    return int(parts[1]) if len(parts) == 2 and parts[1].isdigit() else 0


def prune_records(kind: str, keep: int) -> list:
    """Keep only the newest ``keep`` records of ``kind``; returns the
    removed paths. Never raises.

    Retention for record kinds that a failure loop can write without
    bound — the flight recorder's ``flightrec`` bundles are the
    motivating case (a crash-looping process dumps one black box per
    crash; without pruning it fills the disk that the NEXT checkpoint
    needs). Ordering matches :func:`latest_record`'s recency rule
    (record ``utc``, filename uniquifier as the same-second tiebreak),
    kind-matching matches its ``kind``-field rule, and
    corrupt files are left in place (``latest_record`` already names
    them via ``record_corrupt_skipped`` — deleting evidence of disk
    trouble during disk trouble helps nobody). ``keep <= 0`` prunes
    nothing (the checkpoint manager's retention convention).

    Records stamped in the CURRENT second are never pruned: deleting
    one frees its ``O_CREAT|O_EXCL`` claim name, and a same-second
    writer would re-claim it with the bare (uniquifier-0) name —
    sorting BELOW its older same-second siblings and breaking
    ``latest_record``'s write-order tiebreak. One second later the
    stamp is unreachable and the record prunable, so a crash loop is
    still bounded at ``keep`` plus the current second's writes.
    """
    removed: list = []
    if keep <= 0:
        return removed
    now_stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
    try:
        names = [n for n in os.listdir(RECORDS_DIR)
                 if n.startswith(f"{kind}_") and n.endswith(".json")]
    except OSError:
        return removed
    matches = []
    for name in names:
        path = os.path.join(RECORDS_DIR, name)
        try:
            with open(path) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            continue
        if rec.get("kind") != kind:
            continue
        matches.append((str(rec.get("utc", "")), _uniquifier(name), path))
    matches.sort()
    for utc, _, path in matches[:-keep]:
        if utc == now_stamp:
            continue
        try:
            os.unlink(path)
        except OSError:
            continue
        removed.append(path)
    return removed


def latest_record(kind: str) -> Optional[Dict[str, Any]]:
    """Newest record of ``kind``, or None when there is none.

    The kind is matched against the loaded record's ``kind`` field
    (never the filename, which would cross-match kinds that are
    prefixes of other kinds). Recency comes from the record's ``utc``
    field with the filename uniquifier as tiebreaker.
    """
    try:
        # filename prefix is a cheap pre-filter only (write_record names
        # files '{kind}_...'); the authoritative match is rec['kind']
        # below, so prefix-of-another-kind files just parse and drop out
        names = [n for n in os.listdir(RECORDS_DIR)
                 if n.startswith(f"{kind}_") and n.endswith(".json")]
    except OSError:
        return None
    matches = []
    for name in names:
        try:
            with open(os.path.join(RECORDS_DIR, name)) as f:
                rec = json.load(f)
        except (OSError, ValueError) as e:
            # corrupt/unreadable record files are skipped, but never
            # silently: a structured telemetry event + counter names
            # each one once per lookup (the bench-record analog of
            # latest_valid's corrupt_checkpoint record)
            try:
                from apex_tpu_torch.telemetry import metrics as _metrics

                reg = _metrics.registry()
                reg.counter("records_corrupt_skipped",
                            "unreadable bench_records files skipped by "
                            "latest_record").inc()
                reg.event("record_corrupt_skipped", file=name,
                          kind=kind, error=f"{type(e).__name__}: {e}")
            except Exception:  # noqa: BLE001 — lookup must never fail
                pass
            continue
        if rec.get("kind") != kind:
            continue
        matches.append((str(rec.get("utc", "")), _uniquifier(name), rec))
    if not matches:
        return None
    return max(matches, key=lambda t: t[:2])[2]


__all__ = ["write_record", "latest_record", "prune_records",
           "RECORDS_DIR"]
