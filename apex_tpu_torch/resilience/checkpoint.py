"""The checkpoint write discipline, as the serving snapshots use it.

Counterpart of ``atomic_write_files`` and ``fsync_dir`` in
``apex_tpu/resilience/checkpoint.py``; the checkpoint manager itself is
not ported yet.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Dict


def fsync_dir(path: str) -> None:
    """Best-effort fsync of a directory entry (the rename is not
    durable until its parent directory is)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_files(final: str, files: Dict[str, bytes], *,
                       fsync: bool = True) -> None:
    """Stage ``files`` (name -> bytes) into ``<final>.tmp-<pid>-<ns>``,
    fsync each file and the temp directory, then ``os.rename`` the
    directory into place (replacing any previous ``final``) and fsync
    the parent. A crash at any point leaves either the previous
    ``final`` untouched or a stale ``*.tmp-*`` directory no reader ever
    considers."""
    tmp = f"{final}.tmp-{os.getpid()}-{time.monotonic_ns()}"
    os.makedirs(tmp)
    try:
        for name, data in files.items():
            with open(os.path.join(tmp, name), "wb") as f:
                f.write(data)
                f.flush()
                if fsync:
                    os.fsync(f.fileno())
        if fsync:
            fsync_dir(tmp)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        if fsync:
            fsync_dir(os.path.dirname(final) or ".")
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


__all__ = ["atomic_write_files", "fsync_dir"]
