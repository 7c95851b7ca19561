"""Durable small-file IO shared by the checkpoint engine, heartbeat and

Ports ``deepspeed_tpu/utils/fileio.py`` (host Python; the port keeps its own
copy and imports nothing of the JAX package).
elastic agent: JSON written via temp + (optional fsync) + atomic rename, so
a crash at any byte leaves either the old file or the new one, never a
torn read for whoever polls it."""

from __future__ import annotations

import json
import os
from typing import Any, Optional


def fsync_dir(path: str) -> None:
    """Durably record a directory entry (a rename itself). Best-effort:
    some filesystems refuse O_RDONLY dir fds."""
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:  # pragma: no cover - fs-dependent
        pass


def write_json_atomic(path: str, obj: Any, fsync: bool = False,
                      indent: Optional[int] = None) -> None:
    """Write JSON via temp + rename. ``fsync=True`` for commit-protocol
    files that must survive power loss; False for liveness files where
    write latency matters more than durability."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(obj, f, indent=indent, default=str)
        if fsync:
            f.flush()
            os.fsync(f.fileno())
    os.replace(tmp, path)
