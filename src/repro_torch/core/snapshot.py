"""Crash-safe versioned snapshots of the database's warm state.

A snapshot is a single file::

    MAGIC (8B) | version (4B LE) | sha256(payload) (32B) | pickle payload

written with the classic tmp-file + ``fsync`` + atomic ``os.rename``
dance, so a crash mid-write can never corrupt the previous snapshot.
Files are named ``warm-<seq:08d>.snap``; loaders walk them newest-first
and fall back to the next-older file (ultimately a clean cold start)
whenever the magic, version, or checksum fails validation.

The payload itself is a plain dict assembled by ``IPDB.save_snapshot``
(prompt-cache entries, statistics-store export, radix prefix-cache KV
pages); this module knows nothing about its schema beyond "picklable".
"""
from __future__ import annotations

import hashlib
import os
import pickle
import tempfile
from typing import Any, List, Optional, Tuple

MAGIC = b"IPDBSNAP"
VERSION = 1
_HEADER = len(MAGIC) + 4 + 32


class SnapshotError(RuntimeError):
    """Snapshot failed validation (magic / version / checksum)."""


def _encode(payload: Any) -> bytes:
    body = pickle.dumps(payload, protocol=pickle.HIGHEST_PROTOCOL)
    digest = hashlib.sha256(body).digest()
    return MAGIC + VERSION.to_bytes(4, "little") + digest + body


def _decode(blob: bytes) -> Any:
    if len(blob) < _HEADER or blob[: len(MAGIC)] != MAGIC:
        raise SnapshotError("bad magic")
    ver = int.from_bytes(blob[len(MAGIC): len(MAGIC) + 4], "little")
    if ver != VERSION:
        raise SnapshotError(f"unsupported snapshot version {ver}")
    digest = blob[len(MAGIC) + 4: _HEADER]
    body = blob[_HEADER:]
    if hashlib.sha256(body).digest() != digest:
        raise SnapshotError("checksum mismatch")
    return pickle.loads(body)


def snapshot_files(snapshot_dir: str) -> List[str]:
    """Snapshot paths in the directory, newest (highest seq) first."""
    try:
        names = os.listdir(snapshot_dir)
    except OSError:
        return []
    snaps = sorted(n for n in names
                   if n.startswith("warm-") and n.endswith(".snap"))
    return [os.path.join(snapshot_dir, n) for n in reversed(snaps)]


def write_snapshot(snapshot_dir: str, payload: Any, *,
                   keep: int = 3) -> str:
    """Atomically write a new versioned snapshot; prune to ``keep`` files."""
    os.makedirs(snapshot_dir, exist_ok=True)
    existing = snapshot_files(snapshot_dir)
    seq = 0
    if existing:
        try:
            seq = int(os.path.basename(existing[0])[5:-5]) + 1
        except ValueError:
            seq = len(existing)
    path = os.path.join(snapshot_dir, f"warm-{seq:08d}.snap")
    blob = _encode(payload)
    fd, tmp = tempfile.mkstemp(dir=snapshot_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.rename(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    for old in snapshot_files(snapshot_dir)[max(1, keep):]:
        try:
            os.unlink(old)
        except OSError:
            pass
    return path


def load_latest(snapshot_dir: str
                ) -> Tuple[Optional[Any], Optional[str], List[str]]:
    """Load the newest valid snapshot.

    Returns ``(payload, path, skipped)`` where ``skipped`` lists files
    that failed validation (corrupt / truncated / foreign) and were
    passed over.  ``(None, None, skipped)`` means cold start.
    """
    skipped: List[str] = []
    for path in snapshot_files(snapshot_dir):
        try:
            with open(path, "rb") as f:
                return _decode(f.read()), path, skipped
        except (SnapshotError, OSError, pickle.UnpicklingError,
                EOFError, AttributeError, ImportError):
            skipped.append(path)
    return None, None, skipped
