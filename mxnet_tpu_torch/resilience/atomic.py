"""Crash-consistent host-side file writes (a copy of
mxnet_tpu/resilience/atomic.py's `atomic_write` and `exclusive_create`).

The bytes land in a temp file in the *same directory* (same filesystem,
so the rename cannot degrade to copy+delete) and `os.replace` swings the
name atomically: a process killed mid-save leaves either the old complete
file or the new one, never a truncated blob.
"""
from __future__ import annotations

import contextlib
import os
import tempfile

__all__ = ["atomic_write", "exclusive_create"]


@contextlib.contextmanager
def atomic_write(path, mode="wb"):
    """Context manager yielding a file object; on clean exit the data is
    fsynced and atomically renamed onto `path`. On error the temp file
    is removed and `path` is untouched."""
    path = os.fspath(path)
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(
        prefix=os.path.basename(path) + ".tmp.", dir=directory)
    try:
        with os.fdopen(fd, mode) as f:
            yield f
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def exclusive_create(path, data):
    """Atomically create `path` with `data` iff it does not already
    exist (O_CREAT|O_EXCL — the lease-acquire primitive: on a local
    filesystem exactly one of N racing processes wins the create).
    Returns True on success, False when the path already exists. A
    write failure after a successful create removes the file before
    re-raising, so a failed acquire never leaves a husk that blocks
    every later one."""
    path = os.fspath(path)
    try:
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o644)
    except FileExistsError:
        return False
    try:
        if isinstance(data, str):
            data = data.encode("utf-8")
        os.write(fd, data)
        os.fsync(fd)
    except BaseException:
        os.close(fd)
        try:
            os.unlink(path)
        except OSError:
            pass
        raise
    os.close(fd)
    return True
