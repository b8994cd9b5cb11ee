"""Crash-consistent host-side file writes (a copy of
mxnet_tpu/resilience/atomic.py's `atomic_write`).

The bytes land in a temp file in the *same directory* (same filesystem,
so the rename cannot degrade to copy+delete) and `os.replace` swings the
name atomically: a process killed mid-save leaves either the old complete
file or the new one, never a truncated blob.
"""
from __future__ import annotations

import contextlib
import os
import tempfile

__all__ = ["atomic_write"]


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
