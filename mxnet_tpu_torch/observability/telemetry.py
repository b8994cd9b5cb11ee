"""The JSONL telemetry stream (a copy of the part of
mxnet_tpu/observability/telemetry.py that the checkpoint needs:
`stream_path` :97, `emit` :135). With
``MXTPU_TELEMETRY=<path>`` set, `emit` appends one JSON object a line,
keys sorted, in the JAX package's record schema (the checkpoint's
``{"ts", "source": "resilience", "event": "ckpt_commit", "step",
"step_time"}``), so `tools/telemetry_report.py` reads either package's
stream. Also the producer/consumer attribution of batch pulls
(`mark_producer_thread` :79, `is_producer_thread` :88), and
`stream_enabled` (:103) and `close_stream` (:150) for the serving
records. The step timer, the compile listener and the rest are not
ported yet (ROADMAP A9).
"""
from __future__ import annotations

import json
import os
import threading
import warnings

__all__ = ["close_stream", "emit", "is_producer_thread",
           "mark_producer_thread", "stream_enabled", "stream_path"]

_lock = threading.Lock()
_thread_role = threading.local()


def mark_producer_thread():
    """Tag the calling thread as an input-pipeline producer (a prefetch
    worker): its batch pulls overlap the consumer's compute, so the
    iterators count them in ``io.batch_assemble.seconds``, not in the
    consumer's ``io.batch_wait.seconds``."""
    _thread_role.producer = True


def is_producer_thread():
    return getattr(_thread_role, "producer", False)
_stream = {"path": None, "file": None, "warned": False}


def stream_path():
    """The ``MXTPU_TELEMETRY`` destination, or None."""
    return os.environ.get("MXTPU_TELEMETRY") or None


def stream_enabled():
    return stream_path() is not None


def _stream_file():
    path = stream_path()
    if path is None:
        return None
    with _lock:
        if _stream["path"] != path or _stream["file"] is None:
            if _stream["file"] is not None:
                try:
                    _stream["file"].close()
                except OSError:
                    pass
                _stream["path"], _stream["file"] = None, None
            try:
                f = open(path, "a", buffering=1)
            except OSError as err:
                if not _stream["warned"]:
                    _stream["warned"] = True
                    warnings.warn("MXTPU_TELEMETRY=%s not writable (%s); "
                                  "records disabled" % (path, err),
                                  RuntimeWarning)
                return None
            _stream["path"], _stream["file"] = path, f
        return _stream["file"]


def emit(record):
    """Append one JSON object to the stream (False when it is unset or
    cannot be written). Never raises."""
    f = _stream_file()
    if f is None:
        return False
    line = json.dumps(record, sort_keys=True)
    try:
        with _lock:
            f.write(line + "\n")
    except (OSError, ValueError):
        return False
    return True


def close_stream():
    """Close the stream (the next `emit` reopens it in append mode)."""
    with _lock:
        if _stream["file"] is not None:
            try:
                _stream["file"].close()
            except OSError:
                pass
        _stream["path"], _stream["file"] = None, None
        _stream["warned"] = False
