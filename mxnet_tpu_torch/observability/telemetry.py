"""The JSONL telemetry stream (a copy of the part of
mxnet_tpu/observability/telemetry.py that the checkpoint needs:
`stream_path` :97, `emit` :135). With
``MXTPU_TELEMETRY=<path>`` set, `emit` appends one JSON object a line,
keys sorted, in the JAX package's record schema (the checkpoint's
``{"ts", "source": "resilience", "event": "ckpt_commit", "step",
"step_time"}``), so `tools/telemetry_report.py` reads either package's
stream. The step timer, the compile listener and the rest are not
ported yet (ROADMAP A9).
"""
from __future__ import annotations

import json
import os
import threading
import warnings

__all__ = ["emit", "stream_path"]

_lock = threading.Lock()
_stream = {"path": None, "file": None, "warned": False}


def stream_path():
    """The ``MXTPU_TELEMETRY`` destination, or None."""
    return os.environ.get("MXTPU_TELEMETRY") or None


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

