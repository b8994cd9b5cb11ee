"""Live introspection plane: ``/metricsz`` + ``/debugz`` over HTTP
(counterpart of mxnet_tpu/observability/httpz.py).

The gateway serves these routes in-process (serving/gateway); this
module is the shared snapshot builder plus a **standalone**
`ObservabilityServer` for processes that have no front door — training
ranks, the decode schedulers of an embedded server — so a stuck step
can be diagnosed with ``curl`` instead of a debugger:

    GET /metricsz   Prometheus text exposition of the process registry
    GET /debugz     JSON process snapshot: queue depths, resident
                    models, the memory ledger's section (per-model
                    bytes, top consumers, headroom, the CUDA
                    allocator's view) + goodput program costs, lease
                    holder, trace plane state, and every thread's
                    current stack
    GET /healthz    liveness

Processes opt in with ``MXTPU_METRICS_PORT=<base>`` (0, the default:
no socket, no thread, no cost): rank r binds ``base + r`` (one host
often runs the whole gang, so the base port alone would collide),
started lazily by `maybe_start`. A port passed to
`ObservabilityServer(port=...)` is bound as given, and port 0 is an
ephemeral port the OS picks (read it back from `.port`).
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time
import traceback
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..base import getenv
from .registry import REGISTRY
from . import trace as _trace

__all__ = ["ObservabilityServer", "debug_snapshot", "maybe_start",
           "thread_stacks"]

_BOOT = time.time()


def thread_stacks():
    """{thread name: [frame lines]} for every live thread — the
    "where is everyone stuck" half of /debugz (a wedged worker shows
    its exact blocking frame)."""
    names = {t.ident: t.name for t in threading.enumerate()}
    stacks = {}
    for ident, frame in sys._current_frames().items():
        name = names.get(ident, "thread-%d" % ident)
        stacks[name] = [ln.rstrip("\n") for ln in
                        traceback.format_stack(frame)][-8:]
    return stacks


def _counter_value(name):
    m = REGISTRY.get(name)
    return m.total() if m is not None and hasattr(m, "total") else 0


def debug_snapshot(extra=None):
    """The /debugz payload: one JSON-able dict of live process state.
    `extra` (the gateway passes admission queues, registry residency,
    decode slot occupancy) is merged in under its own keys."""
    from ..resilience import lease as _lease
    from . import goodput as _goodput
    from . import memory as _memory
    snap = {
        "pid": os.getpid(),
        "rank": _trace.current_rank(),
        "uptime_s": time.time() - _BOOT,
        "lease": _lease.held_state(),
        # the HBM ledger's /statusz section (docs/observability.md
        # "Memory ledger"): per-model resident bytes, ranked top
        # consumers, per-program working sets, headroom
        "memory": _memory.debug_section(),
        "goodput": {"costs": _goodput.costs_snapshot(),
                    "peak_flops": _goodput.peak_flops()},
        "compile": {
            "engine_builds": _counter_value("serving.engine.compiles"),
        },
        "labels_dropped": _counter_value("observability.labels.dropped"),
        "trace": _trace.trace_stats(),
        "metric_families": len(REGISTRY.metrics()),
        "threads": thread_stacks(),
    }
    if extra:
        snap.update(extra)
    return snap


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "mxtpu-obs"

    def log_message(self, fmt, *args):
        pass

    def _send(self, code, body, ctype):
        data = body.encode("utf-8")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        path = self.path.split("?", 1)[0]
        if path == "/metricsz":
            self._send(200, REGISTRY.to_prometheus(),
                       "text/plain; version=0.0.4")
        elif path == "/debugz":
            extra_fn = self.server.extra_fn
            extra = extra_fn() if extra_fn else None
            self._send(200, json.dumps(debug_snapshot(extra),
                                       default=str, sort_keys=True),
                       "application/json")
        elif path == "/healthz":
            self._send(200, json.dumps({"ok": True}),
                       "application/json")
        else:
            self._send(404, json.dumps({"error": "no route %r" % path}),
                       "application/json")


class _ObsHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr, handler, extra_fn):
        self.extra_fn = extra_fn
        super().__init__(addr, handler)


class ObservabilityServer:
    """Standalone /metricsz + /debugz endpoint for processes without a
    gateway (training ranks). `extra_fn`, when given, is called per
    /debugz request and merged into the snapshot."""

    def __init__(self, port=None, host="127.0.0.1", extra_fn=None):
        if port is not None:
            self._port = int(port)
        else:
            base = int(getenv("MXTPU_METRICS_PORT", 0))
            # one host usually runs every rank of a local gang: offset
            # the base port by rank so they don't fight over the bind
            self._port = base + _trace.current_rank() if base else 0
        self.host = host
        self._extra_fn = extra_fn
        self._httpd = None
        self._thread = None

    @property
    def port(self):
        return (self._httpd.server_address[1]
                if self._httpd is not None else self._port)

    @property
    def url(self):
        return "http://%s:%d" % (self.host, self.port)

    def start(self):
        if self._httpd is not None:
            return self
        self._httpd = _ObsHTTPServer((self.host, self._port), _Handler,
                                     self._extra_fn)
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="obs-http")
        self._thread.start()
        return self

    def close(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False


_singleton_lock = threading.Lock()
_singleton = {"server": None, "failed": False}


def maybe_start():
    """Start the process-wide ObservabilityServer once iff
    ``MXTPU_METRICS_PORT`` is set (>0) — idempotent, never raises (a
    port collision warns once and stands down; observability must not
    take down the process it observes)."""
    if not int(getenv("MXTPU_METRICS_PORT", 0)):
        return None
    with _singleton_lock:
        if _singleton["server"] is not None or _singleton["failed"]:
            return _singleton["server"]
        try:
            _singleton["server"] = ObservabilityServer().start()
        except OSError as err:
            _singleton["failed"] = True
            import warnings
            warnings.warn("MXTPU_METRICS_PORT: observability server "
                          "failed to bind (%s); live plane disabled "
                          "for this process" % err, RuntimeWarning)
            return None
        return _singleton["server"]
