"""Gateway: the HTTP front door over the serving engines (a copy of
mxnet_tpu/serving/gateway/frontdoor.py over the port's servers: the same
routes, payloads, status codes and admission rules).

Every engine below this line (`InferenceEngine`, `DecodeEngine`,
`ModelServer`) is an in-process object serving one model; this module
adds the network boundary and the multi-tenancy. One threaded stdlib
HTTP server — no new dependencies — fronts a `ModelRegistry` of N
models:

    POST /v1/models/<name>:predict     {"inputs": ..., "priority": ...,
                                        "deadline_ms": ...}
    POST /v1/models/<name>:generate    {"tokens": [...], "stream": true,
                                        "max_new_tokens": ...}
                                       (chunked token streaming)
    GET  /v1/models                    registry + residency snapshot
    GET  /healthz                      process liveness + lease state
    GET  /readyz                       503 until every eager model's
                                       warmup finished

Admission is **priority-classed and deadline-aware**, not FIFO:

- three classes — ``interactive`` > ``batch`` > ``best_effort`` — each
  with its own bounded wait queue; compute slots (bounded by
  ``MXTPU_GATEWAY_CONCURRENCY``) are granted in strict class-priority
  order, so interactive traffic is never shed (or even queued) behind
  batch, and under overload best_effort's queue overflows first;
- ``deadline_ms`` parses into a `resilience.Deadline` that rides the
  whole path: a request whose deadline expires **while queued** is
  shed before any compute (HTTP 504), and past admission the same
  Deadline reaches the batcher/scheduler, which already honor it at
  batch/token granularity — this layer is wiring, not invention;
- a request for an evicted model triggers the registry's transparent
  reload; a `ServerClosed` raced from an in-progress eviction is
  retried once through the registry and otherwise surfaces as a 503
  **naming the evicted model** (`ServerClosed.server`).

The gateway holds the process-wide device lease while it runs when the
models it fronts live on a CUDA device (`device`, by default the
constructing thread's current context); a CPU gateway takes none unless
``MXTPU_LEASE=1``.

Chaos site ``gateway.admit`` fires on every admission attempt.
Telemetry: one ``source="gateway"`` JSONL record per request
(``event="request"`` with class/model/route/status/queue_s) and per
shed (``event="shed"``); the registry adds ``reload``/``evict``
events. Metrics: ``serving.gateway.{requests,shed,queue.depth}`` plus
the registry's ``reload``/``resident`` family.
"""
from __future__ import annotations

import json
import math
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ...base import MXNetError, getenv
from ...observability import httpz as _httpz
from ...observability import registry as _obs
from ...observability import telemetry as _telemetry
from ...observability import trace as _trace
from ...resilience import (Deadline, DeadlineExceeded, InjectedFailure,
                           InjectedFault, chaos_point)
from ...resilience import lease as _lease
from .. import health as _health
from ..batcher import RequestRejected, ServerClosed
from ..health import (BreakerOpen, DeviceUnreachable, NoHealthyReplica,
                      SchedulerCrashed)
from .registry import ModelRegistry

__all__ = ["Gateway", "PRIORITY_CLASSES"]

#: strict admission order: earlier classes are granted compute first
PRIORITY_CLASSES = ("interactive", "batch", "best_effort")

_REQUESTS = _obs.counter(
    "serving.gateway.requests",
    "requests served by the gateway (labels model, class)")
_SHED = _obs.counter(
    "serving.gateway.shed",
    "requests shed by the gateway before compute "
    "(labels model, class, reason)")
_QUEUE_DEPTH = _obs.gauge(
    "serving.gateway.queue.depth",
    "requests waiting for a gateway compute slot (label class)")
_LATENCY = _obs.histogram(
    "serving.gateway.latency",
    "gateway request latency, receive -> respond (labels class)")


class _Admission:
    """Priority-classed compute-slot admission.

    `concurrency` slots are granted across three bounded per-class
    queues in strict PRIORITY_CLASSES order (FIFO within a class): a
    best_effort request is only granted while no interactive or batch
    request waits. Arriving past a full class queue sheds with
    `RequestRejected` (reason queue_full); a deadline that expires
    while waiting sheds with `DeadlineExceeded` (reason deadline) —
    in both cases BEFORE any compute."""

    def __init__(self, concurrency, queue_depth):
        self.concurrency = max(1, int(concurrency))
        self.queue_depth = max(1, int(queue_depth))
        self._cond = threading.Condition()
        self._queues = {cls: deque() for cls in PRIORITY_CLASSES}
        self._active = 0
        self.shed = {cls: 0 for cls in PRIORITY_CLASSES}
        self.granted = {cls: 0 for cls in PRIORITY_CLASSES}

    def _head(self):
        for cls in PRIORITY_CLASSES:
            if self._queues[cls]:
                return self._queues[cls][0]
        return None

    def queue_depths(self):
        with self._cond:
            return {cls: len(q) for cls, q in self._queues.items()}

    def enter(self, cls, deadline=None):
        """Block until this request holds a compute slot; pair with
        `leave()`. Raises the shed errors documented above."""
        if cls not in PRIORITY_CLASSES:
            raise MXNetError(
                "priority must be one of %s, got %r"
                % ("|".join(PRIORITY_CLASSES), cls))
        chaos_point("gateway.admit")
        ticket = object()
        with self._cond:
            q = self._queues[cls]
            if len(q) >= self.queue_depth:
                self.shed[cls] += 1
                raise RequestRejected(
                    "gateway %s queue full (%d waiting); request shed"
                    % (cls, self.queue_depth))
            q.append(ticket)
            _QUEUE_DEPTH.set(len(q), **{"class": cls})
            try:
                while True:
                    if deadline is not None and deadline.expired():
                        self.shed[cls] += 1
                        raise DeadlineExceeded(
                            "request deadline expired while queued "
                            "for a gateway compute slot (class %s); "
                            "shed before compute" % cls)
                    if self._active < self.concurrency \
                            and self._head() is ticket:
                        q.popleft()
                        self._active += 1
                        self.granted[cls] += 1
                        _QUEUE_DEPTH.set(len(q), **{"class": cls})
                        # a slot and the head both changed: other
                        # waiters may now be grantable
                        self._cond.notify_all()
                        return self
                    wait = 0.05
                    if deadline is not None:
                        wait = min(wait, max(0.001,
                                             deadline.remaining()))
                    self._cond.wait(wait)
            except BaseException:
                try:
                    q.remove(ticket)
                except ValueError:
                    pass
                _QUEUE_DEPTH.set(len(q), **{"class": cls})
                self._cond.notify_all()
                raise

    def leave(self):
        with self._cond:
            self._active -= 1
            self._cond.notify_all()


class _BodyTooLarge(Exception):
    def __init__(self, size):
        super().__init__("body too large: %d bytes" % size)
        self.size = size


class _GatewayHTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    allow_reuse_address = True

    def __init__(self, addr, handler, gateway):
        self.gateway = gateway
        super().__init__(addr, handler)


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    server_version = "mxtpu-gateway"
    # socket timeout (honored by StreamRequestHandler.setup): a client
    # that advertises a Content-Length it never sends, or a keep-alive
    # connection that goes silent, must not pin a handler thread
    # forever — it never entered admission, so it would be invisible
    # to every shed counter while wedged threads accumulate
    timeout = 120.0

    # -- plumbing --------------------------------------------------------
    def log_message(self, fmt, *args):   # quiet by default
        pass

    @property
    def gateway(self):
        return self.server.gateway

    def _send_json(self, code, payload, retry_after=None):
        body = json.dumps(payload).encode("utf-8")
        self._responded = True
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        if retry_after is not None:
            # the backpressure signal shed responses carry: closed-loop
            # clients (serve_bench) and real callers back off instead
            # of retry-storming an overloaded or breaker-open model
            self.send_header("Retry-After", str(int(retry_after)))
        tp = getattr(self, "_traceparent", None)
        if tp:
            # echo the request's trace identity (incoming traceparent
            # or the fresh root minted at admission) so the caller can
            # join its logs to the merged trace
            self.send_header("traceparent", tp)
        self.end_headers()
        self.wfile.write(body)

    def _send_text(self, code, text, ctype="text/plain; version=0.0.4"):
        body = text.encode("utf-8")
        self._responded = True
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    #: request-body cap: the declared Content-Length is buffered per
    #: handler thread BEFORE admission can shed anything, so an
    #: uncapped body is an OOM lever pointed at all N resident models
    max_body_bytes = 64 * 1024 * 1024

    def _read_body(self):
        n = int(self.headers.get("Content-Length") or 0)
        if n > self.max_body_bytes:
            raise _BodyTooLarge(n)
        raw = self.rfile.read(n) if n else b"{}"
        body = json.loads(raw.decode("utf-8"))
        if not isinstance(body, dict):
            raise ValueError("request body must be a JSON object")
        return body

    def _chunk(self, data):
        self.wfile.write(b"%x\r\n" % len(data))
        self.wfile.write(data + b"\r\n")

    # -- routes ----------------------------------------------------------
    def do_GET(self):
        # GETs are untraced: a keep-alive connection interleaving a
        # GET after a traced POST must not echo the stale identity
        self._traceparent = None
        gw = self.gateway
        if self.path == "/healthz":
            ok = not gw.closing
            self._send_json(200 if ok else 503, {
                "ok": ok,
                "draining": gw.closing,
                "lease": _lease.held_state(),
            })
            return
        if self.path == "/readyz":
            ready = gw.ready()
            self._send_json(200 if ready else 503, {
                "ready": ready,
                "resident": gw.registry.resident(),
            })
            return
        if self.path == "/v1/models":
            self._send_json(200, {"models": gw.registry.stats()})
            return
        if self.path == "/metricsz":
            # the Prometheus scrape surface: every process-wide
            # counter/gauge/histogram in exposition text format
            self._send_text(200, _obs.REGISTRY.to_prometheus())
            return
        if self.path == "/debugz":
            self._send_text(
                200, json.dumps(gw.debug_state(), default=str,
                                sort_keys=True),
                ctype="application/json")
            return
        self._send_json(404, {"error": "no route %r" % self.path})

    def do_POST(self):
        # per-REQUEST response marker: the handler instance persists
        # across requests on one keep-alive connection, so a stale
        # True from the previous request would misroute this one's
        # last-resort error mapping (same for the echoed traceparent)
        self._responded = False
        self._traceparent = None
        if self.headers.get("Transfer-Encoding"):
            # a chunked body can't be drained by Content-Length; left
            # unread it would poison this keep-alive connection, so
            # refuse it outright and close the connection
            self.close_connection = True
            self._send_json(411, {
                "error": "chunked request bodies are not supported; "
                         "send Content-Length"})
            return
        # drain the body FIRST, whatever the route: an unread body
        # left in the socket would be parsed as the next request line
        # on this HTTP/1.1 keep-alive connection, poisoning it for
        # every subsequent request the client pipelines
        try:
            body = self._read_body()
        except _BodyTooLarge as err:
            # the oversized body was never read: close the connection
            # rather than let it poison the keep-alive stream
            self.close_connection = True
            self._send_json(413, {
                "error": "request body of %d bytes exceeds the %d "
                         "byte cap" % (err.size, self.max_body_bytes)})
            return
        except ValueError as err:
            self._send_json(400, {"error": "bad JSON body: %s" % err})
            return
        except OSError:
            # the socket timeout tripped mid-body (a client that
            # advertised more bytes than it sent): the stream is
            # unusable — drop the connection, answer nothing
            self.close_connection = True
            return
        path = self.path
        if not path.startswith("/v1/models/") or ":" not in path:
            self._send_json(404, {"error": "no route %r" % path})
            return
        model, _, verb = path[len("/v1/models/"):].rpartition(":")
        if verb not in ("predict", "generate") or not model:
            self._send_json(
                404, {"error": "route must be /v1/models/<name>"
                               ":predict or :generate"})
            return
        self.gateway._serve(self, model, verb, body)


class Gateway:
    """The serving front door: HTTP + priority admission over a
    `ModelRegistry`.

        reg = ModelRegistry(hbm_budget_mb=512)
        reg.register("mlp", lambda: engine, eager=True, num_workers=1)
        gw = Gateway(reg).start()        # MXTPU_GATEWAY_PORT or
        ...                              # ephemeral; see gw.port
        gw.close()

    Env defaults (constructor args win):
      MXTPU_GATEWAY_PORT         listen port (0 = ephemeral)      (0)
      MXTPU_GATEWAY_CONCURRENCY  concurrent compute slots         (4)
      MXTPU_GATEWAY_QUEUE_DEPTH  per-priority-class wait queue    (64)
    """

    def __init__(self, registry, host="127.0.0.1", port=None,
                 concurrency=None, queue_depth=None, device=None):
        if not isinstance(registry, ModelRegistry):
            raise MXNetError("Gateway wants a ModelRegistry")
        self.registry = registry
        if device is None:
            from ...context import current_context
            device = current_context()
        # the device the fronted models serve on: it alone decides the
        # lease (never a backend query)
        self.device = device
        self.host = host
        self._port = int(port if port is not None
                         else getenv("MXTPU_GATEWAY_PORT", 0))
        self._admission = _Admission(
            concurrency if concurrency is not None
            else getenv("MXTPU_GATEWAY_CONCURRENCY", 4),
            queue_depth if queue_depth is not None
            else getenv("MXTPU_GATEWAY_QUEUE_DEPTH", 64))
        self._httpd = None
        self._thread = None
        self._started = False
        self.closing = False
        self._leased = False
        # per-class EWMA of served-request latency: the service-rate
        # half of the Retry-After derivation (queue depth is the other)
        # — mutated from concurrent handler threads under _stats_lock
        self._stats_lock = threading.Lock()
        self._svc_ewma = {}
        self.hedges = {"fired": 0, "won": 0}

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    @property
    def port(self):
        return (self._httpd.server_address[1]
                if self._httpd is not None else self._port)

    @property
    def url(self):
        return "http://%s:%d" % (self.host, self.port)

    def start(self):
        """Bind the socket, load the eager model set (warmups
        included), then flip ready. The socket accepts connections
        BEFORE the eager loads finish so /healthz answers during
        warmup while /readyz correctly reads 503."""
        if self._started:
            return self
        # a closed Gateway may be restarted: models reload lazily
        # (entries went cold at drain_all; builders are re-callable)
        self.closing = False
        self.registry.reopen()
        if _lease.lease_wanted(self.device):
            # the front door owns device acquisition for the process
            # (role "gateway" in the lease record — tools/kill_stale.py
            # recognizes it); model servers ride the same refcounted
            # process-wide hold. First holder names the role: an
            # embedded registry that started serving BEFORE the
            # gateway keeps its "serving" role in the record
            _lease.hold(what="gateway")
            self._leased = True
        try:
            self._httpd = _GatewayHTTPServer((self.host, self._port),
                                             _Handler, self)
            self._thread = threading.Thread(
                target=self._httpd.serve_forever, daemon=True,
                name="gateway-http")
            self._thread.start()
            self._started = True
            self.registry.load_eager()
        except BaseException:
            # drain whatever eager models DID load before releasing
            # the lease: a resident engine must never outlive the
            # process-wide device grant
            self.close()
            raise
        return self

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
        return False

    def ready(self):
        """`/readyz` truth: socket up, not closing, and every eager
        model loaded-and-warmed (registry.ready). Reloads of evicted
        models are served misses, not readiness regressions."""
        return (self._started and not self.closing
                and self.registry.ready())

    def close(self, timeout=None, drain_models=True):
        """Stop accepting connections, drain every resident model
        (in-flight requests finish), release the lease."""
        self.closing = True
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        ok = True
        if drain_models:
            ok = self.registry.drain_all(timeout)
        if self._leased:
            self._leased = False
            _lease.release_hold()
        self._started = False
        return ok

    def stats(self):
        return {
            "url": self.url if self._started else None,
            "ready": self.ready(),
            "closing": self.closing,
            "concurrency": self._admission.concurrency,
            "queue_depth": self._admission.queue_depth,
            "queues": self._admission.queue_depths(),
            "granted": dict(self._admission.granted),
            "shed": dict(self._admission.shed),
            "hedges": dict(self.hedges),
            "registry": self.registry.stats(),
        }

    def debug_state(self):
        """The `/debugz` payload: the process-wide snapshot (lease
        holder, compile/AOT counters, trace plane, thread stacks)
        plus the gateway's own live state — per-class queue depths
        and grants, resident models with measured device bytes, and
        per-model server stats (decode slot occupancy included)."""
        return _httpz.debug_snapshot(extra={
            "gateway": {
                "url": self.url if self._started else None,
                "ready": self.ready(),
                "closing": self.closing,
                "concurrency": self._admission.concurrency,
                "queues": self._admission.queue_depths(),
                "granted": dict(self._admission.granted),
                "shed": dict(self._admission.shed),
                "hedges": dict(self.hedges),
            },
            "registry": self.registry.stats(),
            "servers": self.registry.server_states(),
        })

    # ------------------------------------------------------------------
    # request path (runs on handler threads)
    # ------------------------------------------------------------------
    @staticmethod
    def _cur_trace_id():
        """Trace id of the active (sampled) request context, or None —
        the exemplar tag and the per-record correlation key."""
        ctx = _trace.current()
        return ctx.trace_id if ctx is not None and ctx.sampled else None

    def _observe(self, event, model, cls, route, status, t0,
                 queue_s=None, reason=None, tokens=None):
        dt = time.perf_counter() - t0
        trace_id = self._cur_trace_id()
        if event == "request":
            with self._stats_lock:
                prev = self._svc_ewma.get(cls)
                self._svc_ewma[cls] = dt if prev is None \
                    else 0.8 * prev + 0.2 * dt
            # SERVED requests only: the per-class latency percentiles
            # are the SLO surface perf_gate budgets — fast 404s or
            # arbitrary-latency 500s must not dilute them (they ride
            # event="error" records instead). The worst-K latencies
            # keep their trace ids as exemplars, so a p99 breach names
            # concrete traceable requests
            _REQUESTS.inc(**{"model": model, "class": cls})
            _LATENCY.observe(dt, exemplar=trace_id, **{"class": cls})
        elif event == "shed":
            _SHED.inc(**{"model": model, "class": cls,
                         "reason": reason or "?"})
        if _telemetry.stream_enabled():
            rec = {"ts": time.time(), "source": "gateway",
                   "event": event, "step_time": dt, "model": model,
                   "class": cls, "route": route, "status": status}
            if queue_s is not None:
                rec["queue_s"] = queue_s
            if reason is not None:
                rec["reason"] = reason
            if tokens is not None:
                rec["tokens"] = tokens
            if trace_id is not None:
                rec["trace_id"] = trace_id
            _telemetry.emit(rec)

    def _parse_common(self, body):
        cls = str(body.get("priority", "interactive"))
        if cls not in PRIORITY_CLASSES:
            raise MXNetError(
                "priority must be one of %s, got %r"
                % ("|".join(PRIORITY_CLASSES), cls))
        deadline = None
        if body.get("deadline_ms") is not None:
            deadline = Deadline(float(body["deadline_ms"]) / 1000.0,
                                what="gateway request")
        return cls, deadline

    def _retry_after(self, cls):
        """The `Retry-After` seconds a shed response carries: class
        queue depth × recent service time / compute slots — how long
        the backlog ahead actually takes to clear — clamped to [1, 30]
        whole seconds (1 when nothing has been served yet)."""
        ewma = self._svc_ewma.get(cls)
        if not ewma:
            return 1
        depth = self._admission.queue_depths().get(cls, 0)
        est = (depth + 1) * ewma / self._admission.concurrency
        return max(1, min(30, int(math.ceil(est))))

    def _submit_with_retry(self, model, submit, count=True):
        """registry.get + submit, retrying ONCE through the registry
        when an in-progress eviction raced us to the server (the retry
        reloads transparently). The model-named ServerClosed from the
        second failure propagates to the 503 path. Returns the request
        handle."""
        for attempt in (0, 1):
            # the retry is the SAME client request: count it once
            # (hedge duplicates pass count=False — one client request)
            server = self.registry.get(
                model, _count_request=(attempt == 0 and count))
            try:
                return submit(server)
            except ServerClosed:
                if attempt:
                    raise
        raise AssertionError("unreachable")

    def _hedge_delay_s(self, cls):
        """The hedge delay for this request, in seconds, or None when
        hedging does not apply (off by default; interactive class
        only). ``MXTPU_GATEWAY_HEDGE_MS=auto`` derives it from the
        observed interactive p95 — the classic tail-at-scale policy:
        hedge only the slowest ~5%."""
        if cls != "interactive":
            return None
        ms = _health.hedge_delay_ms()
        if ms is None:
            return None
        if ms == "auto":
            p95 = _LATENCY.percentile(0.95, **{"class": "interactive"})
            return float(p95) if p95 and p95 > 0 else None
        return float(ms) / 1000.0

    def _resolve(self, model, submit, deadline, cls=None):
        """`_submit_with_retry` + block for the result; an interactive
        request still unresolved after the hedge delay is duplicated
        to another replica (first success wins, the loser's result is
        discarded)."""
        timeout = deadline.remaining() if deadline is not None else 600.0
        handle = self._submit_with_retry(model, submit)
        hedge_s = self._hedge_delay_s(cls)
        if hedge_s is None:
            return handle.result(timeout)
        return self._hedged_result(model, submit, handle, hedge_s,
                                   timeout)

    def _hedged_result(self, model, submit, h1, hedge_s, timeout):
        t_end = time.perf_counter() + max(0.0, timeout)
        wait = min(hedge_s, max(0.0, t_end - time.perf_counter()))
        if h1._event.wait(wait):
            return h1.result(0.0)
        if time.perf_counter() >= t_end - 0.001:
            # the request's own budget is (as good as) gone: a
            # duplicate could never answer in time — don't burn
            # compute or inflate the hedge counters for it
            return h1.result(0.0)
        # the primary is past the hedge delay: fire the duplicate
        # (best-effort — a shed duplicate must never fail the
        # original), then first SUCCESS wins
        _health.HEDGE_FIRED.inc(model=model)
        with self._stats_lock:
            self.hedges["fired"] += 1
        try:
            h2 = self._submit_with_retry(model, submit, count=False)
        except Exception:  # noqa: BLE001 — opportunistic only
            h2 = None
        if h2 is None:
            # fired-but-unplaceable still leaves its telemetry record
            # (the event count must mirror serving.hedge.fired)
            _health.emit_event("hedge", model=str(model), won=False)
            return h1.result(max(0.0, t_end - time.perf_counter()))
        pending, errors = [h1, h2], []
        won = False

        def discard(losers):
            # the loser's compute is abandoned: a decode handle frees
            # its KV slot at the next step boundary instead of
            # generating to max_new_tokens for nobody (forward handles
            # have nothing to cancel — their batch runs either way)
            for h in losers:
                cancel = getattr(h, "cancel", None)
                if cancel is not None and not h.done():
                    cancel()

        try:
            while pending and time.perf_counter() < t_end:
                for h in list(pending):
                    if not h.done():
                        continue
                    pending.remove(h)
                    try:
                        out = h.result(0.0)
                    except Exception as err:  # noqa: BLE001 — kept
                        errors.append(err)
                        continue
                    if h is h2:
                        won = True
                        _health.HEDGE_WON.inc(model=model)
                        with self._stats_lock:
                            self.hedges["won"] += 1
                    discard(pending)
                    return out
                # event-wait, not a spin: wake the moment a pending
                # handle resolves (the other is re-checked each slice)
                if pending:
                    pending[0]._event.wait(0.005)
            discard(pending)
            if errors:
                raise errors[0]
            raise DeadlineExceeded(
                "hedged request for model %r timed out after %.6gs "
                "(primary and hedge both unresolved)"
                % (model, timeout))
        finally:
            _health.emit_event("hedge", model=str(model), won=won)

    def _serve(self, handler, model, verb, body):
        t0 = time.perf_counter()
        # request tracing (docs/observability.md "Distributed
        # tracing"): accept the client's W3C traceparent (malformed =
        # fresh root), mint a root otherwise, and echo the identity on
        # every response — including the cheap pre-admission rejections
        ctx = None
        if _trace.enabled():
            ctx = _trace.TraceContext.from_traceparent(
                handler.headers.get("traceparent")) \
                or _trace.TraceContext.new()
            handler._traceparent = ctx.to_traceparent()
        try:
            cls, deadline = self._parse_common(body)
        except (MXNetError, ValueError, TypeError) as err:
            handler._send_json(400, {"error": str(err)})
            return
        # cheap rejections BEFORE admission: a typo'd model name or a
        # payload missing its one required field must not queue behind
        # real work or consume a compute slot
        if not self.registry.has(model):
            self._observe("error", model, cls, verb, 404, t0,
                          reason="unknown_model")
            handler._send_json(404, {
                "error": "unknown model %r (registered: %s)"
                         % (model, self.registry.models() or "none"),
                "model": model})
            return
        field = "inputs" if verb == "predict" else "tokens"
        if body.get(field) is None:
            self._observe("error", model, cls, verb, 400, t0,
                          reason="missing_%s" % field)
            handler._send_json(400, {
                "error": "%s needs %r" % (verb, field), "model": model})
            return
        # the root span covers admission wait + compute + respond
        # (t0 backdates it to receive time); everything submitted
        # inside — batcher requests, decode prompts — captures this
        # context and parents its spans to it across the queue hops
        with _trace.trace_span("gateway.request", ctx=ctx, t0=t0,
                               model=model, route=verb,
                               **{"class": cls}):
            cur = _trace.current()
            if cur is not None:
                # re-point the echoed parent id at the root span so
                # the client's follow-up spans nest under it
                handler._traceparent = cur.to_traceparent()
            try:
                with _trace.trace_span("gateway.admission",
                                       **{"class": cls}):
                    self._admission.enter(cls, deadline)
            except DeadlineExceeded as err:
                self._observe("shed", model, cls, verb, 504, t0,
                              reason="deadline")
                handler._send_json(504, {"error": str(err),
                                         "model": model, "class": cls},
                                   retry_after=self._retry_after(cls))
                return
            except RequestRejected as err:
                self._observe("shed", model, cls, verb, 503, t0,
                              reason="queue_full")
                handler._send_json(503, {"error": str(err),
                                         "model": model, "class": cls},
                                   retry_after=self._retry_after(cls))
                return
            except MXNetError as err:   # chaos gateway.admit
                # a fault is not load: it rides event="error" so a
                # chaos drill never reads as phantom overload in the
                # shed counts
                self._observe("error", model, cls, verb, 500, t0,
                              reason="fault")
                handler._send_json(500, {"error": str(err),
                                         "model": model, "class": cls})
                return
            queue_s = time.perf_counter() - t0
            try:
                if verb == "predict":
                    self._serve_predict(handler, model, cls, deadline,
                                        body, t0, queue_s)
                else:
                    self._serve_generate(handler, model, cls, deadline,
                                         body, t0, queue_s)
            except Exception as err:  # noqa: BLE001 — last-resort map
                # nothing in the request path may kill the connection
                # with no response: malformed payloads (ragged inputs,
                # a non-numeric max_new_tokens) answer 400, anything
                # else 500 — unless the response already started
                # (streaming), where the connection is all we had
                if not getattr(handler, "_responded", False):
                    code = 400 if isinstance(err, (ValueError, TypeError,
                                                   KeyError)) else 500
                    self._observe("error", model, cls, verb, code, t0,
                                  reason=type(err).__name__)
                    handler._send_json(code, {
                        "error": "%s: %s" % (type(err).__name__, err),
                        "model": model})
                else:
                    raise
            finally:
                self._admission.leave()

    def _serve_predict(self, handler, model, cls, deadline, body, t0,
                       queue_s):
        inputs = body["inputs"]          # presence checked pre-admission
        if isinstance(inputs, dict):
            inputs = {str(k): np.asarray(v) for k, v in inputs.items()}
        else:
            inputs = np.asarray(inputs)
        try:
            outs = self._resolve(
                model, lambda s: s.submit(inputs, deadline=deadline),
                deadline, cls=cls)
        except Exception as err:  # noqa: BLE001 — mapped to status
            self._fail(handler, model, cls, "predict", t0, err)
            return
        self.registry.record_success(model)
        payload = {"model": model, "class": cls,
                   "outputs": [np.asarray(o).tolist() for o in outs]}
        trace_id = self._cur_trace_id()
        if trace_id is not None:
            payload["trace_id"] = trace_id
        self._observe("request", model, cls, "predict", 200, t0,
                      queue_s=queue_s)
        handler._send_json(200, payload)

    def _serve_generate(self, handler, model, cls, deadline, body, t0,
                        queue_s):
        tokens = body["tokens"]          # presence checked pre-admission
        kwargs = {}
        if body.get("max_new_tokens") is not None:
            kwargs["max_new_tokens"] = int(body["max_new_tokens"])
        if body.get("eos_token") is not None:
            kwargs["eos_token"] = int(body["eos_token"])
        stream = bool(body.get("stream", False))

        def submit(s):
            if s.kind != "decode":
                # checked in the submit closure so BOTH paths (and
                # the eviction retry) refuse before a forward engine
                # runs inference on token ids and labels the output
                # a generation
                raise ValueError(
                    "model %r is not a decode model; :generate needs "
                    "one" % model)
            return s.submit(np.asarray(tokens, np.int32),
                            deadline=deadline, **kwargs)

        if not stream:
            try:
                toks = self._resolve(model, submit, deadline, cls=cls)
            except Exception as err:  # noqa: BLE001
                self._fail(handler, model, cls, "generate", t0, err)
                return
            self.registry.record_success(model)
            n = int(np.asarray(toks).size)
            self._observe("request", model, cls, "generate", 200, t0,
                          queue_s=queue_s, tokens=n)
            payload = {"model": model, "class": cls,
                       "tokens": np.asarray(toks).tolist()}
            trace_id = self._cur_trace_id()
            if trace_id is not None:
                payload["trace_id"] = trace_id
            handler._send_json(200, payload)
            return
        # streaming: submit, then relay tokens as they land on the
        # handle (the scheduler appends between decode steps) — one
        # chunked JSON line per token, a final {"done": ...} line
        try:
            h = self._submit_with_retry(model, submit)
        except Exception as err:  # noqa: BLE001
            self._fail(handler, model, cls, "generate", t0, err)
            return
        sent = 0
        try:
            handler._responded = True
            handler.send_response(200)
            handler.send_header("Content-Type", "application/x-ndjson")
            handler.send_header("Transfer-Encoding", "chunked")
            if getattr(handler, "_traceparent", None):
                handler.send_header("traceparent", handler._traceparent)
            handler.end_headers()
            while True:
                done = h.done()
                new = list(h.generated[sent:])
                for tok in new:
                    handler._chunk(
                        (json.dumps({"token": int(tok)}) + "\n")
                        .encode("utf-8"))
                sent += len(new)
                if done:
                    break
                time.sleep(0.002)
            try:
                h.result(0.001)
                tail = {"done": True, "tokens": sent}
                status = 200
                self.registry.record_success(model)
            except Exception as err:  # noqa: BLE001 — delivered inline
                tail = {"error": str(err), "model": model}
                status = 500
                # mid-stream failures bypass _fail (the response
                # already started) but must still feed the breaker
                # with the SAME strike policy
                if self._breaker_strike(err):
                    self.registry.record_failure(model, err)
            trace_id = self._cur_trace_id()
            if trace_id is not None:
                # proxies commonly drop unknown response headers: the
                # tail line carries the id so streaming callers can
                # still join their logs to the merged trace
                tail["trace_id"] = trace_id
            handler._chunk((json.dumps(tail) + "\n").encode("utf-8"))
            handler.wfile.write(b"0\r\n\r\n")
        except (BrokenPipeError, ConnectionResetError):
            # the client went away (before OR mid-stream): cancel the
            # generation so its KV slot frees at the next step
            # boundary instead of leaking compute until max_new_tokens
            # — and the handler thread survives to serve the next
            # keep-alive request (the record still lands)
            h.cancel()
            status = 499
        self._observe("request" if status == 200 else "error",
                      model, cls, "generate", status, t0,
                      queue_s=queue_s, tokens=sent)

    @staticmethod
    def _breaker_strike(err):
        """ONE strike policy for every failure-reporting site (_fail
        and the mid-stream tail): whole-model outages and non-client
        errors count; replica-scoped wedges, sheds, deadlines, drains
        and client mistakes (all MXNetError/ValueError/TypeError
        shapes) do not; a failure the registry already counted at
        load time (`_mxtpu_breaker_counted`) is never counted
        twice."""
        if getattr(err, "_mxtpu_breaker_counted", False):
            return False
        if isinstance(err, NoHealthyReplica):
            # a transient all-quarantined window (canary-recoverable)
            # is replica-plane weather, not model failure — only an
            # all-corpses outage strikes
            return not err.recovering
        return not isinstance(err, (MXNetError, ValueError, TypeError))

    def _fail(self, handler, model, cls, route, t0, err):
        """Map a request-path error to an HTTP status with model
        attribution, and record it. Server-side failures
        (`_breaker_strike`) additionally count a breaker strike for
        the model; shed/backpressure statuses carry a `Retry-After`
        hint."""
        retry_after = None
        if isinstance(err, BreakerOpen):
            # the circuit breaker's instant 503: no builder was
            # hammered, no compute happened; Retry-After carries the
            # cooldown remaining
            status, reason = 503, "breaker"
            retry_after = max(1, int(math.ceil(err.retry_after_s
                                               or 1.0)))
            payload = {"error": str(err), "model": err.model or model,
                       "class": cls}
        elif isinstance(err, (DeviceUnreachable, NoHealthyReplica)):
            # wedged/unavailable replicas: a server fault worth
            # backing off from. Only the WHOLE-model outage
            # (NoHealthyReplica) is a breaker strike — a single
            # replica's DeviceUnreachable is replica-scoped and
            # already handled by quarantine; one wedged step failing
            # N in-flight requests must not open the model's breaker
            # while healthy replicas survive
            status, reason = 503, "unhealthy"
            retry_after = self._retry_after(cls)
            payload = {"error": str(err),
                       "model": getattr(err, "server", None) or model,
                       "class": cls}
        elif isinstance(err, SchedulerCrashed):
            # a crashed decode loop is NOT routine draining: name it,
            # so a crash storm never hides in the graceful-drain shed
            # bucket
            status, reason = 503, "crashed"
            retry_after = self._retry_after(cls)
            payload = {"error": str(err), "model": err.server or model,
                       "class": cls}
        elif isinstance(err, ServerClosed):
            status, reason = 503, "draining"
            retry_after = self._retry_after(cls)
            payload = {"error": str(err), "model": err.server or model,
                       "class": cls}
        elif isinstance(err, DeadlineExceeded):
            status, reason = 504, "deadline"
            retry_after = self._retry_after(cls)
            payload = {"error": str(err), "model": model, "class": cls}
        elif isinstance(err, RequestRejected):
            status, reason = 503, "shed"
            retry_after = self._retry_after(cls)
            payload = {"error": str(err), "model": model, "class": cls}
        elif isinstance(err, MXNetError) and "unknown model" in str(err):
            status, reason = 404, "unknown_model"
            payload = {"error": str(err), "model": model}
        elif isinstance(err, (InjectedFault, InjectedFailure)):
            status, reason = 500, "fault"   # chaos is a server fault
            payload = {"error": str(err), "model": model}
        elif isinstance(err, (MXNetError, ValueError, TypeError)):
            # payload validation at the engine boundary (empty prompt,
            # shape mismatch, batch too large...) is the CLIENT's
            # mistake — it must not pollute 5xx monitoring
            status, reason = 400, "bad_request"
            payload = {"error": str(err), "model": model}
        else:
            status, reason = 500, "error"
            payload = {"error": "%s: %s" % (type(err).__name__, err),
                       "model": model}
        if self._breaker_strike(err):
            self.registry.record_failure(model, err)
        self._observe("shed" if status in (503, 504) else "error",
                      model, cls, route, status, t0, reason=reason)
        handler._send_json(status, payload, retry_after=retry_after)
