"""DynamicBatcher: coalesce requests into padded batches, shed overload
(a copy of mxnet_tpu/serving/batcher.py: the same queueing rules, env
knobs and ``serving.*`` metrics).

The queueing half of the serving subsystem (docs/serving.md). Clients
`submit()` individual requests (1..max rows each) and block on the
returned handle; a consumer (ModelServer's dispatcher, or any loop
calling `next_batch()`) pulls *coalesced* batches: requests are merged
until `max_batch_size` rows are ready or `max_wait_ms` has passed since
the oldest queued request arrived — the dispatch-amortization window.

Overload is explicit, not emergent:

- the queue is bounded (`queue_depth` requests); past it the
  load-shedding policy applies — ``reject`` (default) refuses the new
  request, ``drop_oldest`` evicts the stalest queued request in its
  favor (fresh traffic beats requests that have already waited longest
  and are most likely to miss their deadline anyway);
- every request may carry a `resilience.Deadline`; a request whose
  deadline expires while queued is rejected at dequeue time with
  `DeadlineExceeded` — never computed. Doomed work is the first thing
  an overloaded server must stop doing.

Env defaults (constructor args win):
  MXTPU_SERVE_MAX_BATCH     rows per coalesced batch          (32)
  MXTPU_SERVE_MAX_WAIT_MS   coalescing window                 (5.0)
  MXTPU_SERVE_QUEUE_DEPTH   bounded queue, in requests        (256)
  MXTPU_SERVE_SHED_POLICY   reject | drop_oldest              (reject)

Metrics: `serving.queue.depth` (gauge), `serving.shed.count` (counter,
label `reason`), `serving.batch.fill_ratio` + `serving.batch.requests`
(histograms, observed per coalesced batch), `serving.request.latency`
(histogram, submit -> resolve).
"""
from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np

from ..base import MXNetError, getenv
from ..ndarray import NDArray
from ..observability import registry as _obs
from ..observability.span import capture_context
from ..resilience import DeadlineExceeded

__all__ = ["DynamicBatcher", "InferenceRequest", "RequestRejected",
           "ServerClosed"]

_QUEUE_DEPTH = _obs.gauge("serving.queue.depth",
                          "requests waiting in the serving queue")
_SHED = _obs.counter("serving.shed.count",
                     "requests refused by the load-shedding policy")
_FILL = _obs.histogram("serving.batch.fill_ratio",
                       "coalesced rows / max_batch_size per batch",
                       buckets=(0.1, 0.25, 0.5, 0.75, 0.9, 1.0))
_BATCH_REQS = _obs.histogram("serving.batch.requests",
                             "requests coalesced into one batch",
                             buckets=(1, 2, 4, 8, 16, 32, 64, 128))
_LATENCY = _obs.histogram("serving.request.latency",
                          "request latency, submit -> resolve")


class RequestRejected(MXNetError):
    """The request was refused without being computed (queue full under
    the `reject` policy, evicted under `drop_oldest`, or submitted
    while the server is draining)."""


class ServerClosed(RequestRejected):
    """The batcher/server is closed or draining; no new work accepted.

    `server` names the refusing server/engine when known — a
    multiplexed gateway fronting N models must attribute a drain-time
    503 to the model being evicted, not guess from a bare message."""

    def __init__(self, msg, server=None):
        super().__init__(msg)
        self.server = server


class InferenceRequest:
    """One submitted request: a future-style handle the client blocks
    on. `inputs` is {name: host array of (n, *example)}; the batcher
    coalesces several of these into one engine dispatch. `result()`
    yields what the consumer resolved — ModelServer resolves with HOST
    numpy views into the coalesced batch output (responses get
    serialized anyway; a device handle per request would re-pay the
    dispatch overhead coalescing amortized)."""

    __slots__ = ("inputs", "n", "deadline", "source", "trace",
                 "enqueued_at", "resolved_at", "attempts", "_event",
                 "_outputs", "_error")

    def __init__(self, inputs, n, deadline=None, source="default"):
        self.inputs = inputs
        self.n = int(n)
        self.deadline = deadline
        self.attempts = 0     # replica re-dispatches after a wedge
        #                       (capped — docs/fault_tolerance.md
        #                       "Serving resilience")
        self.source = source      # owning batcher/server, the latency
        #                           histogram label — two servers in
        #                           one process must not blend tails
        # captured span/trace context of the SUBMITTING thread: the
        # worker that executes this request restores it, so its spans
        # parent to the request instead of orphaning at the queue hop
        self.trace = capture_context()
        self.enqueued_at = time.perf_counter()
        self.resolved_at = None     # stamped at resolve/reject — the
        #                             completion time a load generator
        #                             should measure latency against
        self._event = threading.Event()
        self._outputs = None
        self._error = None

    def trace_context(self):
        """The request's `TraceContext` (or None) — the retroactive
        queue/compute spans the consumer records hang off it."""
        ctx = self.trace[1] if self.trace else None
        return ctx if ctx is not None and ctx.sampled else None

    # -- consumer side ---------------------------------------------------
    def resolve(self, outputs):
        self.resolved_at = time.perf_counter()
        ctx = self.trace_context()
        _LATENCY.observe(self.resolved_at - self.enqueued_at,
                         exemplar=ctx.trace_id if ctx else None,
                         server=self.source)
        self._outputs = outputs
        self._event.set()

    def reject(self, error):
        self.resolved_at = time.perf_counter()
        self._error = error
        self._event.set()

    # -- client side -----------------------------------------------------
    def done(self):
        return self._event.is_set()

    def result(self, timeout=None):
        """Block for the outputs; re-raises the rejection/compute error
        in the caller's thread."""
        if not self._event.wait(timeout):
            raise DeadlineExceeded(
                "result() timed out after %.6gs (request still queued "
                "or in flight)" % timeout)
        if self._error is not None:
            raise self._error
        return self._outputs


def _normalize_inputs(inputs, data_names):
    """Host-side normal form: {name: np.ndarray with a batch dim}. Kept
    on the host so coalescing is one np.concatenate + ONE device
    transfer per batch, not one per request."""
    if not isinstance(inputs, dict):
        if len(data_names) != 1:
            raise MXNetError("model has inputs %s; pass a dict"
                             % data_names)
        inputs = {data_names[0]: inputs}
    out = {}
    n = None
    for name in data_names:
        if name not in inputs:
            raise MXNetError("submit: missing input %r" % name)
        x = inputs[name]
        x = x.asnumpy() if isinstance(x, NDArray) else np.asarray(x)
        if x.ndim == 0:
            raise MXNetError("input %r has no batch dimension" % name)
        n = x.shape[0] if n is None else n
        if x.shape[0] != n:
            raise MXNetError("inputs disagree on the batch dimension "
                             "(%d vs %d)" % (x.shape[0], n))
        out[name] = x
    return out, n


class DynamicBatcher:
    """Thread-safe bounded request queue with time/size coalescing."""

    def __init__(self, data_names, max_batch_size=None, max_wait_ms=None,
                 queue_depth=None, shed_policy=None, name=None):
        self._data_names = list(data_names)
        self.name = name or "default"
        self.max_batch_size = int(
            max_batch_size if max_batch_size is not None
            else getenv("MXTPU_SERVE_MAX_BATCH", 32))
        self.max_wait_s = float(
            max_wait_ms if max_wait_ms is not None
            else getenv("MXTPU_SERVE_MAX_WAIT_MS", 5.0)) / 1000.0
        self.queue_depth = int(
            queue_depth if queue_depth is not None
            else getenv("MXTPU_SERVE_QUEUE_DEPTH", 256))
        self.shed_policy = (shed_policy if shed_policy is not None
                            else getenv("MXTPU_SERVE_SHED_POLICY",
                                        "reject"))
        if self.shed_policy not in ("reject", "drop_oldest"):
            raise MXNetError(
                "shed_policy must be 'reject' or 'drop_oldest', got %r"
                % (self.shed_policy,))
        if self.max_batch_size < 1 or self.queue_depth < 1:
            raise MXNetError("max_batch_size and queue_depth must be "
                             ">= 1")
        self._queue = deque()
        self._cond = threading.Condition()
        self._closed = False
        self.submitted = 0
        self.shed = 0

    # ------------------------------------------------------------------
    def __len__(self):
        with self._cond:
            return len(self._queue)

    def close(self, reject_queued=False):
        """Stop accepting work. `reject_queued=True` additionally fails
        everything still waiting (hard shutdown); the default leaves
        queued requests for the consumer to finish (graceful drain)."""
        with self._cond:
            self._closed = True
            if reject_queued:
                while self._queue:
                    req = self._queue.popleft()
                    req.reject(ServerClosed(
                        "server %r closed before the request was "
                        "served" % self.name, server=self.name))
                _QUEUE_DEPTH.set(0)
            self._cond.notify_all()

    @property
    def closed(self):
        return self._closed

    # ------------------------------------------------------------------
    def submit(self, inputs, deadline=None):
        """Enqueue one request; returns an `InferenceRequest` handle.
        Raises `ServerClosed` when draining and `RequestRejected` when
        the bounded queue is full under the `reject` policy."""
        norm, n = _normalize_inputs(inputs, self._data_names)
        if n < 1:
            raise MXNetError("submit: request has zero rows")
        if n > self.max_batch_size:
            raise MXNetError(
                "request of %d rows exceeds max_batch_size=%d — split "
                "it client-side" % (n, self.max_batch_size))
        req = InferenceRequest(norm, n, deadline=deadline,
                               source=self.name)
        with self._cond:
            if self._closed:
                raise ServerClosed(
                    "server %r is draining; request refused" % self.name,
                    server=self.name)
            if len(self._queue) >= self.queue_depth:
                if self.shed_policy == "reject":
                    self.shed += 1
                    _SHED.inc(reason="queue_full")
                    raise RequestRejected(
                        "queue full (%d requests); request shed"
                        % self.queue_depth)
                victim = self._queue.popleft()
                self.shed += 1
                _SHED.inc(reason="evicted")
                victim.reject(RequestRejected(
                    "evicted by a newer request (drop_oldest policy)"))
            self._queue.append(req)
            self.submitted += 1
            _QUEUE_DEPTH.set(len(self._queue))
            self._cond.notify()
        return req

    # ------------------------------------------------------------------
    def _reject_expired(self, req):
        """Deadline-shed one request (accounting + client error)."""
        self.shed += 1
        _SHED.inc(reason="deadline")
        req.reject(DeadlineExceeded(
            "request deadline expired after %.6gs in queue"
            % (time.perf_counter() - req.enqueued_at)))

    def reject_expired(self, requests):
        """Filter a popped batch: requests whose deadline ran out while
        they waited (e.g. in a worker backlog) are rejected with the
        same accounting as queue-time expiry; the survivors are
        returned. Doomed work is never computed."""
        live = []
        for req in requests:
            if req.deadline is not None and req.deadline.expired():
                self._reject_expired(req)
            else:
                live.append(req)
        return live

    def _pop_live(self):
        """Pop the next request whose deadline has not expired; doomed
        requests are rejected on the spot (never returned, never
        computed). Caller holds the lock."""
        while self._queue:
            req = self._queue[0]
            if req.deadline is not None and req.deadline.expired():
                self._queue.popleft()
                self._reject_expired(req)
                continue
            return req
        return None

    def next_batch(self, timeout=None):
        """Block for the next coalesced batch: a list of requests whose
        rows sum to <= max_batch_size. Returns once the batch is full
        or `max_wait_ms` has passed since the oldest member arrived.
        Returns None when closed-and-empty, or on `timeout` with no
        traffic."""
        t_give_up = None if timeout is None \
            else time.perf_counter() + timeout
        with self._cond:
            while True:
                first = self._pop_live()
                if first is not None:
                    break
                if self._closed:
                    return None
                wait = None if t_give_up is None \
                    else t_give_up - time.perf_counter()
                if wait is not None and wait <= 0:
                    return None
                self._cond.wait(wait)

            batch = [self._queue.popleft()]
            rows = first.n
            # coalescing window: measured from the OLDEST member's
            # arrival, so a request never waits more than max_wait_ms
            # for co-travelers on top of its own queueing delay
            t_fill = first.enqueued_at + self.max_wait_s
            while rows < self.max_batch_size:
                nxt = self._pop_live()
                if nxt is not None and rows + nxt.n <= self.max_batch_size:
                    self._queue.popleft()
                    batch.append(nxt)
                    rows += nxt.n
                    continue
                if nxt is not None:
                    break               # next request doesn't fit
                if self._closed:
                    break               # draining: ship what we have
                wait = t_fill - time.perf_counter()
                if wait <= 0:
                    break
                self._cond.wait(wait)
            _QUEUE_DEPTH.set(len(self._queue))
        _FILL.observe(rows / float(self.max_batch_size))
        _BATCH_REQS.observe(len(batch))
        return batch
