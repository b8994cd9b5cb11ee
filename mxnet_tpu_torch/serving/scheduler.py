"""ContinuousBatchScheduler: Orca-style continuous batching for decode
(a copy of mxnet_tpu/serving/scheduler.py over the port's DecodeEngine).

The queueing half of the generation subsystem (docs/serving.md). The
naive way to batch generation is request-level: collect N prompts, run
them in lockstep, return when the LAST finishes — short sequences idle
while long ones drag the batch. Continuous (iteration-level) batching
schedules at token granularity instead: between any two decode steps,
finished sequences retire and queued prompts are admitted into the
freed cache slots, so the fixed-shape step (DecodeEngine) runs at the
highest slot fill the traffic allows and no shape ever changes.

A request's life::

    queued -> prefilling -> decoding -> resolved
      |            |            |
      |            |            +-> evicted  (deadline at a step boundary)
      |            +-> rejected (deadline expired at admission)
      +-> shed (queue full / ServerClosed)

- admission happens only between steps, into a free slot, oldest
  request first; an expired request found at admission is rejected
  without touching the device (same contract as DynamicBatcher);
- `resilience.Deadline` is re-checked at every step boundary: expired
  in-flight sequences are EVICTED — rejected with `DeadlineExceeded`,
  their slot freed — instead of computing tokens nobody will wait for;
- drain (`close()`/`drain()`) finishes every admitted AND queued
  sequence, then stops the loop; new submits raise `ServerClosed`.

Env defaults (constructor args win):
  MXTPU_DECODE_MAX_NEW      greedy tokens per request cap     (32)
  MXTPU_SERVE_QUEUE_DEPTH   bounded queue, in requests        (256)
  MXTPU_SERVE_SHED_POLICY   reject | drop_oldest              (reject)

Chaos site: ``serving.decode`` fires before every decode step; an
injected fault is delivered to every in-flight sequence (their cache
state is unknown past the fault) and the scheduler keeps serving the
queue. Telemetry: one ``source="decode"`` JSONL record per step, one
per finished request (``event="request"``, TTFT + inter-token stats).
"""
from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np

from ..base import MXNetError, getenv
from ..observability import registry as _obs
from ..observability import telemetry as _telemetry
from ..observability import trace as _trace
from ..observability.span import capture_context, restored
from ..resilience import DeadlineExceeded, chaos_point
from . import health as _health
from .batcher import RequestRejected, ServerClosed
from .decode import DecodeEngine
from .health import DeviceUnreachable, SchedulerCrashed

__all__ = ["ContinuousBatchScheduler", "DecodeRequest",
           "SchedulerCrashed"]

_TTFT = _obs.histogram(
    "serving.decode.ttft",
    "time to first token, submit -> prefill complete (seconds)")
_TOKENS = _obs.counter("serving.decode.tokens",
                       "tokens generated (including each first token)")
_FILL = _obs.histogram(
    "serving.decode.slot.fill_ratio",
    "active slots / max_slots observed per decode step",
    buckets=(0.1, 0.25, 0.5, 0.75, 0.9, 1.0))
_EVICTIONS = _obs.counter(
    "serving.decode.evictions",
    "in-flight sequences evicted at a step boundary, by reason")
_SHED = _obs.counter("serving.shed.count",
                     "requests refused by the load-shedding policy")
_QUEUE_DEPTH = _obs.gauge("serving.decode.queue.depth",
                          "requests waiting for a cache slot")


class DecodeRequest:
    """One generation request: a future-style handle the client blocks
    on. `result()` returns the generated tokens as an np.int32 array
    (the eos token, when hit, is included). `token_times` holds a
    perf_counter stamp per generated token — TTFT is
    ``token_times[0] - enqueued_at``, inter-token gaps are the diffs —
    which is what a load generator builds its percentiles from."""

    __slots__ = ("tokens", "max_new_tokens", "deadline", "eos_token",
                 "source", "trace", "enqueued_at", "resolved_at",
                 "token_times", "generated", "slot", "cancelled",
                 "_event", "_outputs", "_error")

    def __init__(self, tokens, max_new_tokens, deadline=None,
                 eos_token=None, source="decode"):
        self.tokens = np.asarray(tokens, dtype=np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.deadline = deadline
        self.eos_token = eos_token
        self.source = source
        # submitting thread's span/trace context: the scheduler loop
        # restores it around prefill and parents the generation span
        # to the submitting request (gateway :generate traces)
        self.trace = capture_context()
        self.enqueued_at = time.perf_counter()
        self.resolved_at = None
        self.token_times = []
        self.generated = []
        self.slot = None            # cache slot while decoding
        self.cancelled = False
        self._event = threading.Event()
        self._outputs = None
        self._error = None

    # -- scheduler side ------------------------------------------------
    def push_token(self, token):
        self.generated.append(int(token))
        self.token_times.append(time.perf_counter())

    def finished(self, engine):
        if len(self.generated) >= self.max_new_tokens:
            return True
        eos = self.eos_token if self.eos_token is not None \
            else engine.eos_token
        if eos is not None and self.generated and \
                self.generated[-1] == int(eos):
            return True
        return self.slot is not None and engine.slot_full(self.slot)

    def resolve(self):
        self.resolved_at = time.perf_counter()
        self._outputs = np.asarray(self.generated, dtype=np.int32)
        self._event.set()

    def reject(self, error):
        self.resolved_at = time.perf_counter()
        self._error = error
        self._event.set()

    def trace_context(self):
        """The request's sampled `TraceContext`, or None."""
        ctx = self.trace[1] if self.trace else None
        return ctx if ctx is not None and ctx.sampled else None

    # -- client side ---------------------------------------------------
    def cancel(self):
        """The client abandoned the request (e.g. a broken streaming
        connection): a queued request is rejected at the next pop, a
        decoding one is EVICTED at the next step boundary — its KV
        slot frees immediately instead of leaking until
        max_new_tokens. Safe from any thread; a no-op once resolved."""
        self.cancelled = True

    def done(self):
        return self._event.is_set()

    def ttft(self):
        return None if not self.token_times \
            else self.token_times[0] - self.enqueued_at

    def result(self, timeout=None):
        """Block for the generated tokens; re-raises the rejection or
        compute error in the caller's thread."""
        if not self._event.wait(timeout):
            raise DeadlineExceeded(
                "result() timed out after %.6gs (request still queued "
                "or decoding)" % timeout)
        if self._error is not None:
            raise self._error
        return self._outputs


class ContinuousBatchScheduler:
    """Single-threaded token-level scheduler over one `DecodeEngine`.

        engine = DecodeEngine(block, max_slots=8)
        sched = ContinuousBatchScheduler(engine).start()
        h = sched.submit([1, 2, 3], max_new_tokens=16)
        tokens = h.result(timeout=30)       # np.int32 array
        sched.drain()
    """

    def __init__(self, engine, max_new_tokens=None, queue_depth=None,
                 shed_policy=None, name=None, replica=0):
        if not isinstance(engine, DecodeEngine):
            raise MXNetError("ContinuousBatchScheduler wants a "
                             "DecodeEngine")
        self.engine = engine
        self.name = name or engine.name
        #: which serving replica this scheduler is (ModelServer's
        #: index) — the chaos-site address and metric label
        self.replica = int(replica)
        self.max_new_tokens = int(
            max_new_tokens if max_new_tokens is not None
            else getenv("MXTPU_DECODE_MAX_NEW", 32))
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
        self._queue = deque()
        self._cond = threading.Condition()
        self._closed = False
        self._stopped = threading.Event()
        self._inflight = {}          # slot -> DecodeRequest
        self.submitted = 0
        self.shed = 0
        self.evicted = 0
        self.served = 0
        self.tokens_out = 0
        # replica health (docs/fault_tolerance.md "Serving
        # resilience"): a wedged dispatch trips the watchdog; past
        # MXTPU_SERVE_TRIP_LIMIT consecutive trips the scheduler
        # quarantines ITSELF (real requests stop prefilling; a canary
        # probe re-admits it); a crashed loop is terminal ("dead")
        self.state = "healthy"
        self.trips = 0
        self.crashed = None
        self._consec_trips = 0
        self._last_canary = 0.0
        self._watchdog = None
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name="decode-sched-%s" % self.name)
        self._started = False

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def start(self):
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.drain()
        return False

    @property
    def closed(self):
        return self._closed

    def close(self):
        """Stop accepting work; everything queued or in flight still
        finishes (graceful drain)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def drain(self, timeout=None):
        """close() + wait for the loop to finish every admitted and
        queued sequence. True when fully drained."""
        self.close()
        if not self._started:
            return True
        return self._stopped.wait(timeout)

    # ------------------------------------------------------------------
    # client API
    # ------------------------------------------------------------------
    def submit(self, tokens, max_new_tokens=None, deadline=None,
               eos_token=None):
        """Enqueue one prompt (1-D int sequence); returns a
        `DecodeRequest` handle. Raises `ServerClosed` when draining,
        `RequestRejected` past `queue_depth` under the `reject` policy
        (under `drop_oldest` the stalest queued request is evicted in
        the newcomer's favor)."""
        req = DecodeRequest(
            tokens,
            max_new_tokens if max_new_tokens is not None
            else self.max_new_tokens,
            deadline=deadline, eos_token=eos_token, source=self.name)
        if req.tokens.size < 1:
            raise MXNetError("submit: empty prompt")
        if req.tokens.size > self.engine.max_seq_len:
            raise MXNetError(
                "prompt of %d tokens exceeds max_seq_len=%d"
                % (req.tokens.size, self.engine.max_seq_len))
        if req.max_new_tokens < 1:
            raise MXNetError("max_new_tokens must be >= 1")
        with self._cond:
            if self.crashed is not None:
                raise SchedulerCrashed(
                    "decode scheduler %r crashed (%s: %s); request "
                    "refused" % (self.name,
                                 type(self.crashed).__name__,
                                 self.crashed), server=self.name)
            if self._closed:
                raise ServerClosed(
                    "scheduler %r is draining; request refused"
                    % self.name, server=self.name)
            if len(self._queue) >= self.queue_depth:
                if self.shed_policy == "reject":
                    self.shed += 1
                    _SHED.inc(reason="queue_full")
                    raise RequestRejected(
                        "decode queue full (%d requests); request shed"
                        % self.queue_depth)
                victim = self._queue.popleft()
                self.shed += 1
                _SHED.inc(reason="evicted")
                victim.reject(RequestRejected(
                    "evicted by a newer request (drop_oldest policy)"))
            self._queue.append(req)
            self.submitted += 1
            _QUEUE_DEPTH.set(len(self._queue))
            self._cond.notify_all()
        return req

    def generate(self, tokens, max_new_tokens=None, deadline=None,
                 eos_token=None, timeout=None):
        """Synchronous convenience: submit + block for the tokens."""
        return self.submit(tokens, max_new_tokens=max_new_tokens,
                           deadline=deadline,
                           eos_token=eos_token).result(timeout)

    def load(self):
        """Queued + in-flight sequences — ModelServer's least-loaded
        dispatch key."""
        with self._cond:
            return len(self._queue) + len(self._inflight)

    def alive(self):
        """False once the loop thread died (crash or drain complete):
        ModelServer stops routing submits here — a dead scheduler
        must never silently accumulate a queue nobody drains."""
        if not self._started:
            return True              # startable: ModelServer starts it
        return self._thread.is_alive() and not self._stopped.is_set()

    def stats(self):
        with self._cond:
            queued = len(self._queue)
        return {
            "engine": self.engine.name,
            "dtype": self.engine.dtype,
            "max_slots": self.engine.max_slots,
            "max_seq_len": self.engine.max_seq_len,
            "active_slots": int(self.engine.active.sum()),
            "queued": queued,
            "queue_limit": self.queue_depth,
            "shed_policy": self.shed_policy,
            "submitted": self.submitted,
            "served": self.served,
            "shed": self.shed,
            "evicted": self.evicted,
            "tokens": self.tokens_out,
            "steps": self.engine.steps,
            "compiled_programs": self.engine.compiled_programs,
            "draining": self._closed,
            # replica health surface (/debugz drill-down)
            "state": self.state,
            "alive": self.alive(),
            "trips": self.trips,
            "crashed": (None if self.crashed is None
                        else repr(self.crashed)),
        }

    # ------------------------------------------------------------------
    # the scheduling loop (one thread; the engine is single-consumer)
    # ------------------------------------------------------------------
    def _loop(self):
        crash = None
        try:
            while True:
                with self._cond:
                    while not self._queue and not self._inflight \
                            and not self._closed \
                            and self.state != "quarantined":
                        self._cond.wait(0.05)
                    if self._closed and not self._queue \
                            and not self._inflight:
                        return
                if self.state == "quarantined":
                    # real requests stop dispatching on a quarantined
                    # replica; doomed queued ones still shed on time,
                    # and a background canary probe re-admits it once
                    # the device answers again
                    if self._closed:
                        # draining while the device is still wedged:
                        # queued requests (deadline-less ones
                        # included) can never be served here — reject
                        # typed so drain() terminates instead of
                        # waiting out a wedge that may never clear
                        with self._cond:
                            leftovers = list(self._queue)
                            self._queue.clear()
                            _QUEUE_DEPTH.set(0)
                        for req in leftovers:
                            self.shed += 1
                            _SHED.inc(reason="quarantined")
                            req.reject(ServerClosed(
                                "scheduler %r is draining while its "
                                "replica is quarantined (device "
                                "wedged); request cannot be served"
                                % self.name, server=self.name))
                    self._sweep_queue()
                    self._maybe_canary()
                    if self.state == "quarantined":
                        # idle at the canary cadence, not a busy poll —
                        # unconditionally: close() notifies the cond so
                        # drain stays prompt, and skipping the wait
                        # when closed would spin this thread flat-out
                        # while live queued requests outwait the wedge
                        with self._cond:
                            self._cond.wait(min(
                                _health.canary_interval(), 0.25))
                        continue
                self._admit()
                self._evict_expired()
                if self._inflight:
                    self._step_once()
        except BaseException as err:  # noqa: BLE001 — typed + surfaced
            # a non-request-scoped crash: without this, _closed stays
            # False and later submits enqueue into a loop nobody runs
            # — their result() hangs forever
            crash = err
            _health.LOOP_CRASHES.inc(scheduler=self.name)
            _health.marker("loop_crash", scheduler=self.name,
                           error=type(err).__name__)
            _health.emit_event("loop_crash", scheduler=self.name,
                               error=repr(err))
        finally:
            # a crash must not strand waiters: close FIRST (so a
            # racing submit is refused, not silently queued), then
            # reject everything left — and the rejections must land
            # BEFORE _stopped releases drain(), or a drain()er could
            # observe "done" while a handle still has no outcome
            with self._cond:
                self._closed = True
                if crash is not None:
                    # under the lock: a submit racing the crash is
                    # refused as SchedulerCrashed, not ServerClosed
                    self.crashed = crash
                    self.state = "dead"
                leftovers = list(self._queue) + list(
                    self._inflight.values())
                self._queue.clear()
                self._inflight.clear()
            for req in leftovers:
                if not req.done():
                    if crash is not None:
                        req.reject(SchedulerCrashed(
                            "decode scheduler %r crashed (%s: %s) "
                            "before the request finished"
                            % (self.name, type(crash).__name__, crash),
                            server=self.name))
                    else:
                        req.reject(ServerClosed(
                            "decode scheduler %r stopped before the "
                            "request finished" % self.name,
                            server=self.name))
            if crash is not None:
                _health.set_replica_state(self.name, self.replica,
                                          "dead", reason="loop_crash")
            self._stopped.set()

    def _reject_doomed(self, req):
        """Shed a queued request nobody can use anymore (cancelled
        client, expired deadline) with the standard accounting; True
        when it was doomed. One policy for BOTH the admission pop and
        the quarantine sweep — the two paths must never diverge."""
        if req.cancelled:
            self.shed += 1
            _SHED.inc(reason="cancelled")
            req.reject(RequestRejected(
                "request cancelled by the client while queued"))
            return True
        if req.deadline is not None and req.deadline.expired():
            self.shed += 1
            _SHED.inc(reason="deadline")
            req.reject(DeadlineExceeded(
                "request deadline expired after %.6gs in queue"
                % (time.perf_counter() - req.enqueued_at)))
            return True
        return False

    def _pop_live(self):
        """Next queued request whose deadline has not expired (and
        whose client still wants it); doomed ones are rejected on the
        spot, never prefilled."""
        with self._cond:
            while self._queue:
                req = self._queue.popleft()
                _QUEUE_DEPTH.set(len(self._queue))
                if not self._reject_doomed(req):
                    return req
        return None

    def _sweep_queue(self):
        """While quarantined nothing is admitted, but doomed queued
        requests (expired deadline, cancelled client) must still shed
        on time instead of aging silently."""
        with self._cond:
            live = deque(req for req in self._queue
                         if not self._reject_doomed(req))
            self._queue = live
            _QUEUE_DEPTH.set(len(self._queue))

    # -- watchdog-bounded dispatch + replica health --------------------
    def _wd(self):
        if self._watchdog is None:
            self._watchdog = _health.HealthWatchdog()
        return self._watchdog

    def _sites(self):
        return ("engine.dispatch", _health.replica_site(self.replica))

    def _on_trip(self):
        """One dispatch-watchdog trip on this replica: count it, and
        past MXTPU_SERVE_TRIP_LIMIT consecutive trips quarantine the
        scheduler (canary-probed until the device answers again)."""
        self.trips += 1
        self._consec_trips += 1
        _health.record_trip(self.name, self.replica)
        if self._consec_trips >= _health.trip_limit() \
                and self.state == "healthy":
            self.state = "quarantined"
            _health.record_quarantine(self.name, self.replica)

    def _note_dispatch_ok(self):
        self._consec_trips = 0
        if self.state == "quarantined":
            self.state = "healthy"
            _health.record_readmit(self.name, self.replica)

    def _rebuild_engine(self):
        """After a dispatch trip the wedged call still holds the
        engine's cache on a daemon thread and will mutate engine state
        whenever it finally returns — the instance is unsalvageable. A sibling engine (same block, fresh cache and
        programs) replaces it; the zombie's late writes land on the
        abandoned object."""
        old = self.engine
        self.engine = old.replicate(old.device, name=old.name)

    def _fault_reset(self, err, wedged=False):
        """Past a failed prefill/step the in-flight cache state is
        unknown: fail the sequences, restore a clean engine, keep
        serving the queue. `wedged` (a watchdog trip) swaps in a fresh
        engine instance; an ordinary compute error just resets."""
        for slot, req in list(self._inflight.items()):
            req.reject(err)
        self._inflight.clear()
        if wedged:
            self._rebuild_engine()
        else:
            for slot in self.engine.active_slots:
                self.engine.retire(slot)
            self.engine.reset()

    def _maybe_canary(self):
        """One warm-bucket probe dispatch per MXTPU_SERVE_CANARY_S
        while quarantined: success re-admits the replica, a trip (or
        any error) keeps it out with a fresh engine."""
        now = time.monotonic()
        if now - self._last_canary < _health.canary_interval():
            return
        self._last_canary = now
        engine = self.engine
        try:
            slot = engine.free_slots[0]
            _health.guard(
                self._wd(),
                lambda: engine.prefill(np.zeros(1, np.int64), slot),
                what="decode canary (%s)" % self.name,
                sites=self._sites())
            engine.retire(slot)
        except DeviceUnreachable:
            # a wedged probe: the zombie dispatch still holds the
            # cache — only THIS case needs a fresh engine
            self._on_trip()
            self._rebuild_engine()
            return
        except Exception:  # noqa: BLE001 — the probe proved nothing
            # an ordinary error (chaos kind=raise, transient compute
            # failure): the engine state is intact — rebuilding here
            # would re-allocate the cache per canary interval, an
            # allocation storm on an already-degraded box
            try:
                engine.retire(slot)
            except Exception:  # noqa: BLE001 — slot may not be active
                pass
            return
        self._note_dispatch_ok()

    def _admit(self):
        """Fill free cache slots from the queue (oldest first). Each
        admission pays one bucketed prefill + the admit program; its
        first token arrives here — TTFT territory."""
        engine = self.engine
        while engine.free_slots:
            req = self._pop_live()
            if req is None:
                return
            slot = engine.free_slots[0]
            try:
                # prefill runs on the scheduler thread with the
                # SUBMITTING request's context restored: the prefill
                # span (and the TraceAnnotation inside the engine)
                # parent to the request, not to an orphaned root
                with restored(req.trace), \
                        _trace.trace_span("decode.prefill", slot=slot,
                                          tokens=int(req.tokens.size)):
                    first = _health.guard(
                        self._wd(),
                        lambda: engine.prefill(req.tokens, slot),
                        what="decode prefill (%s)" % self.name,
                        sites=self._sites())
            except DeviceUnreachable as err:
                # the wedged prefill may still write the
                # cache on its daemon thread: in-flight state is
                # unknown — same blast radius as a wedged step. The
                # tripped request itself was NOT computed: requeue it
                # at the head (it rides the recovered replica after
                # the canary re-admits, or sheds on its deadline) —
                # only sequences already mid-decode fail typed
                with self._cond:
                    self._queue.appendleft(req)
                    _QUEUE_DEPTH.set(len(self._queue))
                self._on_trip()
                self._fault_reset(err, wedged=True)
                return
            except Exception as err:  # noqa: BLE001 — delivered
                req.reject(err)
                continue
            self._note_dispatch_ok()
            req.slot = slot
            req.push_token(first)
            self._inflight[slot] = req
            self.tokens_out += 1
            ctx = req.trace_context()
            _TOKENS.inc(engine=engine.name)
            _TTFT.observe(req.ttft(), engine=engine.name,
                          exemplar=ctx.trace_id if ctx else None)
            if req.finished(engine):
                self._retire(slot)

    def _evict_expired(self):
        """The Deadline contract at token granularity: a sequence whose
        budget ran out — or whose client disconnected (`cancel()`) —
        is evicted BETWEEN steps: its slot frees for the queue, and no
        further tokens are computed for it."""
        for slot, req in list(self._inflight.items()):
            if req.cancelled:
                self.engine.retire(slot)
                del self._inflight[slot]
                self.evicted += 1
                _EVICTIONS.inc(reason="cancelled")
                req.reject(RequestRejected(
                    "request cancelled by the client after %d "
                    "generated tokens; sequence evicted and its slot "
                    "freed" % len(req.generated)))
            elif req.deadline is not None and req.deadline.expired():
                self.engine.retire(slot)
                del self._inflight[slot]
                self.evicted += 1
                _EVICTIONS.inc(reason="deadline")
                req.reject(DeadlineExceeded(
                    "deadline expired after %d generated tokens; "
                    "sequence evicted at the step boundary"
                    % len(req.generated)))

    def _retire(self, slot):
        req = self._inflight.pop(slot)
        self.engine.retire(slot)
        self.served += 1
        req.resolve()
        ctx = req.trace_context()
        if ctx is not None:
            # one retroactive span covering the whole generation
            # (queue + prefill + every decode step it rode), parented
            # to the submitting request's span
            _trace.record_span(
                "decode.generate", ctx, req.enqueued_at,
                req.resolved_at, tokens=len(req.generated),
                slot=slot, scheduler=self.name)
        if _telemetry.stream_enabled():
            gaps = np.diff(req.token_times)
            rec = {
                "ts": time.time(), "source": "decode",
                "event": "request",
                "step_time": req.resolved_at - req.enqueued_at,
                "tokens": len(req.generated),
                "prompt_tokens": int(req.tokens.size),
                "ttft_s": req.ttft(),
                "intertoken_s": float(gaps.mean()) if gaps.size else 0.0,
                "scheduler": self.name,
            }
            if ctx is not None:
                rec["trace_id"] = ctx.trace_id
            _telemetry.emit(rec)

    def _step_once(self):
        t0 = time.perf_counter()
        engine = self.engine
        fill = engine.fill_ratio()
        _FILL.observe(fill, engine=engine.name)
        try:
            chaos_point("serving.decode")
            next_tokens = _health.guard(
                self._wd(), engine.step,
                what="decode step (%s)" % self.name,
                sites=self._sites())
        except DeviceUnreachable as err:
            # a wedged step: typed, counted, quarantine-eligible — and
            # the cache is unrecoverable (the zombie dispatch
            # still holds it), so a fresh engine replaces it
            self._on_trip()
            self._fault_reset(err, wedged=True)
            return
        except Exception as err:  # noqa: BLE001 — delivered per request
            # past a failed step the in-flight cache state is unknown:
            # fail the sequences, clear the slots, keep serving
            self._fault_reset(err)
            return
        self._note_dispatch_ok()
        produced = 0
        for slot, req in list(self._inflight.items()):
            req.push_token(next_tokens[slot])
            produced += 1
            if req.finished(engine):
                self._retire(slot)
        self.tokens_out += produced
        _TOKENS.inc(produced, engine=engine.name)
        dt = time.perf_counter() - t0
        if _telemetry.stream_enabled():
            _telemetry.emit({
                "ts": time.time(), "source": "decode",
                "step": engine.steps, "step_time": dt,
                "tokens": produced, "batch_size": produced,
                "fill_ratio": fill,
                "queue_depth": len(self._queue),
                "evictions_total": self.evicted,
                "scheduler": self.name,
            })
