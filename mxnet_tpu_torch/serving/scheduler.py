"""ContinuousBatchScheduler: Orca-style continuous batching for decode
(counterpart of mxnet_tpu/serving/scheduler.py).

Continuous (iteration-level) batching schedules at token granularity:
between any two decode steps, finished sequences retire and queued
prompts are admitted into the freed cache slots, so the fixed-shape step
(DecodeEngine) runs at the highest slot fill the traffic allows.

A request's life::

    queued -> prefilling -> decoding -> resolved
      |            |            |
      |            |            +-> evicted  (deadline at a step boundary)
      |            +-> rejected (deadline expired at admission)
      +-> shed (queue full / ServerClosed)

- admission happens only between steps, into a free slot, oldest
  request first; an expired request found at admission is rejected
  without touching the device;
- `resilience.Deadline` is re-checked at every step boundary: expired
  in-flight sequences are EVICTED — rejected with `DeadlineExceeded`,
  their slot freed — instead of computing tokens nobody will wait for;
- drain (`close()`/`drain()`) finishes every admitted AND queued
  sequence, then stops the loop; new submits raise `ServerClosed`;
- a crash of the loop itself closes the scheduler and rejects every
  queued and in-flight request with `SchedulerCrashed`.

The JAX scheduler's health plane (dispatch watchdog, quarantine, canary
probes, chaos sites, trace spans, telemetry JSONL) is not ported yet.

Env defaults (constructor args win):
  MXTPU_DECODE_MAX_NEW      greedy tokens per request cap     (32)
  MXTPU_SERVE_QUEUE_DEPTH   bounded queue, in requests        (256)
  MXTPU_SERVE_SHED_POLICY   reject | drop_oldest              (reject)
"""
from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np

from ..base import MXNetError, getenv
from ..observability import registry as _obs
from ..resilience import DeadlineExceeded
from .batcher import RequestRejected, ServerClosed
from .decode import DecodeEngine
from .health import SchedulerCrashed

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
    ``token_times[0] - enqueued_at``, inter-token gaps are the diffs."""

    __slots__ = ("tokens", "max_new_tokens", "deadline", "eos_token",
                 "enqueued_at", "resolved_at", "token_times", "generated",
                 "slot", "_event", "_outputs", "_error")

    def __init__(self, tokens, max_new_tokens, deadline=None,
                 eos_token=None):
        self.tokens = np.asarray(tokens, dtype=np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        self.deadline = deadline
        self.eos_token = eos_token
        self.enqueued_at = time.perf_counter()
        self.resolved_at = None
        self.token_times = []
        self.generated = []
        self.slot = None            # cache slot while decoding
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

    # -- client side ---------------------------------------------------
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
                 shed_policy=None, name=None):
        if not isinstance(engine, DecodeEngine):
            raise MXNetError("ContinuousBatchScheduler wants a "
                             "DecodeEngine")
        self.engine = engine
        self.name = name or engine.name
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
        self.crashed = None
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
            deadline=deadline, eos_token=eos_token)
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
                    "refused" % (self.name, type(self.crashed).__name__,
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
            "draining": self._closed,
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
                            and not self._closed:
                        self._cond.wait(0.05)
                    if self._closed and not self._queue \
                            and not self._inflight:
                        return
                self._admit()
                self._evict_expired()
                if self._inflight:
                    self._step_once()
        except BaseException as err:  # noqa: BLE001 — typed + surfaced
            crash = err
        finally:
            # a crash must not strand waiters: close FIRST (so a racing
            # submit is refused, not silently queued), then reject
            # everything left before _stopped releases drain()
            with self._cond:
                self._closed = True
                if crash is not None:
                    self.crashed = crash
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
            self._stopped.set()

    def _pop_live(self):
        """Next queued request whose deadline has not expired; expired
        ones are rejected on the spot, never prefilled."""
        with self._cond:
            while self._queue:
                req = self._queue.popleft()
                _QUEUE_DEPTH.set(len(self._queue))
                if req.deadline is None or not req.deadline.expired():
                    return req
                self.shed += 1
                _SHED.inc(reason="deadline")
                req.reject(DeadlineExceeded(
                    "request deadline expired after %.6gs in queue"
                    % (time.perf_counter() - req.enqueued_at)))
        return None

    def _fault_reset(self, err):
        """Past a failed step the in-flight cache state is unknown: fail
        the sequences, restore a clean engine, keep serving the queue."""
        for req in self._inflight.values():
            req.reject(err)
        self._inflight.clear()
        for slot in self.engine.active_slots:
            self.engine.retire(slot)
        self.engine.reset()

    def _admit(self):
        """Fill free cache slots from the queue (oldest first). Each
        admission pays one bucketed prefill; its first token arrives
        here — TTFT territory."""
        engine = self.engine
        while engine.free_slots:
            req = self._pop_live()
            if req is None:
                return
            slot = engine.free_slots[0]
            try:
                first = engine.prefill(req.tokens, slot)
            except Exception as err:  # noqa: BLE001 — delivered
                req.reject(err)
                continue
            req.slot = slot
            req.push_token(first)
            self._inflight[slot] = req
            self.tokens_out += 1
            _TOKENS.inc(engine=engine.name)
            _TTFT.observe(req.ttft(), engine=engine.name)
            if req.finished(engine):
                self._retire(slot)

    def _evict_expired(self):
        """The Deadline contract at token granularity: a sequence whose
        budget ran out is evicted BETWEEN steps: its slot frees for the
        queue, and no further tokens are computed for it."""
        for slot, req in list(self._inflight.items()):
            if req.deadline is None or not req.deadline.expired():
                continue
            self.engine.retire(slot)
            del self._inflight[slot]
            self.evicted += 1
            _EVICTIONS.inc(reason="deadline")
            req.reject(DeadlineExceeded(
                "deadline expired after %d generated tokens; sequence "
                "evicted at the step boundary" % len(req.generated)))

    def _retire(self, slot):
        req = self._inflight.pop(slot)
        self.engine.retire(slot)
        self.served += 1
        req.resolve()

    def _step_once(self):
        engine = self.engine
        _FILL.observe(engine.fill_ratio(), engine=engine.name)
        try:
            next_tokens = engine.step()
        except Exception as err:  # noqa: BLE001 — delivered per request
            self._fault_reset(err)
            return
        produced = 0
        for slot, req in list(self._inflight.items()):
            req.push_token(next_tokens[slot])
            produced += 1
            if req.finished(engine):
                self._retire(slot)
        self.tokens_out += produced
        _TOKENS.inc(produced, engine=engine.name)
