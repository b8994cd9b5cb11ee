"""ModelServer: worker-replica dispatch, graceful drain, stats
(counterpart of mxnet_tpu/serving/server.py).

Completes the serving stack (docs/serving.md): an `InferenceEngine`
(frozen forward, padding buckets) behind a `DynamicBatcher`
(coalescing, deadlines, shedding) driven by worker-replica threads. One
process drives one card here, so the replicas share the engine's device
(``MXTPU_SERVE_WORKERS`` or `num_workers` of them, one by default), as
the JAX package's may share one device. A dispatcher thread pulls
coalesced batches and hands each to the **least-loaded** worker (fewest
in-flight rows), so a slow dispatch on one replica doesn't
head-of-line-block the others. The second kind serves a `DecodeEngine`
through one `ContinuousBatchScheduler`.

Shutdown mirrors `resilience.PreemptionGuard`'s shape: SIGTERM (under
`handle_signals()`) or an explicit `drain()` flips the server into
draining mode — new submits are rejected with `ServerClosed`, queued
and in-flight batches FINISH, then workers exit. A preempted serving
replica answers everything it already accepted and sheds the rest to
its peers.

Per-batch JSONL records (when ``MXTPU_TELEMETRY=<path>`` is set) are
tagged ``source="serving"``; `tools/telemetry_report.py` renders the
serving section from them.

A server on a CUDA device holds the process-wide device lease
(`resilience.lease`) from `start` to the end of its drain; a CPU server
takes none unless ``MXTPU_LEASE=1``. The JAX server's AOT artifact store
(`artifacts=`, ``MXTPU_AOT_STORE``) and its cold-start record belong to
the compile plane, which is not ported (ROADMAP A9b): asking for a store
raises `MXNetError`; without one the server starts as JAX's does.
"""
from __future__ import annotations

import signal
import threading
import time
from contextlib import contextmanager

import numpy as np

from ..base import MXNetError, getenv
from ..observability import registry as _obs
from ..observability import telemetry as _telemetry
from ..observability import trace as _trace
from ..resilience import chaos_point
from ..resilience import lease as _lease
from . import health as _health
from .batcher import DynamicBatcher, ServerClosed
from .decode import DecodeEngine
from .engine import _AOT_MSG, InferenceEngine
from .health import DeviceUnreachable, NoHealthyReplica
from .scheduler import ContinuousBatchScheduler

__all__ = ["ModelServer"]

_BATCH_SECONDS = _obs.histogram(
    "serving.batch.seconds", "service time of one coalesced batch")
_REQS_SERVED = _obs.counter("serving.requests.served",
                            "requests answered successfully")
_REQS_FAILED = _obs.counter("serving.requests.failed",
                            "requests answered with an error")


def _local_devices(engine):
    """The devices this process serves on: the engine's one device (one
    process drives one card)."""
    return [engine.device]


class _Worker:
    """One serving replica: a thread draining its private batch queue.

    Health state machine (docs/fault_tolerance.md "Serving
    resilience"): ``healthy`` takes traffic; ``quarantined`` (after
    MXTPU_SERVE_TRIP_LIMIT consecutive dispatch-watchdog trips) is
    skipped by the dispatcher until the server's canary probe
    re-admits it; ``dead`` (the thread exited on a non-request-scoped
    error) is terminal — its queued batches re-dispatch to survivors.
    """

    def __init__(self, server, index, device):
        self.server = server
        self.index = index
        self.device = device
        self._queue = []            # guarded by server._lock
        self.inflight_rows = 0      # guarded by server._lock
        self.served_requests = 0
        self.served_batches = 0
        self.state = "healthy"      # guarded by server._lock
        self.trips = 0
        self._consec_trips = 0      # guarded by server._lock
        self.death = None
        self.watchdog = _health.HealthWatchdog()
        self._current = None        # batch in hand, for death cleanup
        self.thread = threading.Thread(
            target=self._loop, daemon=True,
            name="serving-worker-%d" % index)

    def _loop(self):
        try:
            self._run()
        except BaseException as err:  # noqa: BLE001 — typed + surfaced
            # a crash outside the request scope: without this the
            # dispatcher keeps feeding a dead replica and its queue
            # strands silently
            self.server._on_worker_death(self, err)

    def _run(self):
        srv = self.server
        while True:
            with srv._lock:
                while not self._queue and not srv._stopping:
                    srv._work_ready.wait()
                if not self._queue and srv._stopping:
                    return
                batch = self._queue.pop(0)
                # a backlog slot opened: the dispatcher may pop the
                # next coalesced batch from the bounded batcher queue
                srv._slot_free.notify_all()
            self._current = batch
            try:
                srv._run_batch(self, batch)
                # cleared only on the clean path: if _run_batch raised
                # (this thread is dying), _on_worker_death re-dispatches
                # the in-hand batch via _current
                self._current = None
            finally:
                rows = sum(r.n for r in batch)
                with srv._lock:
                    self.inflight_rows -= rows
                    srv._idle.notify_all()


class ModelServer:
    """Serve an `InferenceEngine` (or any model it can freeze) behind
    dynamic batching with explicit overload behavior.

        engine = InferenceEngine.from_symbol(sym, args, auxs,
                                             {"data": (8,)}, 32)
        server = ModelServer(engine)
        server.start()
        handle = server.submit(x)          # x: (n, 8) host array
        probs = handle.result(timeout=1.0)
        server.drain()
    """

    def __init__(self, engine, num_workers=None, max_batch_size=None,
                 max_wait_ms=None, queue_depth=None, shed_policy=None,
                 warmup=False, max_new_tokens=None, artifacts=None):
        # artifacts: the JAX server's AOT store (or MXTPU_AOT_STORE);
        # the compile plane is not ported, so asking for one raises at
        # start()
        self._artifacts = artifacts
        self._aot_loaded = []
        if isinstance(engine, DecodeEngine):
            # second engine kind: continuous-batching autoregressive
            # decode — one ContinuousBatchScheduler per device replica,
            # least-loaded dispatch at submit time, graceful drain
            # finishes in-flight sequences (docs/serving.md)
            if max_batch_size is not None or max_wait_ms is not None:
                raise MXNetError(
                    "max_batch_size/max_wait_ms are coalescing knobs "
                    "of the forward engine; a DecodeEngine batches by "
                    "cache slots (max_slots) — they have no effect "
                    "here")
            self.kind = "decode"
            self.engine = engine
            devices = _local_devices(engine)
            if num_workers is None:
                num_workers = getenv("MXTPU_SERVE_WORKERS",
                                     len(devices))
            num_workers = max(1, min(int(num_workers), len(devices)))
            engines = [engine]
            for i in range(1, num_workers):
                engines.append(engine.replicate(devices[i]))
            self._schedulers = [
                ContinuousBatchScheduler(
                    e, max_new_tokens=max_new_tokens,
                    queue_depth=queue_depth, shed_policy=shed_policy,
                    name="%s/%d" % (engine.name, i), replica=i)
                for i, e in enumerate(engines)]
            self._started = False
            self._draining = False
            self._drain_requested = False
            self._warmup = bool(warmup)
            return
        self.kind = "forward"
        if not isinstance(engine, InferenceEngine):
            raise MXNetError("ModelServer wants an InferenceEngine or "
                             "a DecodeEngine; use the from_* / "
                             "DecodeEngine constructors to freeze a "
                             "model first")
        self.engine = engine
        devices = _local_devices(engine)
        if num_workers is None:
            num_workers = getenv("MXTPU_SERVE_WORKERS", len(devices))
        num_workers = max(1, int(num_workers))
        self.batcher = DynamicBatcher(
            engine.data_names,
            max_batch_size=(max_batch_size if max_batch_size is not None
                            else engine.max_batch_size),
            max_wait_ms=max_wait_ms, queue_depth=queue_depth,
            shed_policy=shed_policy, name=engine.name)
        if self.batcher.max_batch_size > engine.max_batch_size:
            raise MXNetError(
                "batcher max_batch_size=%d exceeds the engine's "
                "compiled bound %d"
                % (self.batcher.max_batch_size, engine.max_batch_size))
        self._lock = threading.Lock()
        self._work_ready = threading.Condition(self._lock)
        self._idle = threading.Condition(self._lock)
        self._slot_free = threading.Condition(self._lock)
        self._workers = [
            _Worker(self, i, devices[i % len(devices)])
            for i in range(num_workers)]
        self._dispatcher = threading.Thread(
            target=self._dispatch_loop, daemon=True,
            name="serving-dispatch")
        self._started = False
        self._stopping = False
        self._draining = False
        self._drain_requested = False   # set from signal context
        self._step = 0
        self._warmup = bool(warmup)

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    def _acquire_lease(self):
        """Hold the host's cooperative device lease for the server's
        lifetime — the process-wide refcounted hold, so N servers in one
        process share one grant. CPU targets skip it by default;
        MXTPU_LEASE=1 forces, =0 forbids. The decision is made from the
        engine's device and the env (`lease_wanted`), never by querying
        the backend."""
        if not _lease.lease_wanted(self.engine.device):
            return
        self._lease = _lease.hold(what="serving")

    def _release_lease(self):
        if getattr(self, "_lease", None) is not None:
            self._lease = None
            _lease.release_hold()

    def start(self):
        if self._started:
            return self
        self._acquire_lease()
        try:
            return self._start()
        except BaseException:
            # a failed warmup/scheduler start must not keep squatting
            # on the device lease for the process's remaining lifetime
            self._release_lease()
            raise

    def _load_artifacts(self):
        """An AOT artifact store (`artifacts=` or ``MXTPU_AOT_STORE``)
        belongs to the compile plane, which is not ported: asking for
        one raises. Without one there is nothing to load."""
        store = self._artifacts
        if store is None:
            store = getenv("MXTPU_AOT_STORE", "") or None
        if store is not None:
            raise MXNetError("ModelServer artifacts=%r: %s"
                             % (store, _AOT_MSG))
        return []

    def _start(self):
        if self.kind == "decode":
            self._aot_loaded = self._load_artifacts()
            if self._warmup:
                for s in self._schedulers:
                    s.engine.warmup()
            self._started = True
            for s in self._schedulers:
                s.start()
            # forward mode's dispatcher notices _drain_requested and
            # closes the batcher; decode mode has no dispatcher, so a
            # watcher thread plays that role: on the SIGTERM flag it
            # closes every scheduler (finish in-flight, reject new)
            self._signal_watcher = threading.Thread(
                target=self._decode_signal_watch, daemon=True,
                name="decode-signal-watch")
            self._signal_watcher.start()
            return self
        self._aot_loaded = self._load_artifacts()
        if self._warmup:
            # warm every replica device the workers dispatch on, not
            # just the default one
            for dev in {w.device for w in self._workers}:
                self.engine.warmup(device=dev)
        self._started = True
        for w in self._workers:
            w.thread.start()
        self._dispatcher.start()
        return self

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.drain()
        return False

    @property
    def draining(self):
        return self._draining or self._drain_requested

    def _decode_signal_watch(self):
        """Poll the signal-context drain flag (decode mode only): the
        handler may only set a flag, so this thread performs the
        actual scheduler close — the PreemptionGuard split between
        signal context and worker context."""
        while not (self._drain_requested or self._draining):
            time.sleep(0.05)
        for s in self._schedulers:
            s.close()

    def drain(self, timeout=None):
        """Graceful shutdown: reject new submits, FINISH everything
        already queued or in flight, then stop the threads. Returns
        True when fully drained (False only on timeout). In decode
        mode "in flight" means SEQUENCES: every admitted or queued
        prompt decodes to completion before the schedulers stop."""
        self._draining = True
        if self.kind == "decode":
            if not self._started:
                for s in self._schedulers:
                    s.close()
                self._release_lease()
                return True
            deadline = None if timeout is None \
                else time.perf_counter() + timeout
            ok = True
            for s in self._schedulers:
                wait = None if deadline is None \
                    else max(0.0, deadline - time.perf_counter())
                ok = s.drain(wait) and ok
            if ok:
                self._release_lease()
            return ok
        self.batcher.close()          # wakes the dispatcher
        if not self._started:
            self._release_lease()
            return True
        deadline = None if timeout is None \
            else time.perf_counter() + timeout
        self._dispatcher.join(timeout)
        if self._dispatcher.is_alive():
            # the dispatcher may hold a just-popped batch it has not
            # assigned yet — declaring the workers idle now would
            # strand that batch on a stopped worker's queue forever
            return False
        with self._lock:
            while any(w._queue or w.inflight_rows
                      for w in self._workers):
                wait = None if deadline is None \
                    else deadline - time.perf_counter()
                if wait is not None and wait <= 0:
                    return False
                self._idle.wait(wait)
            self._stopping = True
            self._work_ready.notify_all()
        for w in self._workers:
            wait = None if deadline is None \
                else max(0.0, deadline - time.perf_counter())
            w.thread.join(wait)
        done = all(not w.thread.is_alive() for w in self._workers)
        if done:
            self._release_lease()
        return done

    stop = drain

    @contextmanager
    def handle_signals(self, signals=(signal.SIGTERM, signal.SIGINT)):
        """Install handlers that request a graceful drain (the
        PreemptionGuard shape: the handler only sets a flag; rejection
        of new work and the drain itself happen on worker/caller
        threads, never in signal context)."""
        old = {}

        def _handler(signum, frame):
            # signal context: only set a flag (PreemptionGuard's rule) —
            # the dispatcher thread notices it and closes the batcher;
            # taking the batcher lock here could deadlock against the
            # interrupted main-thread frame
            self._drain_requested = True

        try:
            for sig in signals:
                try:
                    old[sig] = signal.signal(sig, _handler)
                except ValueError:   # not the main thread
                    pass
            yield self
        finally:
            for sig, prev in old.items():
                signal.signal(sig, prev)

    # ------------------------------------------------------------------
    # client API
    # ------------------------------------------------------------------
    def submit(self, inputs, deadline=None, **decode_kwargs):
        """Forward mode: `inputs` is {name: (n, *example) array}. Decode
        mode: `inputs` is one 1-D prompt of token ids (plus optional
        `max_new_tokens=`/`eos_token=`), dispatched to the least-loaded
        scheduler replica (fewest queued + in-flight sequences)."""
        if not self._started:
            raise MXNetError("ModelServer.submit before start()")
        if self.draining:
            raise ServerClosed(
                "server %r is draining; request refused"
                % self.engine.name, server=self.engine.name)
        if self.kind == "decode":
            # route around dead replicas (a crashed scheduler loop
            # must not silently accumulate a queue nobody drains) and
            # prefer healthy ones over quarantined; requests fail
            # typed ONLY when no replica survives at all
            live = [s for s in self._schedulers if s.alive()]
            if not live:
                raise NoHealthyReplica(
                    "every decode replica of server %r is dead "
                    "(crashed or stopped); request refused"
                    % self.engine.name, server=self.engine.name)
            healthy = [s for s in live if s.state == "healthy"] or live
            sched = min(healthy, key=lambda s: s.load())
            return sched.submit(inputs, deadline=deadline,
                                **decode_kwargs)
        if decode_kwargs:
            raise MXNetError("decode kwargs %s only apply to a "
                             "DecodeEngine server"
                             % sorted(decode_kwargs))
        return self.batcher.submit(inputs, deadline=deadline)

    def infer(self, inputs, deadline=None, timeout=None):
        """Synchronous convenience: submit + block for the result."""
        return self.submit(inputs, deadline=deadline).result(timeout)

    def generate(self, tokens, max_new_tokens=None, deadline=None,
                 eos_token=None, timeout=None):
        """Decode-mode synchronous convenience: submit one prompt and
        block for its generated tokens (np.int32 array)."""
        if self.kind != "decode":
            raise MXNetError("generate() needs a DecodeEngine server")
        return self.submit(tokens, deadline=deadline,
                           max_new_tokens=max_new_tokens,
                           eos_token=eos_token).result(timeout)

    # ------------------------------------------------------------------
    # dispatch + compute
    # ------------------------------------------------------------------
    def _worker_eligible_locked(self, w):
        """Routable replica: healthy state, thread still running.
        Caller holds the lock."""
        return w.state == "healthy" and w.thread.is_alive()

    def _scan_dead(self):
        """Belt-and-braces dead-thread sweep (the worker's own wrapper
        normally reports its death): a healthy-state worker whose
        thread is gone stops receiving traffic NOW, not at the next
        wedge."""
        if self._stopping:
            return      # drain: threads exit on purpose
        with self._lock:
            dead = [w for w in self._workers
                    if w.state != "dead" and w.thread.ident is not None
                    and not w.thread.is_alive()]
        for w in dead:
            self._on_worker_death(w, w.death)

    def _dispatch_loop(self):
        while True:
            if self._drain_requested and not self.batcher.closed:
                self.batcher.close()     # finish queued, reject new
            self._scan_dead()
            # backpressure: don't pop from the BOUNDED batcher queue
            # until some ELIGIBLE worker has a free backlog slot (at
            # most one queued batch per worker) — draining into
            # unbounded worker lists would keep the batcher near-empty
            # and defeat the queue_depth/shedding contract under
            # sustained overload. With NO eligible worker, fall
            # through: the batch is popped and failed typed below
            # instead of aging silently in the queue
            with self._lock:
                while True:
                    eligible = [w for w in self._workers
                                if self._worker_eligible_locked(w)]
                    if eligible:
                        if any(not w._queue for w in eligible):
                            break
                    else:
                        # no routable worker: if any replica is
                        # quarantined its canary may re-admit it —
                        # hold the queue (requests shed on their own
                        # deadlines) instead of insta-failing a
                        # transient wedge; with only corpses left, or
                        # while draining, fall through and fail typed
                        recovering = any(
                            w.state != "dead"
                            and w.thread.is_alive()
                            for w in self._workers)
                        if not recovering or self.batcher.closed \
                                or self._drain_requested:
                            break
                    self._slot_free.wait(0.1)
            batch = self.batcher.next_batch(timeout=0.1)
            if batch is None:
                if self.batcher.closed:
                    return
                continue
            rows = sum(r.n for r in batch)
            with self._lock:
                eligible = [w for w in self._workers
                            if self._worker_eligible_locked(w)]
                worker = None
                if eligible:
                    free = [w for w in eligible if not w._queue]
                    worker = min(free or eligible,
                                 key=lambda w: w.inflight_rows)
                    worker.inflight_rows += rows
                    worker._queue.append(batch)
                    self._work_ready.notify_all()
            if worker is None:
                # graceful degradation's floor: requests fail typed
                # ONLY when no replica survives (recovering=True when
                # a canary may still bring one back — not a breaker
                # strike)
                recovering = any(w.state != "dead"
                                 and w.thread.is_alive()
                                 for w in self._workers)
                err = NoHealthyReplica(
                    "no healthy replica left for server %r (every "
                    "worker is dead or quarantined); request refused"
                    % self.engine.name, server=self.engine.name,
                    recovering=recovering)
                for req in batch:
                    req.reject(err)
                _REQS_FAILED.inc(len(batch))

    def _run_batch(self, worker, batch):
        t0 = time.perf_counter()
        # a deadline can run out between batcher dequeue and this
        # worker reaching the batch — re-check so doomed requests are
        # rejected (never computed), same contract as queue-time expiry
        batch = self.batcher.reject_expired(batch)
        if not batch:
            return
        rows = sum(r.n for r in batch)
        # the executing thread ATTACHES the first traced request's
        # context around the engine dispatch so the device work is
        # TraceAnnotation-keyed by its trace id; every traced request
        # additionally gets retroactive queue/batch/dispatch spans
        # below (the batch is shared — the spans are per trace)
        trace_ctx = next((c for c in (r.trace_context() for r in batch)
                          if c is not None), None)
        try:
            chaos_point("serving.infer")
            stacked = {
                name: (batch[0].inputs[name] if len(batch) == 1
                       else np.concatenate(
                           [r.inputs[name] for r in batch], axis=0))
                for name in self.engine.data_names}
            t_disp = time.perf_counter()

            def dispatch():
                outs = self.engine.infer(stacked, n=rows,
                                         device=worker.device)
                # responses are HOST arrays: one device sync per
                # output per batch, then zero-copy numpy views per
                # request — a device slice per request would hand back
                # the very dispatch overhead the coalescing just
                # amortized away
                return [o.asnumpy() for o in outs]

            with _trace.attached(trace_ctx):
                # watchdog-bounded (MXTPU_SERVE_DISPATCH_TIMEOUT_S;
                # off by default = the plain direct call): a wedged
                # device dispatch trips typed instead of hanging every
                # request on this replica forever
                host = _health.guard(
                    worker.watchdog, dispatch,
                    what="engine %r dispatch (replica %d)"
                         % (self.engine.name, worker.index),
                    sites=("engine.dispatch",
                           _health.replica_site(worker.index)))
            t_done = time.perf_counter()
        except DeviceUnreachable as err:
            # the wedge signal: trip accounting, maybe quarantine, and
            # the batch rides a surviving replica instead of failing
            self._on_worker_trip(worker, batch, err)
            return
        except Exception as err:   # noqa: BLE001 — delivered per request
            for req in batch:
                req.reject(err)
            _REQS_FAILED.inc(len(batch))
            return
        offset = 0
        for req in batch:
            req.resolve([o[offset:offset + req.n] for o in host])
            offset += req.n
            ctx = req.trace_context()
            if ctx is not None:
                # retroactive spans, parented to the SUBMITTING span
                # captured at submit() — the thread hops (handler ->
                # dispatcher -> worker) preserved the chain
                _trace.record_span(
                    "serving.queue", ctx, req.enqueued_at, t0)
                bid = _trace.record_span(
                    "serving.batch", ctx, t0, t_done,
                    worker=worker.index, rows=rows,
                    requests=len(batch), server=self.engine.name)
                _trace.record_span(
                    "engine.dispatch", ctx, t_disp, t_done,
                    parent_id=bid)
        worker.served_requests += len(batch)
        worker.served_batches += 1
        with self._lock:
            worker._consec_trips = 0    # a good dispatch clears strikes
        _REQS_SERVED.inc(len(batch))
        dt = time.perf_counter() - t0
        _BATCH_SECONDS.observe(dt)
        if _telemetry.stream_enabled():
            with self._lock:
                step = self._step
                self._step += 1
            _telemetry.emit({
                "ts": time.time(), "source": "serving", "step": step,
                "step_time": dt, "batch_size": rows,
                "requests": len(batch),
                "fill_ratio": rows / float(self.batcher.max_batch_size),
                "queue_depth": len(self.batcher),
                "shed_total": self.batcher.shed,
                "worker": worker.index,
            })

    # ------------------------------------------------------------------
    # replica health (docs/fault_tolerance.md "Serving resilience")
    # ------------------------------------------------------------------
    def _on_worker_trip(self, worker, batch, err):
        """One dispatch-watchdog trip on `worker`: count it, past
        MXTPU_SERVE_TRIP_LIMIT consecutive trips quarantine the
        replica (the canary probe re-admits it once the device answers
        again), and re-dispatch the tripped batch to a surviving
        replica — requests only fail when none survives."""
        worker.trips += 1
        _health.record_trip(self.engine.name, worker.index)
        quarantine = False
        with self._lock:
            worker._consec_trips += 1
            if worker._consec_trips >= _health.trip_limit() \
                    and worker.state == "healthy":
                worker.state = "quarantined"
                quarantine = True
        if quarantine:
            _health.record_quarantine(self.engine.name, worker.index)
            self._ensure_canary()
        self._redispatch(worker, batch, err)

    def _redispatch(self, source, batch, err):
        """Hand a failed replica's batch to a surviving one (graceful
        degradation). Re-dispatch attempts are capped per request so a
        systemic fault can't cycle a batch forever; with no surviving
        replica the requests fail typed (`NoHealthyReplica`) — the one
        case where they fail at all."""
        live = []
        for req in batch:
            req.attempts += 1
            if req.attempts > max(2, len(self._workers)):
                req.reject(err)
                _REQS_FAILED.inc()
            else:
                live.append(req)
        if not live:
            return
        with self._lock:
            targets = [w for w in self._workers if w is not source
                       and self._worker_eligible_locked(w)]
            if targets:
                rows = sum(r.n for r in live)
                w = min(targets, key=lambda t: t.inflight_rows)
                w.inflight_rows += rows
                w._queue.append(live)
                self._work_ready.notify_all()
                return
        with self._lock:
            # ANY live replica (quarantined or merely mid-trip) can
            # recover via canary/clean dispatch: only an all-corpses
            # outage is breaker-strike evidence
            recovering = any(w.state != "dead"
                             and w.thread.is_alive()
                             for w in self._workers)
        fail = NoHealthyReplica(
            "no healthy replica left for server %r: %s"
            % (self.engine.name, err), server=self.engine.name,
            recovering=recovering)
        for req in live:
            req.reject(fail)
        _REQS_FAILED.inc(len(live))

    def _on_worker_death(self, worker, err=None):
        """A worker thread died outside the request scope: terminal.
        Stop routing to it, zero its accounting (drain() must not wait
        on a corpse), re-dispatch everything it still held, surface
        the state everywhere."""
        with self._lock:
            if worker.state == "dead":
                return
            worker.state = "dead"
            worker.death = err
            stranded = list(worker._queue)
            if worker._current is not None:
                stranded.append([r for r in worker._current
                                 if not r.done()])
            worker._queue = []
            worker._current = None
            worker.inflight_rows = 0
            self._idle.notify_all()
            self._slot_free.notify_all()
            self._work_ready.notify_all()
        _health.WORKER_DEATHS.inc(server=self.engine.name,
                                  replica=str(worker.index))
        _health.marker("worker_death", server=self.engine.name,
                       replica=worker.index,
                       error=type(err).__name__ if err else "-")
        _health.set_replica_state(self.engine.name, worker.index,
                                  "dead", reason="worker_death")
        base = err if err is not None else MXNetError(
            "serving worker %d of %r died" % (worker.index,
                                              self.engine.name))
        for batch in stranded:
            if batch:
                self._redispatch(worker, batch, base)

    def _ensure_canary(self):
        """The background canary probe: one warm-bucket dispatch per
        quarantined replica per MXTPU_SERVE_CANARY_S; success
        re-admits the replica. Started lazily at the first
        quarantine."""
        with self._lock:
            th = getattr(self, "_canary_thread", None)
            if th is not None and th.is_alive():
                return
            self._canary_thread = threading.Thread(
                target=self._canary_loop, daemon=True,
                name="serving-canary-%s" % self.engine.name)
            self._canary_thread.start()

    def _canary_loop(self):
        while not self._stopping and not self.draining:
            time.sleep(_health.canary_interval())
            with self._lock:
                quarantined = [w for w in self._workers
                               if w.state == "quarantined"]
                if not quarantined:
                    # nothing left to probe: exit instead of waking
                    # every interval for the server's lifetime — the
                    # next quarantine lazily restarts us. Deregister
                    # under the SAME lock _ensure_canary checks, so a
                    # concurrent quarantine either sees us alive (we
                    # will see its worker: it was marked before the
                    # _ensure_canary call) or starts a fresh thread
                    if self._canary_thread is threading.current_thread():
                        self._canary_thread = None
                    return
            for w in quarantined:
                self._canary_probe(w)

    def _canary_probe(self, worker):
        try:
            _health.guard(
                worker.watchdog,
                lambda: self.engine.infer(self.engine.zero_inputs(1),
                                          n=1, device=worker.device),
                what="canary probe (replica %d)" % worker.index,
                sites=("engine.dispatch",
                       _health.replica_site(worker.index)))
        except DeviceUnreachable:
            # still wedged: counted, stays out
            worker.trips += 1
            _health.record_trip(self.engine.name, worker.index,
                                kind="canary_trip")
            return
        except Exception:  # noqa: BLE001 — the probe proved nothing
            return
        with self._lock:
            if worker.state != "quarantined":
                return
            worker.state = "healthy"
            worker._consec_trips = 0
            self._work_ready.notify_all()
            self._slot_free.notify_all()
        _health.record_readmit(self.engine.name, worker.index)

    def device_bytes(self):
        """Measured device-buffer bytes across this server's engines
        (per-replica decode engines each carry their own cache) — the
        gateway registry's HBM-budget accounting input."""
        if self.kind == "decode":
            return sum(s.engine.device_bytes()
                       for s in self._schedulers)
        return self.engine.device_bytes()

    def ledger_models(self):
        """HBM-ledger model names this server's engines registered
        their cells under (per-device decode replicas carry derived
        names) — the gateway registry releases exactly these at
        eviction so the ledger drops with the budget accounting."""
        if self.kind == "decode":
            return sorted({s.engine.name for s in self._schedulers})
        return [self.engine.name]

    # ------------------------------------------------------------------
    # observability
    # ------------------------------------------------------------------
    def stats(self):
        """Point-in-time snapshot for monitoring/debug endpoints."""
        if self.kind == "decode":
            per = [s.stats() for s in self._schedulers]
            return {
                "kind": "decode",
                "engine": self.engine.name,
                "dtype": self.engine.dtype,
                "max_slots": self.engine.max_slots,
                "max_seq_len": self.engine.max_seq_len,
                "aot_programs": self.engine.aot_programs,
                "workers": per,
                "submitted": sum(p["submitted"] for p in per),
                "served": sum(p["served"] for p in per),
                "shed": sum(p["shed"] for p in per),
                "evicted": sum(p["evicted"] for p in per),
                "tokens": sum(p["tokens"] for p in per),
                "queued": sum(p["queued"] for p in per),
                "healthy_workers": sum(1 for p in per
                                       if p["state"] == "healthy"
                                       and p["alive"]),
                "draining": self.draining,
                # device-lease snapshot: None without a hold,
                # holder/heartbeat info when the process-wide hold is
                # active
                "lease": _lease.held_state(),
            }
        with self._lock:
            workers = [{
                "index": w.index, "device": str(w.device),
                "inflight_rows": w.inflight_rows,
                "served_requests": w.served_requests,
                "served_batches": w.served_batches,
                # replica health surface (/debugz drill-down):
                # dispatch stops routing to !alive / !healthy workers
                "state": w.state,
                "alive": w.thread.is_alive(),
                "trips": w.trips,
            } for w in self._workers]
        # this server's own labelset — two servers in one process must
        # not report each other's tails
        lat = _obs.REGISTRY.get("serving.request.latency")
        labels = {"server": self.batcher.name}
        return {
            "engine": self.engine.name,
            "buckets": list(self.engine.buckets),
            "compiled_buckets": self.engine.compiled_buckets,
            "aot_buckets": self.engine.aot_buckets,
            "max_batch_size": self.batcher.max_batch_size,
            "max_wait_ms": self.batcher.max_wait_s * 1000.0,
            "queue_depth": len(self.batcher),
            "queue_limit": self.batcher.queue_depth,
            "shed_policy": self.batcher.shed_policy,
            "submitted": self.batcher.submitted,
            "shed": self.batcher.shed,
            "served": sum(w["served_requests"] for w in workers),
            "batches": sum(w["served_batches"] for w in workers),
            "healthy_workers": sum(1 for w in workers
                                   if w["state"] == "healthy"
                                   and w["alive"]),
            "draining": self.draining,
            "request_latency_p50_s": lat.percentile(0.50, **labels),
            "request_latency_p95_s": lat.percentile(0.95, **labels),
            "workers": workers,
            "lease": _lease.held_state(),
        }
