"""ModelRegistry: N models per process under one device-memory budget
(a copy of mxnet_tpu/serving/gateway/registry.py over the port's
servers).

A registry maps model names to *builders* (zero-arg callables
producing an engine or a ready `ModelServer`); models load lazily on
first request and stay resident until the budget pushes them out:

- every resident model is accounted by **measured** device bytes
  (`ModelServer.device_bytes()`: params + aux + per-replica copies +
  decode KV caches, the memory ledger's cells), not by declared sizes;
- when the budget (``MXTPU_GATEWAY_HBM_BUDGET_MB`` bytes and/or
  ``MXTPU_GATEWAY_MAX_MODELS`` count) is exceeded, the **coldest idle**
  model (least-recently-used) is evicted via `ModelServer.drain()` —
  in-flight work finishes token-identically, new submits for it raise
  the (now model-named) `ServerClosed`;
- a request for an evicted model triggers a **transparent reload**,
  counted in `serving.gateway.reload{model}` and emitted as a
  ``source="gateway", event="reload"`` telemetry record;
- concurrent requests for the same cold model are **single-flight**:
  exactly one thread builds, the rest wait on the same load.

Thread-safe; the Gateway drives it from HTTP handler threads, but it
stands alone for embedded multiplexing too.
"""
from __future__ import annotations

import threading
import time

from ...base import MXNetError, getenv
from ...observability import memory as _memory
from ...observability import registry as _obs
from ...observability import telemetry as _telemetry
from .. import health as _health
from ..batcher import ServerClosed
from ..health import BreakerOpen
from ..server import ModelServer

__all__ = ["ModelRegistry", "BreakerOpen"]

RELOADS = _obs.counter(
    "serving.gateway.reload",
    "transparent reloads of a previously evicted model (label model)")
_EVICTIONS = _obs.counter(
    "serving.gateway.evictions",
    "models LRU-evicted to fit the gateway budget (label model)")
_RESIDENT = _obs.gauge(
    "serving.gateway.resident",
    "models currently resident in the registry")
_RESIDENT_BYTES = _obs.gauge(
    "serving.gateway.resident.bytes",
    "measured device-buffer bytes across resident models")


class _Entry:
    __slots__ = ("name", "builder", "eager", "warmup", "server_kwargs",
                 "server", "bytes", "state", "last_used", "loads",
                 "requests", "breaker", "fails", "opened_at",
                 "breaker_opens", "canary_live", "canary_owner")

    def __init__(self, name, builder, eager, warmup, server_kwargs):
        self.name = name
        self.builder = builder
        self.eager = bool(eager)
        self.warmup = bool(warmup)
        self.server_kwargs = dict(server_kwargs)
        self.server = None
        self.bytes = 0
        self.state = "cold"          # cold -> loading -> resident
        self.last_used = 0
        self.loads = 0
        self.requests = 0
        # per-model circuit breaker (docs/fault_tolerance.md "Serving
        # resilience"): closed -> open (MXTPU_BREAKER_FAILS
        # consecutive load/infer failures; instant refusal, no builder
        # hammering) -> half_open (one canary request after the
        # cooldown) -> closed on its success
        self.breaker = "closed"
        self.fails = 0
        self.opened_at = 0.0
        self.breaker_opens = 0
        self.canary_live = False     # half_open: ONE canary at a time
        self.canary_owner = None     # the granted thread — its own
        #                              eviction-race retry re-enters


class ModelRegistry:
    """Multiplex N lazily-loaded models under one memory budget.

        reg = ModelRegistry(hbm_budget_mb=512, max_models=8)
        reg.register("resnet", lambda: engine, num_workers=1)
        server = reg.get("resnet")        # loads on first use
        server.infer(x)

    `hbm_budget_mb` <= 0 (or env ``MXTPU_GATEWAY_HBM_BUDGET_MB`` unset)
    means unbounded bytes; `max_models` <= 0 means unbounded count.
    """

    def __init__(self, hbm_budget_mb=None, max_models=None,
                 name="registry"):
        if hbm_budget_mb is None:
            hbm_budget_mb = getenv("MXTPU_GATEWAY_HBM_BUDGET_MB", 0.0)
        if max_models is None:
            max_models = getenv("MXTPU_GATEWAY_MAX_MODELS", 0)
        self.name = name
        self.budget_bytes = (int(float(hbm_budget_mb) * 1024 * 1024)
                             if float(hbm_budget_mb) > 0 else None)
        self.max_models = int(max_models) if int(max_models) > 0 else None
        self._cond = threading.Condition()
        self._entries = {}
        self._tick = 0
        self._booted = False      # eager load set completed at least once
        self._closed = False      # terminal: no loads past drain_all()
        self._evict_threads = []  # background victim drains in flight

    # ------------------------------------------------------------------
    # registration / boot
    # ------------------------------------------------------------------
    def register(self, name, builder, eager=False, warmup=True,
                 **server_kwargs):
        """Register `name` -> `builder`. The builder is a zero-arg
        callable returning an `InferenceEngine`/`DecodeEngine` (wrapped
        in a `ModelServer` with `server_kwargs`) or a ready, unstarted
        `ModelServer`; it is re-invoked on every (re)load, so it must
        be cheap to call again.
        `eager` models load at `load_eager()` (Gateway.start) and gate
        `/readyz`."""
        name = str(name)
        if not name or "/" in name or ":" in name:
            raise MXNetError(
                "model name %r must be non-empty without '/' or ':' "
                "(it becomes a URL path segment)" % name)
        with self._cond:
            if name in self._entries:
                raise MXNetError("model %r already registered" % name)
            self._entries[name] = _Entry(name, builder, eager, warmup,
                                         server_kwargs)
        return self

    def load_eager(self):
        """Load every `eager` model (Gateway.start calls this before
        flipping `/readyz`): each load runs the server's full warmup,
        so readiness really means "first request pays no compile"."""
        for name in self.models():
            with self._cond:
                e = self._entries[name]
                eager = e.eager
            if eager:
                self.get(name, _count_request=False)
        with self._cond:
            self._booted = True
        return self

    def ready(self):
        """True once the eager load set completed (and trivially for a
        registry with no eager models after `load_eager`). A later
        eviction does not un-ready the process — reloads are a served
        miss, not a boot."""
        with self._cond:
            return self._booted and not self._closed

    def has(self, name):
        """Registration membership (lock-cheap) — the gateway's
        pre-admission check, so a typo'd model name never consumes a
        compute slot."""
        with self._cond:
            return name in self._entries

    def reopen(self):
        """Un-close a drained registry (Gateway.start on a previously
        closed gateway): entries are cold, builders are re-callable,
        so lazy loads simply resume. Background eviction threads from
        the old life were joined by drain_all."""
        with self._cond:
            self._closed = False
            # readiness and reload accounting are per-life: the new
            # boot's /readyz waits for the eager set again, and its
            # boot loads are loads, not "transparent reloads of an
            # evicted model" — the miss metric must stay an eviction
            # metric
            self._booted = False
            for e in self._entries.values():
                e.loads = 0
        return self

    # ------------------------------------------------------------------
    # lookup with transparent load / single-flight
    # ------------------------------------------------------------------
    def get(self, name, _count_request=True):
        """The resident `ModelServer` for `name`, loading it if cold.
        Concurrent gets for the same cold model ride one load
        (single-flight). Raises MXNetError for unregistered names;
        builder failures propagate (and the entry returns to cold so a
        later request can retry)."""
        with self._cond:
            e = self._entries.get(name)
            if e is None:
                raise MXNetError(
                    "unknown model %r (registered: %s)"
                    % (name, sorted(self._entries) or "none"))
            if self._closed:
                # terminal: a handler thread racing Gateway.close()
                # must not resurrect a drained model — the engine it
                # built would outlive the released device lease
                raise ServerClosed(
                    "registry is draining; model %r not served" % name,
                    server=name)
            if _count_request:
                e.requests += 1
            self._breaker_gate_locked(e)
            while e.state == "loading":
                self._cond.wait(0.05)
            if self._closed:
                raise ServerClosed(
                    "registry is draining; model %r not served" % name,
                    server=name)
            if e.state == "resident":
                self._tick += 1
                e.last_used = self._tick
                return e.server
            e.state = "loading"     # we are the loader
        t0 = time.perf_counter()
        try:
            built = e.builder()
            if not isinstance(built, ModelServer):
                built = ModelServer(built, warmup=e.warmup,
                                    **e.server_kwargs)
            built.start()
            nbytes = built.device_bytes()
        except BaseException as err:
            with self._cond:
                e.state = "cold"
                self._cond.notify_all()
            # a failed load is a breaker strike: a builder that keeps
            # failing stops being re-hammered by every request. Tag
            # the error so the gateway's generic-500 strike doesn't
            # count the SAME failure twice (docs say consecutive
            # failures, not consecutive accounting sites)
            self.record_failure(name, err)
            try:
                err._mxtpu_breaker_counted = True
            except AttributeError:
                pass     # exceptions with __slots__: stay single-count
            raise
        load_s = time.perf_counter() - t0
        with self._cond:
            # closed check and resident-marking in ONE critical
            # section: drain_all sets _closed under this lock, so a
            # loader can never slip a fresh server into residency
            # after the shutdown sweep skipped its "loading" entry
            if self._closed:
                closed_late = True
            else:
                closed_late = False
                e.server = built
                e.bytes = int(nbytes)
                e.state = "resident"
                self._tick += 1
                e.last_used = self._tick
                reload = e.loads > 0
                e.loads += 1
                self._update_gauges_locked()
                self._cond.notify_all()
        if closed_late:
            # the registry drained while we were building: this
            # server must not outlive the shutdown. The entry STAYS
            # "loading" until the drain completes — drain_all waits on
            # exactly that state, so its True return really means no
            # engine survives it
            try:
                built.drain()
            finally:
                with self._cond:
                    e.state = "cold"
                    self._cond.notify_all()
            raise ServerClosed(
                "registry drained while loading model %r" % name,
                server=name)
        if reload:
            RELOADS.inc(model=name)
            _telemetry.emit({
                "ts": time.time(), "source": "gateway",
                "event": "reload", "step_time": load_s,
                "model": name, "bytes": int(nbytes),
            })
        # a successful (re)load is breaker evidence too: a half-open
        # canary whose LOAD was the failing part closes here (infer
        # outcomes additionally report via record_success/failure)
        self.record_success(name)
        self._evict_to_fit(exclude=name)
        return built

    # ------------------------------------------------------------------
    # per-model circuit breaker (docs/fault_tolerance.md)
    # ------------------------------------------------------------------
    def _breaker_gate_locked(self, e):
        """Refuse instantly while `e`'s breaker is open (no builder
        hammering, no compute); past the cooldown flip to half_open
        and admit exactly ONE canary request. Caller holds the lock."""
        if e.breaker == "closed":
            return
        cooldown = _health.breaker_cooldown()
        if e.breaker == "open":
            remaining = e.opened_at + cooldown - time.monotonic()
            if remaining > 0:
                raise BreakerOpen(
                    "model %r circuit breaker is open after %d "
                    "consecutive failures; retry in %.3gs"
                    % (e.name, e.fails, remaining),
                    model=e.name, retry_after_s=remaining)
            e.breaker = "half_open"
            e.canary_live = False
            e.canary_owner = None
            _health.set_breaker_state(e.name, "half_open",
                                      reason="cooldown")
        # a canary that never reported (an embedded caller using get()
        # alone) must not jam the breaker: its grant expires after one
        # cooldown and the next request becomes the canary. The
        # grant-HOLDING thread re-enters freely — the gateway's
        # eviction-race retry calls get() again for the same request,
        # and refusing our own canary would leave the breaker
        # un-probed for a full extra cooldown
        if e.canary_live and \
                e.canary_owner != threading.get_ident() and \
                time.monotonic() - e.opened_at <= cooldown:
            raise BreakerOpen(
                "model %r breaker is half-open with a canary request "
                "in flight; retry shortly" % e.name, model=e.name,
                retry_after_s=min(1.0, cooldown))
        e.canary_live = True
        e.canary_owner = threading.get_ident()
        e.opened_at = time.monotonic()

    def record_success(self, name):
        """A request for `name` completed: reset the strike count and
        close a half-open breaker (the canary succeeded). An OPEN
        breaker is deliberately NOT closed here — a straggler success
        from a request admitted before the failures must not skip the
        open → half_open → canary discipline and re-hammer the model
        mid-cooldown."""
        # racy lock-free fast path for the overwhelmingly common case
        # (breaker clean): the gateway calls this on EVERY served
        # request, and serializing all handler threads on the registry
        # lock just to re-write fails=0 would be a hot-path tax. Both
        # fields only ever need correcting after an actual failure, so
        # a stale read merely defers the reset to the locked path.
        e = self._entries.get(name)
        if e is None or (e.breaker == "closed" and e.fails == 0):
            return
        with self._cond:
            e = self._entries.get(name)
            if e is None or e.breaker == "open":
                return
            closed = e.breaker == "half_open"
            e.fails = 0
            e.canary_live = False
            e.canary_owner = None
            e.breaker = "closed"
        if closed:
            _health.set_breaker_state(name, "closed",
                                      reason="canary_success")

    def record_failure(self, name, err=None):
        """A load or infer for `name` failed server-side: one breaker
        strike. MXTPU_BREAKER_FAILS consecutive strikes (or any
        half-open canary failure) open the breaker."""
        with self._cond:
            e = self._entries.get(name)
            if e is None:
                return
            e.fails += 1
            e.canary_live = False
            e.canary_owner = None
            opened = (e.breaker == "half_open"
                      or (e.breaker == "closed"
                          and e.fails >= _health.breaker_fails()))
            if opened:
                e.breaker = "open"
                e.opened_at = time.monotonic()
                e.breaker_opens += 1
        if opened:
            _health.BREAKER_OPENS.inc(model=name)
            _health.set_breaker_state(
                name, "open",
                reason=type(err).__name__ if err is not None
                else "failure")

    def breaker_state(self, name):
        with self._cond:
            e = self._entries.get(name)
            return None if e is None else e.breaker

    # ------------------------------------------------------------------
    # budget / eviction
    # ------------------------------------------------------------------
    def set_budget(self, budget_bytes=None, max_models=None):
        """Adjust the budget at runtime (ops/tests/bench) and evict to
        fit immediately. `budget_bytes`/`max_models` <= 0 clears that
        bound; None leaves it unchanged."""
        with self._cond:
            if budget_bytes is not None:
                self.budget_bytes = (int(budget_bytes)
                                     if budget_bytes > 0 else None)
            if max_models is not None:
                self.max_models = (int(max_models)
                                   if max_models > 0 else None)
        self._evict_to_fit()
        return self

    def _release_ledger(self, server, name):
        """Zero the HBM-ledger cells of an evicted/drained model —
        every engine name the server registered under, plus the
        registry name itself (they usually coincide)."""
        try:
            models = set(server.ledger_models())
        except Exception:   # noqa: BLE001 — a bare engine, best-effort
            models = set()
        models.add(name)
        for m in models:
            _memory.release(m)

    def _update_gauges_locked(self):
        resident = [e for e in self._entries.values()
                    if e.state == "resident"]
        _RESIDENT.set(len(resident))
        _RESIDENT_BYTES.set(sum(e.bytes for e in resident))

    def _drain_victim(self, name, server):
        t0 = time.perf_counter()
        server.drain()
        _telemetry.emit({
            "ts": time.time(), "source": "gateway",
            "event": "evict", "step_time": time.perf_counter() - t0,
            "model": name,
        })

    def _evict_to_fit(self, exclude=None):
        """LRU-evict until the resident set fits the budget. The victim
        is detached from the registry FIRST (a concurrent request for
        it starts a transparent reload instead of racing the drain),
        then drained gracefully on a BACKGROUND thread: in-flight work
        finishes, new submits get the model-named ServerClosed — and
        the request that triggered the eviction doesn't pay for (or
        hold a gateway compute slot across) the victim's entire
        queued workload. Detach, thread registration, and start happen
        in ONE critical section against `_closed`, so `drain_all`'s
        snapshot-join can never miss a drain (or join an unstarted
        thread) and nothing is detached after the shutdown sweep."""
        while True:
            with self._cond:
                if self._closed:
                    return      # the drain_all sweep owns the rest
                resident = [e for e in self._entries.values()
                            if e.state == "resident"]
                over_bytes = (self.budget_bytes is not None and
                              sum(e.bytes for e in resident)
                              > self.budget_bytes)
                over_count = (self.max_models is not None and
                              len(resident) > self.max_models)
                if not (over_bytes or over_count):
                    return
                victims = sorted(
                    (e for e in resident if e.name != exclude),
                    key=lambda e: e.last_used)
                if not victims:
                    return
                v = victims[0]
                server, v.server = v.server, None
                v.state = "cold"
                v.bytes = 0
                self._update_gauges_locked()
                self._cond.notify_all()
                th = threading.Thread(
                    target=self._drain_victim, args=(v.name, server),
                    daemon=True, name="gateway-evict-%s" % v.name)
                self._evict_threads = [
                    t for t in self._evict_threads if t.is_alive()]
                self._evict_threads.append(th)
                th.start()
            _EVICTIONS.inc(model=v.name)
            # the ledger and the budget accounting drop together: the
            # victim's cells go to zero the moment it leaves residency
            self._release_ledger(server, v.name)

    def evict(self, name, timeout=None):
        """Explicit unload (admin surface). True when the model was
        resident and is now drained."""
        with self._cond:
            e = self._entries.get(name)
            if e is None or e.state != "resident":
                return False
            server, e.server = e.server, None
            e.state = "cold"
            e.bytes = 0
            self._update_gauges_locked()
            self._cond.notify_all()
        _EVICTIONS.inc(model=name)
        self._release_ledger(server, name)
        return server.drain(timeout)

    # ------------------------------------------------------------------
    # introspection / shutdown
    # ------------------------------------------------------------------
    def models(self):
        with self._cond:
            return sorted(self._entries)

    def resident(self):
        with self._cond:
            return sorted(e.name for e in self._entries.values()
                          if e.state == "resident")

    def resident_bytes(self):
        with self._cond:
            return sum(e.bytes for e in self._entries.values()
                       if e.state == "resident")

    def stats(self):
        with self._cond:
            entries = {
                e.name: {
                    "state": e.state,
                    "bytes": e.bytes,
                    "loads": e.loads,
                    "requests": e.requests,
                    "last_used": e.last_used,
                    "eager": e.eager,
                    "breaker": e.breaker,
                    "breaker_fails": e.fails,
                    "breaker_opens": e.breaker_opens,
                } for e in self._entries.values()}
            return {
                "budget_bytes": self.budget_bytes,
                "max_models": self.max_models,
                "resident": sorted(n for n, s in entries.items()
                                   if s["state"] == "resident"),
                "resident_bytes": sum(
                    s["bytes"] for s in entries.values()
                    if s["state"] == "resident"),
                "reloads": sum(max(0, s["loads"] - 1)
                               for s in entries.values()),
                "ready": self._booted,
                "models": entries,
            }

    def server_states(self):
        """{model: ModelServer.stats()} for every RESIDENT model —
        the /debugz drill-down: forward servers report worker
        backlogs, decode servers report per-scheduler slot occupancy
        (`active_slots` / `max_slots`), queue depths, and eviction
        counts. Snapshotted outside the registry lock (stats() takes
        each server's own locks)."""
        with self._cond:
            servers = {e.name: e.server
                       for e in self._entries.values()
                       if e.state == "resident" and e.server is not None}
        states = {}
        for name, server in servers.items():
            try:
                states[name] = server.stats()
            except Exception as err:  # noqa: BLE001 — debug surface
                states[name] = {"error": str(err)}
        return states

    def drain_all(self, timeout=None):
        """Drain every resident model (gateway shutdown). TERMINAL:
        the registry closes first, so a racing request cannot
        resurrect a model after its drain (further `get`s raise the
        model-named ServerClosed). Joins any background eviction
        drains still in flight. True when everything drained within
        `timeout`."""
        deadline = None if timeout is None \
            else time.perf_counter() + timeout
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            evictions = list(self._evict_threads)
            self._evict_threads = []
        ok = True
        for name in self.models():
            with self._cond:
                e = self._entries[name]
                # an in-flight loader settles its own server (drains
                # it on seeing _closed, keeping the entry "loading"
                # until done) — wait it out so True really means no
                # engine survives this call
                while e.state == "loading":
                    if deadline is not None and \
                            time.perf_counter() >= deadline:
                        ok = False
                        break
                    self._cond.wait(0.05)
                if e.state != "resident":
                    continue
                server, e.server = e.server, None
                e.state = "cold"
                e.bytes = 0
                self._update_gauges_locked()
                self._cond.notify_all()
            wait = None if deadline is None \
                else max(0.0, deadline - time.perf_counter())
            ok = server.drain(wait) and ok
            self._release_ledger(server, name)
        for th in evictions:
            wait = None if deadline is None \
                else max(0.0, deadline - time.perf_counter())
            th.join(wait)
            ok = ok and not th.is_alive()
        return ok
