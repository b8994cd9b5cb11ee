"""Deadline-bounded serving dispatch with holder diagnostics
(counterpart of the dispatch half of mxnet_tpu/resilience/watchdog.py).

`HealthWatchdog.guard_dispatch()` bounds one SERVING engine dispatch: a
wedged dispatch trips as a typed `DeviceUnreachable` in bounded time —
the port's one error for a card that is not there
(`mxnet_tpu_torch.context.DeviceUnreachable`), carrying the lease
holder's diagnostics — and the replica health machinery in
`serving.server`/`serving.scheduler` quarantines the replica instead of
letting every request on it hang forever. The dispatch runs on a
persistent daemon worker (a wedged device call cannot be cancelled from
Python); later guards fall back to ephemeral threads while it is held.

Every trip is counted (`resilience.watchdog.trips{kind=dispatch}`) and,
when ``MXTPU_TELEMETRY`` streams, recorded as a `source="resilience"`
`watchdog_trip` event. `guard_init()` bounds the distributed
rendezvous the same way (kind=init, raising `DeadlineExceeded` with the
diagnostics), on the same worker. The JAX package's collective guard has
its port in `parallel.kvstore_dist`, whose collectives and barriers poll
their own deadlines and the gang's peer check.

Env knobs: ``MXTPU_SERVE_DISPATCH_TIMEOUT_S`` — the serving-dispatch
deadline (0, the default: the plain direct call, bit-identical);
``MXTPU_WATCHDOG_INIT_S`` — the rendezvous deadline (180; 0 unguarded).
"""
from __future__ import annotations

import logging
import threading
import time

from ..base import getenv
from ..context import DeviceUnreachable
from ..observability import registry as _obs
from ..observability import telemetry as _tele
from . import lease as _lease
from .retry import DeadlineExceeded

__all__ = ["DeviceUnreachable", "HealthWatchdog", "diagnostics"]

TRIPS = _obs.counter(
    "resilience.watchdog.trips",
    "Watchdog deadline trips (label kind: init / collective / "
    "dispatch)")

_log = logging.getLogger("mxnet_tpu_torch.resilience")


def _read_proc(pid, name):
    try:
        with open("/proc/%d/%s" % (pid, name), "rb") as f:
            return f.read().decode("utf-8", "replace")
    except OSError:
        return ""


def diagnostics(lease_path=None):
    """One-string dump for a tripped watchdog: the lease holder (the
    prime suspect for an init hang) and its /proc state — enough for a
    post-mortem without a live session."""
    path = lease_path or _lease.default_lease_path()
    lines = []
    rec = _lease.read_lease(path)
    if rec is None:
        lines.append("lease %s: no holder recorded" % path)
    else:
        age = time.time() - float(rec.get("heartbeat",
                                          rec.get("created", 0.0)))
        lines.append(
            "lease %s: holder pid %s on %s (role %r), heartbeat %.1fs "
            "ago (takeover at %.6gs)"
            % (path, rec.get("pid"), rec.get("host"), rec.get("what"),
               age, rec.get("takeover_s", 0.0)))
        pid = rec.get("pid")
        if isinstance(pid, int) and pid > 0:
            stat = _read_proc(pid, "stat")
            if stat:
                fields = stat.rsplit(")", 1)[-1].split()
                state = fields[0] if fields else "?"
                lines.append("holder /proc: state %s  cmdline %r  "
                             "wchan %s"
                             % (state,
                                _read_proc(pid, "cmdline")
                                .replace("\0", " ").strip()[:120],
                                _read_proc(pid, "wchan").strip() or "?"))
            else:
                lines.append("holder /proc: pid %d is gone" % pid)
    return "\n".join(lines)


class HealthWatchdog:
    """The serving dispatch's deadline policy (module docstring). One
    instance per replica is fine — state is the budget and the guard
    worker."""

    def __init__(self, lease_path=None, init_timeout_s=None):
        self.dispatch_timeout_s = float(
            getenv("MXTPU_SERVE_DISPATCH_TIMEOUT_S", 0.0))
        self.init_timeout_s = float(
            init_timeout_s if init_timeout_s is not None
            else getenv("MXTPU_WATCHDOG_INIT_S", 180.0))
        self.lease_path = lease_path
        # persistent guard worker (a fresh thread per dispatch would tax
        # the serving hot path); lazily started, single-slot
        self._worker_lock = threading.Lock()
        self._worker_q = None
        self._worker_busy = False

    # -- guard worker ---------------------------------------------------
    def _worker_loop(self, q):
        while True:
            fn, box, done = q.get()
            try:
                box["result"] = fn()
            except BaseException as err:  # delivered via the box
                box["error"] = err
            # the WORKER clears its own busy flag (a guard that gave
            # up on this dispatch is long gone; the worker must become
            # reusable the moment the stuck call returns), and clears
            # it BEFORE done.set() so the waiter's very next guarded
            # dispatch finds it free instead of racing into the
            # ephemeral-thread fallback
            with self._worker_lock:
                self._worker_busy = False
            done.set()

    def _submit(self, fn, what):
        """Run `fn` off-thread, returning its (box, done) pair. Reuses
        ONE persistent daemon worker; when that worker is wedged
        holding a previous dispatch that never returned (a tripped
        deadline — the process is suspect but may still be unwinding),
        falls back to an ephemeral thread so the guard itself never
        blocks."""
        box, done = {}, threading.Event()
        with self._worker_lock:
            if not self._worker_busy:
                if self._worker_q is None:
                    import queue
                    self._worker_q = queue.Queue()
                    threading.Thread(
                        target=self._worker_loop,
                        args=(self._worker_q,), daemon=True,
                        name="watchdog-guard-worker").start()
                self._worker_busy = True
                self._worker_q.put((fn, box, done))
                return box, done

        def target():
            try:
                box["result"] = fn()
            except BaseException as err:
                box["error"] = err
            done.set()
        threading.Thread(target=target, daemon=True,
                         name="deadline:%s" % what).start()
        return box, done

    def guard_dispatch(self, fn, what="engine dispatch",
                       timeout_s=None):
        """Run one serving engine dispatch under a deadline; a trip
        raises a typed `DeviceUnreachable` (kind=dispatch) with holder
        diagnostics — the wedged-device signal the serving replica
        health machinery quarantines on. `timeout_s` None falls back
        to ``MXTPU_SERVE_DISPATCH_TIMEOUT_S``; <= 0 means unguarded:
        the plain direct call, bit-identical to the unguarded path."""
        t = float(timeout_s if timeout_s is not None
                  else self.dispatch_timeout_s)
        if t <= 0:
            return fn()
        box, done = self._submit(fn, what)
        if not done.wait(timeout=t):
            diag = self._trip("dispatch", what, t)
            raise DeviceUnreachable(
                "%s did not complete within %.6gs — the device "
                "dispatch is wedged (the call still blocks a daemon "
                "thread)" % (what, t), diag)
        if "error" in box:
            raise box["error"]
        return box.get("result")

    def guard_init(self, fn, what="backend init", timeout_s=None):
        """Run init-shaped work (the rendezvous, which can block forever
        on a dead coordinator) on the guard worker under a deadline; a
        trip raises `DeadlineExceeded` carrying the diagnostics (the call
        stays blocked on its thread). `timeout_s` <= 0: the plain call."""
        t = float(timeout_s if timeout_s is not None
                  else self.init_timeout_s)
        if t <= 0:
            return fn()
        box, done = self._submit(fn, what)
        if not done.wait(timeout=t):
            diag = self._trip("init", what, t)
            raise DeadlineExceeded("%s did not complete within %.6gs\n%s"
                                   % (what, t, diag))
        if "error" in box:
            raise box["error"]
        return box.get("result")

    def _trip(self, kind, what, budget):
        TRIPS.inc(kind=kind)
        diag = diagnostics(self.lease_path)
        _log.error("watchdog trip (%s): %s exceeded %.6gs\n%s",
                   kind, what, budget, diag)
        _tele.emit({"ts": time.time(), "source": "resilience",
                    "event": "watchdog_trip", "kind": kind,
                    "what": what, "step_time": float(budget)})
        return diag
