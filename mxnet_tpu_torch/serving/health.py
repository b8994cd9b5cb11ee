"""Serving resilience plane: shared state machinery and typed errors
(a copy of mxnet_tpu/serving/health.py, docs/fault_tolerance.md
"Serving resilience").

This module is the serving stack's integration point with the
`HealthWatchdog`. It holds what `server`/`scheduler`/`gateway` all need
and nothing engine-specific:

- **watchdog-bounded dispatch**: `guard()` runs one engine dispatch
  under `HealthWatchdog.guard_dispatch` when
  ``MXTPU_SERVE_DISPATCH_TIMEOUT_S`` > 0 (default 0: the plain direct
  call, bit-identical to the unguarded path). The chaos sites —
  ``engine.dispatch`` plus the replica-addressed
  ``serving.replica<k>.dispatch`` — fire INSIDE the guarded closure,
  so an injected ``kind=hang`` is exactly the wedge the deadline
  bounds.
- **replica health accounting**: the `serving.replica.state` gauge
  (healthy=0 / quarantined=1 / dead=2 per (server, replica)), trip /
  quarantine / readmit / worker-death counters, capped
  ``MXTPU_SERVE`` stderr markers (tools/chaos_run.py's
  no-injection-detected evidence), and ``source="serving"`` telemetry
  events.
- **typed failure surface**: `NoHealthyReplica` (requests fail typed
  ONLY when no replica survives), `SchedulerCrashed` (a dead decode
  loop names itself instead of stranding its queue), `BreakerOpen`
  (the gateway's per-model circuit breaker refusal, carrying the
  `Retry-After` hint).

Env knobs (docs/fault_tolerance.md "Serving resilience"):
  MXTPU_SERVE_DISPATCH_TIMEOUT_S  dispatch deadline      (0 = off)
  MXTPU_SERVE_TRIP_LIMIT          watchdog trips before a replica is
                                  quarantined            (3)
  MXTPU_SERVE_CANARY_S            canary probe interval for
                                  quarantined replicas   (0.5)
  MXTPU_BREAKER_FAILS             consecutive failures opening a
                                  model's breaker        (3)
  MXTPU_BREAKER_COOLDOWN_S        open -> half-open cooldown (5)
  MXTPU_GATEWAY_HEDGE_MS          interactive hedge delay in ms, or
                                  ``auto`` (p95-derived) (0 = off)
"""
from __future__ import annotations

import sys
import threading
import time

from ..base import MXNetError, getenv
from ..observability import registry as _obs
from ..observability import telemetry as _telemetry
from ..resilience import chaos_point
from ..resilience.watchdog import DeviceUnreachable, HealthWatchdog
from .batcher import RequestRejected, ServerClosed

__all__ = ["NoHealthyReplica", "SchedulerCrashed", "BreakerOpen",
           "DeviceUnreachable", "HealthWatchdog", "guard",
           "dispatch_timeout", "trip_limit", "canary_interval",
           "breaker_fails", "breaker_cooldown", "hedge_delay_ms",
           "replica_site", "set_replica_state", "set_breaker_state",
           "marker", "emit_event", "REPLICA_STATES", "BREAKER_STATES"]

#: replica health machine (docs/fault_tolerance.md): healthy replicas
#: take traffic; a quarantined replica is skipped by dispatch until
#: its canary probe succeeds; a dead replica (worker thread exited)
#: never comes back within this server's life
REPLICA_STATES = {"healthy": 0, "quarantined": 1, "dead": 2}
#: breaker machine: closed admits, open refuses instantly
#: (Retry-After), half_open admits ONE canary request
BREAKER_STATES = {"closed": 0, "half_open": 1, "open": 2}

REPLICA_STATE = _obs.gauge(
    "serving.replica.state",
    "replica health: 0 healthy / 1 quarantined / 2 dead "
    "(labels server, replica)")
REPLICA_TRIPS = _obs.counter(
    "serving.replica.trips",
    "dispatch-watchdog trips attributed to a serving replica "
    "(labels server, replica)")
REPLICA_QUARANTINES = _obs.counter(
    "serving.replica.quarantines",
    "replicas quarantined after MXTPU_SERVE_TRIP_LIMIT trips "
    "(labels server, replica)")
REPLICA_READMITS = _obs.counter(
    "serving.replica.readmits",
    "quarantined replicas re-admitted by a successful canary probe "
    "(labels server, replica)")
WORKER_DEATHS = _obs.counter(
    "serving.worker.deaths",
    "serving worker threads that died outside a request scope "
    "(labels server, replica)")
LOOP_CRASHES = _obs.counter(
    "serving.decode.loop_crash",
    "decode scheduler loops that crashed (label scheduler) — every "
    "stranded request is rejected typed, never left hanging")
BREAKER_STATE = _obs.gauge(
    "serving.breaker.state",
    "per-model circuit breaker: 0 closed / 1 half_open / 2 open "
    "(label model)")
BREAKER_OPENS = _obs.counter(
    "serving.breaker.opens",
    "circuit breakers opened after MXTPU_BREAKER_FAILS consecutive "
    "failures (label model)")
HEDGE_FIRED = _obs.counter(
    "serving.hedge.fired",
    "interactive requests duplicated to another replica after the "
    "hedge delay (label model)")
HEDGE_WON = _obs.counter(
    "serving.hedge.won",
    "hedged requests where the DUPLICATE answered first "
    "(label model)")


# ----------------------------------------------------------------------
# env knobs (read per call: tests and chaos drills flip them live)
# ----------------------------------------------------------------------
def dispatch_timeout():
    return float(getenv("MXTPU_SERVE_DISPATCH_TIMEOUT_S", 0.0))


def trip_limit():
    return max(1, int(getenv("MXTPU_SERVE_TRIP_LIMIT", 3)))


def canary_interval():
    return max(0.05, float(getenv("MXTPU_SERVE_CANARY_S", 0.5)))


def breaker_fails():
    return max(1, int(getenv("MXTPU_BREAKER_FAILS", 3)))


def breaker_cooldown():
    return max(0.05, float(getenv("MXTPU_BREAKER_COOLDOWN_S", 5.0)))


def hedge_delay_ms():
    """The interactive hedge delay: a float in ms, ``"auto"`` (derive
    from the observed p95 at the call site), or None when hedging is
    off (the default)."""
    raw = str(getenv("MXTPU_GATEWAY_HEDGE_MS", "0")).strip().lower()
    if raw in ("auto", "p95"):
        return "auto"
    try:
        ms = float(raw)
    except ValueError:
        raise MXNetError(
            "MXTPU_GATEWAY_HEDGE_MS must be a number of milliseconds "
            "or 'auto', got %r" % raw)
    return ms if ms > 0 else None


# ----------------------------------------------------------------------
# typed failure surface
# ----------------------------------------------------------------------
class NoHealthyReplica(MXNetError):
    """Every replica of a server is dead or quarantined — the ONE case
    where a request fails instead of riding a surviving replica
    (graceful degradation's floor). `server` names the engine.
    `recovering` is True when at least one replica is quarantined
    (canary-recoverable) rather than dead — a transient condition the
    gateway's circuit breaker must NOT count as a model failure."""

    def __init__(self, msg, server=None, recovering=False):
        super().__init__(msg)
        self.server = server
        self.recovering = bool(recovering)


class SchedulerCrashed(ServerClosed):
    """A decode scheduler loop died on a non-request-scoped error; its
    queued and in-flight requests were rejected with this (never left
    to hang), and new submits are refused. `server` names the
    scheduler."""


class BreakerOpen(RequestRejected):
    """The model's circuit breaker is open: the request is refused
    instantly (no builder hammering, no compute). `retry_after_s` is
    the cooldown remaining — the gateway surfaces it as a
    `Retry-After` header."""

    def __init__(self, msg, model=None, retry_after_s=None):
        super().__init__(msg)
        self.model = model
        self.retry_after_s = retry_after_s


# ----------------------------------------------------------------------
# markers + events
# ----------------------------------------------------------------------
_marker_lock = threading.Lock()
_marker_budget = [64]    # capped: a flapping replica must not flood


def marker(event, **fields):
    """One capped ``MXTPU_SERVE <event> k=v ...`` line on stderr — the
    machine-grepable evidence tools/chaos_run.py's --wedge-replica
    no-injection-detected guard requires (mirrors MXTPU_NUMERICS)."""
    with _marker_lock:
        if _marker_budget[0] <= 0:
            return
        _marker_budget[0] -= 1
    kv = " ".join("%s=%s" % (k, fields[k]) for k in sorted(fields))
    print("MXTPU_SERVE %s %s" % (event, kv), file=sys.stderr,
          flush=True)


def emit_event(event, duration_s=0.0, **fields):
    """One ``source="serving"`` resilience record on the telemetry
    stream (excluded from headline percentiles like every event
    source; tools/telemetry_report.py's serving-resilience section
    counts them)."""
    if not _telemetry.stream_enabled():
        return
    rec = {"ts": time.time(), "source": "serving", "event": event,
           "step_time": float(duration_s)}
    rec.update(fields)
    _telemetry.emit(rec)


def set_replica_state(server, index, state, reason=None):
    """Flip one replica's health state everywhere it is observable:
    gauge, stderr marker, telemetry event."""
    REPLICA_STATE.set(REPLICA_STATES[state], server=str(server),
                      replica=str(index))
    marker("replica_state", server=server, replica=index, state=state,
           reason=reason or "-")
    emit_event("replica_state", server=str(server), replica=int(index),
               state=state, reason=reason or "-")


def record_trip(server, replica, kind="trip"):
    """One dispatch-watchdog trip attributed to a replica — the shared
    counter+marker triple for BOTH state-machine copies (ModelServer
    workers and decode schedulers), so the two can never drift
    apart in what they emit."""
    REPLICA_TRIPS.inc(server=str(server), replica=str(replica))
    marker(kind, server=server, replica=replica)


def record_quarantine(server, replica):
    REPLICA_QUARANTINES.inc(server=str(server), replica=str(replica))
    set_replica_state(server, replica, "quarantined",
                      reason="watchdog")


def record_readmit(server, replica):
    REPLICA_READMITS.inc(server=str(server), replica=str(replica))
    set_replica_state(server, replica, "healthy", reason="canary")


def set_breaker_state(model, state, reason=None):
    BREAKER_STATE.set(BREAKER_STATES[state], model=str(model))
    marker("breaker_state", model=model, state=state,
           reason=reason or "-")
    emit_event("breaker", model=str(model), state=state,
               reason=reason or "-")


# ----------------------------------------------------------------------
# watchdog-bounded dispatch
# ----------------------------------------------------------------------
def replica_site(index):
    """The replica-addressed chaos site ModelServer worker `index`
    (and its canary probe) draws from — how a chaos run wedges ONE
    replica of N (tools/chaos_run.py --wedge-replica)."""
    return "serving.replica%d.dispatch" % int(index)


def guard(watchdog, fn, what, sites=("engine.dispatch",)):
    """Run one engine dispatch, watchdog-bounded when
    ``MXTPU_SERVE_DISPATCH_TIMEOUT_S`` > 0. The chaos `sites` fire
    INSIDE the dispatched closure so an injected hang is bounded by
    the same deadline a real wedge would be. With the timeout unset
    (the default) this is the plain direct call — no extra thread, no
    behavior change — and the chaos points still arm.

    A trip raises `DeviceUnreachable` (typed, diagnosable, counted
    under ``resilience.watchdog.trips{kind=dispatch}``); the caller
    owns the replica-level consequences (trip accounting, quarantine,
    re-dispatch)."""
    def dispatch():
        for site in sites:
            chaos_point(site)
        return fn()

    t = dispatch_timeout()
    if t <= 0 or watchdog is None:
        return dispatch()
    return watchdog.guard_dispatch(dispatch, what=what, timeout_s=t)
