"""Profiler (counterpart of mxnet_tpu/profiler.py; reference:
src/profiler/, python/mxnet/profiler.py).

Two layers in one trace, as the reference splits them:

1. Device and host timeline: while the profiler runs (`set_state("run")`
   or `start()`), a `torch.profiler` session records the CUDA kernels
   (on a card), the host's ATen calls and the port's spans (the training
   loops' ``step/<phase>`` ranges, `observability.span`).
2. The reference's own host events: scoped objects (`Task`, `Frame`,
   `Event`), `Marker`s, `Counter`s and each `mx.nd` operator call
   (`record_op`, from `ndarray.invoke`), kept with their wall times and
   in the per-name aggregate table `dumps()` formats.

`dump()` stops the session and writes ``<filename>.json``: ONE chrome
trace (chrome://tracing, Perfetto) holding torch's events (kernels, host
calls, spans) and the host events above (markers as instant events,
counters as "C" rows). Operator rows measure the host's dispatch: the
device work is asynchronous, and the kernels are its truth.

One profiler session at a time: `set_state("run")` raises `MXNetError`
when another `torch.profiler` session is already recording in this
process, instead of nesting into it silently.

``filename`` defaults to ``$TMPDIR/mxtpu_profile``.
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
import time
import weakref

import torch

from .base import MXNetError
from .observability.span import profiling

__all__ = ["Counter", "Domain", "Event", "Frame", "Marker", "Task", "dump",
           "dumps", "record_op", "set_config", "set_state", "start",
           "stop"]

_config = {"filename": os.path.join(tempfile.gettempdir(), "mxtpu_profile"),
           "profile_all": False, "profile_imperative": True,
           "aggregate_stats": True}
_running = {"on": False, "prof": None, "done": None, "anchor": None}
_ANCHOR = "mx.profiler.start"
_aggregate = {}
_events = []
_lock = threading.Lock()
_counters = weakref.WeakSet()
_counters_lock = threading.Lock()


def set_config(**kwargs):
    """Profiler options (``filename``, ``profile_imperative``, ...)."""
    _config.update(kwargs)


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def set_state(state="stop", profile_process="worker"):
    """``"run"`` starts the session, ``"stop"`` ends it (kept for
    `dump`)."""
    if state in ("run", True):
        if _running["on"]:
            return
        if profiling():
            raise MXNetError(
                "mx.profiler: a torch.profiler session is already "
                "recording in this process; stop it before "
                "set_state('run') (one session at a time)")
        prof = torch.profiler.profile(activities=_activities())
        prof.__enter__()
        # an anchor in torch's timeline at a known host time: dump shifts
        # the host events onto torch's clock by it
        t0 = time.perf_counter()
        with torch.profiler.record_function(_ANCHOR):
            pass
        _running.update(on=True, prof=prof, done=None, anchor=t0)
    elif _running["on"]:
        prof = _running["prof"]
        _running.update(on=False, prof=None)
        prof.__exit__(None, None, None)
        _running["done"] = prof


def start():
    set_state("run")


def stop():
    set_state("stop")


def _active():
    return _running["on"]


def _host_ts(t):
    """A perf_counter stamp in microseconds (`dump` moves these onto
    torch's clock)."""
    return t * 1e6


def _shift(events, torch_events):
    """Move host events onto torch's clock through the session's anchor
    (unshifted when torch's trace lacks it)."""
    anchor = _running.get("anchor")
    mark = next((e for e in torch_events if e.get("name") == _ANCHOR
                 and "ts" in e), None)
    if anchor is None or mark is None:
        return events
    offset = float(mark["ts"]) - _host_ts(anchor)
    return [dict(e, ts=e["ts"] + offset) if "ts" in e else e
            for e in events]


def _record_event(name, t0, t1, cat="op", args=None):
    ev = {"name": name, "ph": "X", "cat": cat, "ts": _host_ts(t0),
          "dur": (t1 - t0) * 1e6, "pid": os.getpid(),
          "tid": threading.get_ident() & 0xffff}
    if args:
        ev["args"] = args
    with _lock:
        _events.append(ev)
        calls, total = _aggregate.get(name, (0, 0.0))
        _aggregate[name] = (calls + 1, total + (t1 - t0))


def record_op(name, t0, t1):
    """The hook of `mx.nd` operator dispatch (`ndarray.invoke`)."""
    if _running["on"] and _config.get("profile_imperative"):
        _record_event(name, t0, t1, cat="operator")


def _torch_events(prof):
    """The session's chrome-trace events, through torch's own export."""
    if prof is None:
        return []
    fd, path = tempfile.mkstemp(suffix=".json", prefix="mxtpu_torch_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)


def dump(finished=True, profile_process="worker"):
    """Stop the session and write ``<filename>.json`` (the reference's
    MXDumpProfile): torch's events, then the host events and counters.
    Returns the path written."""
    set_state("stop")
    path = _config["filename"] + ".json"
    events = _torch_events(_running["done"])
    with _lock:
        host = list(_events)
        if finished:
            _events.clear()
    if finished:
        _running["done"] = None
    meta = [{"name": "process_name", "ph": "M", "pid": os.getpid(),
             "args": {"name": "mxnet_tpu_torch host"}}]
    out = os.path.dirname(os.path.abspath(path))
    os.makedirs(out, exist_ok=True)
    host = _shift(host + _counter_events(clear=finished), events)
    with open(path, "w") as f:
        json.dump({"traceEvents": meta + events + host,
                   "displayTimeUnit": "ms"}, f)
    return path


def dumps(reset=False):
    """The aggregate table of the host events (the reference's
    MXAggregateProfileStatsPrint)."""
    with _lock:
        items = sorted(_aggregate.items())
        if reset:
            _aggregate.clear()
    lines = ["%-40s %10s %12s %12s" % ("Name", "Calls", "Total(ms)",
                                       "Avg(ms)")]
    for name, (calls, total) in items:
        lines.append("%-40s %10d %12.3f %12.3f"
                     % (name, calls, total * 1e3, total * 1e3 / calls))
    return "\n".join(lines)


class _Scope:
    """A user-scoped profiling object: a host event, and a
    `record_function` range in torch's timeline while the profiler
    runs (reference: profiler.py:210-400)."""

    _cat = "scope"

    def __init__(self, name):
        self.name = name
        self._t0 = None
        self._range = None

    def start(self):
        self._t0 = time.perf_counter()
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()

    def stop(self):
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None
            _record_event(self.name, self._t0, time.perf_counter(),
                          cat=self._cat)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()
        return False


class Task(_Scope):
    _cat = "task"

    def __init__(self, domain=None, name="task"):
        super().__init__(name)


class Frame(_Scope):
    _cat = "frame"

    def __init__(self, domain=None, name="frame"):
        super().__init__(name)


class Event(_Scope):
    _cat = "event"

    def __init__(self, name="event"):
        super().__init__(name)


class Marker:
    """An instant event (recorded only while the profiler runs)."""

    def __init__(self, domain=None, name="marker"):
        self.name = name

    def mark(self, scope="process"):
        if not _running["on"]:
            return
        now = time.perf_counter()
        _record_event(self.name, now, now, cat="marker")


def _counter_events(clear=False):
    """Chrome-trace "C" events of every live Counter: each sample taken
    while profiling, and the value at dump time."""
    now_ts = _host_ts(time.perf_counter())
    pid = os.getpid()
    events = []
    with _counters_lock:
        live = list(_counters)
    for c in live:
        with c._lock:
            samples = list(c._samples)
            if clear:
                c._samples.clear()
            value = c.value
        for ts, v in samples:
            events.append({"name": c.name, "ph": "C", "cat": "counter",
                           "ts": _host_ts(ts), "pid": pid,
                           "args": {"value": v}})
        events.append({"name": c.name, "ph": "C", "cat": "counter",
                       "ts": now_ts, "pid": pid, "args": {"value": value}})
    return events


class Counter:
    """A named counter whose value lands in the trace as "C" events;
    samples are kept while the profiler runs."""

    def __init__(self, domain=None, name="counter", value=0):
        self.name = name
        self.value = value
        self._lock = threading.Lock()
        self._samples = []
        with _counters_lock:
            _counters.add(self)

    def _mutate(self, fn):
        with self._lock:
            self.value = fn(self.value)
            if _running["on"]:
                self._samples.append((time.perf_counter(), self.value))

    def set_value(self, value):
        self._mutate(lambda _: value)

    def increment(self, delta=1):
        self._mutate(lambda v: v + delta)

    def decrement(self, delta=1):
        self._mutate(lambda v: v - delta)


class Domain:
    def __init__(self, name):
        self.name = name
