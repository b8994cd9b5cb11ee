"""Distributed tracing: W3C trace contexts, cross-thread propagation,
rank-tagged span shards (a copy of mxnet_tpu/observability/trace.py;
the record schema, env knobs and shard layout are the JAX package's, so
`tools/trace_report.py` merges either package's shards).

The `span()` API records host spans into the profiler's trace — but
only while the profiler runs, only with thread-local
parentage, and only inside one process. This module is the *request-
and step-scoped* tracing plane on top:

- `TraceContext` is a W3C ``traceparent`` identity (trace id, parent
  span id, sampled flag). The gateway accepts/emits the header; every
  serving request and every training step carries a context;
- spans survive **thread-pool hops**: the submitting thread captures
  its context (`capture()` / the request object's `trace` slot), the
  executing thread restores it (`attached(ctx)`), so a span opened on
  a batcher/gateway worker thread parents to the submitting request
  instead of becoming an orphaned root;
- every finished span lands in a bounded in-memory ring (``/debugz``)
  and — when a shard directory is configured — as one JSONL line in a
  **rank-tagged shard** (``trace_rank_<r>.jsonl``), which
  `tools/trace_report.py` merges into one Perfetto/chrome trace with
  per-rank clock alignment;
- **step traces are deterministic across ranks**: the trace id is a
  hash of (gang dir, source, step), so rank 0's allreduce span and
  rank 1's land in the SAME merged trace without any wire protocol;
- `device_annotation()` wraps device dispatch in a
  ``torch.profiler.record_function`` range named by the trace id, so
  host spans line up with the CUDA kernels in the torch profiler's
  timeline.

Env knobs (re-read per use — so tests/long jobs can toggle live —
except MXTPU_TRACE_BUFFER, which sizes the ring once at import):

  MXTPU_TRACE          0 disables the whole plane (contexts, spans,
                       shards all become no-ops)                  (1)
  MXTPU_TRACE_SAMPLE   fraction of new roots that record spans
                       (step traces hash-sample deterministically
                       so all ranks agree)                      (1.0)
  MXTPU_TRACE_DIR      span shard directory; falls back to
                       MXTPU_GANG_DIR (supervised ranks), else
                       spans stay in-memory only             (unset)
  MXTPU_TRACE_BUFFER   in-memory ring size, in spans           (4096)

Sampling gates *recording*, not identity: an unsampled request still
carries (and echoes) its trace id — it just writes no spans.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import secrets
import threading
import time
from collections import deque

from ..base import getenv

__all__ = ["TraceContext", "trace_span", "record_span", "current",
           "capture", "attached", "device_annotation", "enabled",
           "sample_rate", "shard_dir", "shard_path", "ring_spans",
           "reset_ring", "trace_stats", "step_trace_context",
           "current_rank"]

# wall/perf clock pair captured at import: every span's `ts` is wall
# time derived from perf_counter stamps (monotonic within the process),
# so one process's spans never interleave wrongly even if NTP steps
# the wall clock mid-run
_CLOCK_WALL = time.time()
_CLOCK_PERF = time.perf_counter()


def _wall(perf_t):
    return _CLOCK_WALL + (perf_t - _CLOCK_PERF)


def enabled():
    return bool(getenv("MXTPU_TRACE", True))


def sample_rate():
    return float(getenv("MXTPU_TRACE_SAMPLE", 1.0))


def current_rank():
    """This process's gang/dist rank (0 outside a gang) — the shard
    tag and the `rank` attr on every span."""
    r = os.environ.get("JAX_PROCESS_ID") or os.environ.get(
        "DMLC_WORKER_ID")
    try:
        return int(r)
    except (TypeError, ValueError):
        return 0


def _new_id(nbytes):
    return secrets.token_hex(nbytes)


class TraceContext:
    """One W3C trace identity: ``trace_id`` (32 hex), ``span_id`` (16
    hex — the *current parent*: the remote caller's span for an
    incoming ``traceparent``, the innermost local span while a
    `trace_span` is active, or None for a fresh root), ``sampled``."""

    __slots__ = ("trace_id", "span_id", "sampled")

    def __init__(self, trace_id, span_id=None, sampled=True):
        self.trace_id = trace_id
        self.span_id = span_id
        self.sampled = bool(sampled)

    @classmethod
    def new(cls, sampled=None):
        """Fresh root context. `sampled` defaults to a coin flip at
        MXTPU_TRACE_SAMPLE (identity is always created — an unsampled
        request still echoes its trace id, it just records nothing)."""
        if sampled is None:
            rate = sample_rate()
            sampled = rate >= 1.0 or (
                rate > 0.0 and
                int(_new_id(4), 16) / float(0xffffffff) < rate)
        return cls(_new_id(16), None, sampled)

    @classmethod
    def from_traceparent(cls, header):
        """Parse a ``traceparent`` header (version 00). Returns None on
        anything malformed — a bad header means a fresh root, never an
        error surfaced to the client."""
        if not header or not isinstance(header, str):
            return None
        parts = header.strip().lower().split("-")
        if len(parts) < 4:
            return None
        version, trace_id, span_id, flags = parts[:4]
        if len(version) != 2 or version == "ff":
            return None
        if len(trace_id) != 32 or trace_id == "0" * 32:
            return None
        if len(span_id) != 16 or span_id == "0" * 16:
            return None
        try:
            int(trace_id, 16), int(span_id, 16)
            sampled = bool(int(flags, 16) & 0x01)
        except ValueError:
            return None
        return cls(trace_id, span_id, sampled)

    def to_traceparent(self):
        # a root context has no span id yet; the spec forbids the
        # all-zero parent id, so an unsampled root (which never opens
        # a span) echoes a synthetic one — the trace id is the part
        # the caller correlates on
        return "00-%s-%s-%02x" % (self.trace_id,
                                  self.span_id or _new_id(8),
                                  0x01 if self.sampled else 0x00)

    def __repr__(self):
        return ("TraceContext(%s, span=%s, sampled=%s)"
                % (self.trace_id, self.span_id, self.sampled))


def step_trace_context(source, step):
    """Deterministic per-step context: the trace id hashes (gang dir |
    pid, source, step), so every rank of a supervised gang lands its
    step-S spans in the SAME trace id, and `tools/trace_report.py` can
    merge shards into one per-step timeline with zero coordination.
    The sampling verdict hashes too — ranks always agree."""
    if not enabled():
        return None
    token = os.environ.get("MXTPU_GANG_DIR") or ("pid:%d" % os.getpid())
    digest = hashlib.sha256(
        ("mxtpu-step:%s:%s:%d" % (token, source, int(step)))
        .encode()).hexdigest()
    rate = sample_rate()
    sampled = rate >= 1.0 or (
        rate > 0.0 and int(digest[32:40], 16) / float(0xffffffff) < rate)
    return TraceContext(digest[:32], None, sampled)


# -- thread-local context -----------------------------------------------
_tls = threading.local()


def current():
    """The calling thread's active `TraceContext`, or None."""
    return getattr(_tls, "ctx", None)


def _set_current(ctx):
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = ctx
    return prev


def capture():
    """Snapshot the calling thread's trace context for a thread-pool
    handoff: stash the return value at submit time, `attached()` it on
    the executing thread. (The request objects in `serving/` carry
    this in their `trace` slot automatically.)"""
    return current()


@contextlib.contextmanager
def attached(ctx):
    """Restore a captured context on the executing thread: spans opened
    inside parent to the *submitting* request instead of orphaning."""
    prev = _set_current(ctx)
    try:
        yield ctx
    finally:
        _tls.ctx = prev


# -- span sink: in-memory ring + rank-tagged shard file -----------------
_ring_lock = threading.Lock()
_ring = deque(maxlen=int(getenv("MXTPU_TRACE_BUFFER", 4096)))
_shard_lock = threading.Lock()
_shard = {"path": None, "file": None, "warned": False}


def shard_dir():
    """Where span shards go: MXTPU_TRACE_DIR, else the gang directory
    (supervised training ranks shard next to their heartbeats), else
    None (ring buffer only)."""
    return (os.environ.get("MXTPU_TRACE_DIR")
            or os.environ.get("MXTPU_GANG_DIR") or None)


def shard_path():
    d = shard_dir()
    if not d:
        return None
    return os.path.join(d, "trace_rank_%d.jsonl" % current_rank())


def _shard_file():
    """Open (or re-resolve) this process's shard, writing one `clock`
    record at open so the merger can map this rank's perf-derived
    timestamps and estimate cross-rank offsets."""
    path = shard_path()
    if path is None:
        return None
    with _shard_lock:
        if _shard["path"] != path or _shard["file"] is None:
            if _shard["file"] is not None:
                try:
                    _shard["file"].close()
                except OSError:
                    pass
                _shard["path"], _shard["file"] = None, None
            try:
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                f = open(path, "a", buffering=1)
            except OSError as err:
                if not _shard["warned"]:
                    _shard["warned"] = True
                    import warnings
                    warnings.warn(
                        "trace shard %s not writable (%s); spans stay "
                        "in-memory" % (path, err), RuntimeWarning)
                return None
            _shard["path"], _shard["file"] = path, f
            clock = {"source": "trace", "event": "clock",
                     "step_time": 0.0, "ts": time.time(),
                     "perf": time.perf_counter(),
                     "rank": current_rank(), "pid": os.getpid()}
            try:
                f.write(json.dumps(clock, sort_keys=True) + "\n")
            except (OSError, ValueError):
                pass
        return _shard["file"]


def close_shard():
    """Close the shard file (tests; the next span reopens in append)."""
    with _shard_lock:
        if _shard["file"] is not None:
            try:
                _shard["file"].close()
            except OSError:
                pass
        _shard["path"], _shard["file"] = None, None
        _shard["warned"] = False


def ring_spans(trace_id=None, limit=None):
    """Recent finished spans from the in-memory ring (newest last),
    optionally filtered to one trace id — the `/debugz` surface."""
    with _ring_lock:
        spans = list(_ring)
    if trace_id is not None:
        spans = [s for s in spans if s.get("trace_id") == trace_id]
    return spans[-limit:] if limit else spans


def reset_ring():
    with _ring_lock:
        _ring.clear()


def trace_stats():
    """Point-in-time plane state for `/debugz`."""
    with _ring_lock:
        spans = list(_ring)
    traces = {}
    for s in spans:
        traces.setdefault(s.get("trace_id"), 0)
        traces[s["trace_id"]] += 1
    return {
        "enabled": enabled(),
        "sample_rate": sample_rate(),
        "shard": shard_path(),
        "ring_spans": len(spans),
        "ring_traces": len(traces),
        "recent_trace_ids": list(traces)[-8:],
    }


#: record_span default: inherit the parent from ctx.span_id (pass
#: None explicitly to force a root span)
_INHERIT = object()


def record_span(name, ctx, t0, t1, parent_id=_INHERIT, span_id=None,
                **attrs):
    """Record one finished span (perf_counter stamps) into the ring +
    shard under `ctx`'s trace. `parent_id` defaults to ``ctx.span_id``
    (the submitting/enclosing span); pass None for an explicit root.
    Returns the span id (chain it as another record's `parent_id` for
    retroactive sub-spans — batch consumers reconstruct per-request
    queue/compute spans this way), or None when the context is
    absent/unsampled/disabled — recording is best-effort and never
    raises into the traced path."""
    if ctx is None or not ctx.sampled or not enabled():
        return None
    span_id = span_id or _new_id(8)
    rec = {"source": "trace", "event": "span", "name": name,
           "trace_id": ctx.trace_id, "span_id": span_id,
           "parent_id": ctx.span_id if parent_id is _INHERIT
           else parent_id,
           "ts": _wall(t0), "step_time": max(0.0, t1 - t0),
           "rank": current_rank(), "pid": os.getpid(),
           "tid": threading.get_ident() & 0xffff}
    if attrs:
        rec.update({k: v for k, v in attrs.items() if v is not None})
    with _ring_lock:
        _ring.append(rec)
    f = _shard_file()
    if f is not None:
        try:
            with _shard_lock:
                f.write(json.dumps(rec, sort_keys=True) + "\n")
        except (OSError, ValueError, TypeError):
            pass
    return span_id


class trace_span:
    """Context manager recording one span under the thread's (or an
    explicitly `ctx=`-passed) trace context. While active, the thread's
    current context points at this span, so nested `trace_span`s and
    queue submits parent correctly. A no-op (one attr read, no
    allocation beyond the object) when tracing is off, the context is
    absent, or the trace is unsampled."""

    __slots__ = ("name", "attrs", "ctx", "span_id", "_t0", "_prev",
                 "_parent", "_on", "_t0_override")

    def __init__(self, name, ctx=None, t0=None, **attrs):
        self.name = name
        self.attrs = attrs
        self.ctx = ctx
        self.span_id = None
        self._t0_override = t0

    def __enter__(self):
        parent = self.ctx if self.ctx is not None else current()
        self._on = (parent is not None and parent.sampled and enabled())
        if not self._on:
            # still make an explicitly-passed root context current, so
            # children opened inside inherit identity (for the echoed
            # trace id) even when unsampled
            if self.ctx is not None:
                self._prev = _set_current(self.ctx)
                self._parent = None
            else:
                self._prev, self._parent = False, None
            return self
        self.span_id = _new_id(8)
        self._parent = parent.span_id
        self.ctx = parent
        self._prev = _set_current(
            TraceContext(parent.trace_id, self.span_id, True))
        self._t0 = self._t0_override if self._t0_override is not None \
            else time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        if not self._on:
            if self._prev is not False:
                _tls.ctx = self._prev
            return False
        _tls.ctx = self._prev
        attrs = self.attrs
        if exc_type is not None:
            attrs = dict(attrs, error=exc_type.__name__)
        # record with OUR span id (not a fresh one) so children that
        # captured the context while we were active resolve to a real
        # recorded span; self._parent is None for roots, which
        # record_span keeps as an explicit root (no inherit)
        record_span(self.name, self.ctx, self._t0, time.perf_counter(),
                    parent_id=self._parent, span_id=self.span_id,
                    **attrs)
        return False


def device_annotation(ctx=None, name=None):
    """A ``torch.profiler.record_function`` range naming the trace id,
    wrapped around device dispatch so the profiler's kernel rows
    correlate with host spans (`name` defaults to ``trace:<id>``).
    Returns a null context when there is nothing to annotate or no
    profiler records."""
    ctx = ctx if ctx is not None else current()
    if ctx is None or not ctx.sampled or not enabled():
        return contextlib.nullcontext()
    from .span import profiling
    if not profiling():
        return contextlib.nullcontext()
    import torch
    return torch.profiler.record_function(
        name or ("trace:%s" % ctx.trace_id))
