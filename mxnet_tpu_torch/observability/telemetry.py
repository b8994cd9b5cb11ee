"""Per-step training telemetry: `StepTimer` and the JSONL stream
(counterpart of mxnet_tpu/observability/telemetry.py).

Two layers, as in the JAX package:

1. Counters (always on): what the port compiles (``compile.count`` and
   ``compile.seconds``), kvstore wire bytes, input batch waits and the
   step-time histogram accumulate in the process-wide registry whatever
   the environment says.
2. Step records (off by default): with ``MXTPU_TELEMETRY=<path>`` set,
   every training step appends ONE JSON line to <path>, keys sorted, in
   the JAX package's schema: ``ts``, ``source``, ``step``, ``step_time``,
   ``data_wait``, ``compile_count``, ``compile_seconds``,
   ``kvstore_bytes``; then the deltas of the optional counters, each
   omitted when zero (``allreduce_*``, ``bucket_*``,
   ``update_dispatches``, ``fused_*``, ``skipped_steps``, ``anomalies``,
   ``step_dispatches``, ``step_flops`` and the derived ``mfu``); then
   ``loss_scale`` (once a loss scaler is armed), ``<phase>_time`` for each
   phase, ``batch_size``, ``samples_per_sec`` and ``trace_id``. So
   `tools/telemetry_report.py` and `tools/perf_gate.py` read either
   package's stream unchanged. Other records share the stream: the
   checkpoint's ``{"source": "resilience", "event": "ckpt_commit"}``, the
   numerics guard's and the gang supervisor's events, serving's.

What counts as a compile. The JAX package counts XLA's backend compiles
through `jax.monitoring`; torch has no such event. The port counts what
it builds itself: a graph function (`graph.build_graph_fn`, behind the
executor, `CachedOp` and each `InferenceEngine` bucket), a CUDA-graph
capture of `ShardedTrainer`'s step, and each nvcc build of a kernel
source (`ops._build`), each through `note_compile(seconds)`. The
persistent compile cache's ``compile_cache_hits``/``misses`` have no
counterpart yet (ROADMAP A9b), so those fields never appear.

Also the producer/consumer attribution of batch pulls
(`mark_producer_thread`, `is_producer_thread`). The env var is re-read
per step, so a job can turn streaming on or off without a restart.
"""
from __future__ import annotations

import json
import os
import threading
import time
import warnings

from . import trace as _trace
from .registry import REGISTRY, counter, histogram
from .span import span

__all__ = ["COMPILE_COUNT", "COMPILE_SECONDS", "STEP_SECONDS", "StepTimer",
           "close_stream", "emit", "is_producer_thread",
           "mark_producer_thread", "note_compile", "stream_enabled",
           "stream_path"]

COMPILE_COUNT = counter(
    "compile.count",
    "Builds the port made itself: graph functions, CUDA-graph captures "
    "of the train step and nvcc builds of kernel sources")
COMPILE_SECONDS = counter("compile.seconds",
                          "Seconds spent in those builds")
STEP_SECONDS = histogram("train.step.seconds",
                         "Training step wall time (end-to-end)")
_KV_BYTE_COUNTERS = (counter("kvstore.push.bytes"),
                     counter("kvstore.pull.bytes"),
                     counter("kvstore.allreduce.bytes"))
_BATCH_WAIT = histogram("io.batch_wait.seconds",
                        "Time the consumer blocked waiting for a batch")


def note_compile(seconds):
    """Count one build of `seconds` (the torch counterpart of the JAX
    package's compile listener)."""
    COMPILE_COUNT.inc()
    COMPILE_SECONDS.inc(max(0.0, float(seconds)))

_lock = threading.Lock()
_thread_role = threading.local()


def mark_producer_thread():
    """Tag the calling thread as an input-pipeline producer (a prefetch
    worker): its batch pulls overlap the consumer's compute, so the
    iterators count them in ``io.batch_assemble.seconds``, not in the
    consumer's ``io.batch_wait.seconds``."""
    _thread_role.producer = True


def is_producer_thread():
    return getattr(_thread_role, "producer", False)
_stream = {"path": None, "file": None, "warned": False}


def stream_path():
    """The ``MXTPU_TELEMETRY`` destination, or None."""
    return os.environ.get("MXTPU_TELEMETRY") or None


def stream_enabled():
    return stream_path() is not None


def _stream_file():
    path = stream_path()
    if path is None:
        return None
    with _lock:
        if _stream["path"] != path or _stream["file"] is None:
            if _stream["file"] is not None:
                try:
                    _stream["file"].close()
                except OSError:
                    pass
                _stream["path"], _stream["file"] = None, None
            try:
                f = open(path, "a", buffering=1)
            except OSError as err:
                if not _stream["warned"]:
                    _stream["warned"] = True
                    warnings.warn("MXTPU_TELEMETRY=%s not writable (%s); "
                                  "records disabled" % (path, err),
                                  RuntimeWarning)
                return None
            _stream["path"], _stream["file"] = path, f
        return _stream["file"]


def emit(record):
    """Append one JSON object to the stream (False when it is unset or
    cannot be written). Never raises."""
    f = _stream_file()
    if f is None:
        return False
    line = json.dumps(record, sort_keys=True)
    try:
        with _lock:
            f.write(line + "\n")
    except (OSError, ValueError):
        return False
    return True


def close_stream():
    """Close the stream (the next `emit` reopens it in append mode)."""
    with _lock:
        if _stream["file"] is not None:
            try:
                _stream["file"].close()
            except OSError:
                pass
        _stream["path"], _stream["file"] = None, None
        _stream["warned"] = False


# -- StepTimer ----------------------------------------------------------
def _counter_total(name):
    """Total of a registry counter that may not be registered yet."""
    m = REGISTRY.get(name)
    return m.total() if m is not None and hasattr(m, "total") else 0


def _hist_totals(name):
    """(sum, count) of a maybe-unregistered registry histogram."""
    m = REGISTRY.get(name)
    if m is None or not hasattr(m, "total_sum"):
        return 0.0, 0
    return m.total_sum(), m.total_count()


def _counters_snapshot():
    fill_sum, _ = _hist_totals("kvstore.bucket.fill_ratio")
    pack_s, _ = _hist_totals("kvstore.bucket.pack.seconds")
    unpack_s, _ = _hist_totals("kvstore.bucket.unpack.seconds")
    ar_s, _ = _hist_totals("kvstore.allreduce.seconds")
    fused_pack_s, _ = _hist_totals("optimizer.fused.pack.seconds")
    fused_update_s, _ = _hist_totals("optimizer.fused.update.seconds")
    return {
        "compile_count": COMPILE_COUNT.total(),
        "compile_seconds": COMPILE_SECONDS.total(),
        "kvstore_bytes": sum(c.total() for c in _KV_BYTE_COUNTERS),
        "data_wait": _BATCH_WAIT.total_sum(),
        "allreduce_calls": _counter_total("kvstore.allreduce.calls"),
        "allreduce_bytes": _counter_total("kvstore.allreduce.bytes"),
        "allreduce_seconds": ar_s,
        "bucket_count": _counter_total("kvstore.bucket.count"),
        "bucket_fill_sum": fill_sum,
        "bucket_pack_seconds": pack_s,
        "bucket_unpack_seconds": unpack_s,
        "update_dispatches": _counter_total("optimizer.update.dispatches"),
        "fused_groups": _counter_total("optimizer.fused.groups"),
        "fused_pack_seconds": fused_pack_s,
        "fused_update_seconds": fused_update_s,
        # the numerics guard's: tools/perf_gate.py fails a run that skips
        "skipped_steps": _counter_total("numerics.skipped_steps"),
        "anomalies": _counter_total("numerics.anomalies"),
        # launches of the step's exchange + update
        # (--max-dispatches-per-step)
        "step_dispatches": _counter_total("train.step.dispatches"),
        "step_flops": _counter_total("goodput.flops"),
    }


_OPTIONAL = ("allreduce_calls", "allreduce_bytes", "allreduce_seconds",
             "bucket_count", "bucket_fill_sum", "bucket_pack_seconds",
             "bucket_unpack_seconds", "update_dispatches", "fused_groups",
             "fused_pack_seconds", "fused_update_seconds", "skipped_steps",
             "anomalies", "step_dispatches", "step_flops")


class _Phase:
    """One named phase of a step: its wall time accumulates into the
    timer, and it is a profiler span (``step/<name>``) and a trace child
    of the step's root."""

    __slots__ = ("_timer", "_name", "_t0", "_span", "_tspan")

    def __init__(self, timer, name):
        self._timer = timer
        self._name = name
        self._span = span("step/" + name)
        self._tspan = _trace.trace_span(name)

    def __enter__(self):
        self._span.__enter__()
        self._tspan.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self._tspan.__exit__(*exc)
        self._span.__exit__(*exc)
        phases = self._timer._phases
        phases[self._name] = phases.get(self._name, 0.0) + dt
        return False


class StepTimer:
    """Per-step telemetry for a training loop (JAX telemetry.py:255)::

        timer = StepTimer("gluon.trainer")
        timer.begin_step()
        with timer.phase("optimizer"):
            ...
        timer.end_step(batch_size=bs)

    `end_step` returns the record and, with ``MXTPU_TELEMETRY`` set,
    emits it. Its ``step_time`` runs from the previous `end_step` to now,
    so the forward, the backward and the data wait outside begin/end are
    in it; the first step's starts at its `begin_step`. The counter
    fields are the deltas of the process counters over that window.

    Host time only: no phase synchronizes the card, so a phase's time is
    what the host spent in it, and the step's time is the host's
    iteration time (on the card, a loop that waits for a result each step
    makes it the device's). One timer per loop; not thread-safe.
    """

    def __init__(self, source="train"):
        self.source = source
        self.step = 0
        self._phases = {}
        self._last_end = None
        self._snap = None
        self._trace_span = None

    def begin_step(self):
        # a step that never reached end_step: drop its phase times and
        # close its abandoned trace root
        self._phases = {}
        if self._trace_span is not None:
            self._trace_span.__exit__(None, None, None)
            self._trace_span = None
        first = self._last_end is None
        if first:
            self._last_end = time.perf_counter()
            self._snap = _counters_snapshot()
        # the live plane: /metricsz and /debugz when MXTPU_METRICS_PORT
        from . import httpz as _httpz
        _httpz.maybe_start()
        # the step's trace root: its id hashes (gang dir, source, step),
        # so every rank's step S shares one trace; it starts at the
        # previous step's end, so the root covers the whole iteration
        ctx = _trace.step_trace_context(self.source, self.step)
        if ctx is not None:
            sp = _trace.trace_span("step", ctx=ctx, t0=self._last_end,
                                   step=self.step, source=self.source)
            sp.__enter__()
            self._trace_span = sp
            now = time.perf_counter()
            if not first and sp.span_id and now - self._last_end > 1e-6:
                # the forward/backward window before the trainer's step
                _trace.record_span("fwd_bwd", _trace.current(),
                                   self._last_end, now)

    def phase(self, name):
        return _Phase(self, name)

    def end_step(self, batch_size=None, **extra):
        """Close the step: observe ``train.step.seconds`` and, streaming,
        emit the record. Returns the record either way."""
        now = time.perf_counter()
        if self._last_end is None:     # end without begin
            self._last_end = now
            self._snap = _counters_snapshot()
        step_time = now - self._last_end
        self._last_end = now
        snap = _counters_snapshot()
        prev, self._snap = self._snap, snap
        record = {
            "ts": time.time(),
            "source": self.source,
            "step": self.step,
            "step_time": step_time,
            "data_wait": max(0.0, snap["data_wait"] - prev["data_wait"]),
            "compile_count": snap["compile_count"] - prev["compile_count"],
            "compile_seconds": max(
                0.0, snap["compile_seconds"] - prev["compile_seconds"]),
            "kvstore_bytes": snap["kvstore_bytes"] - prev["kvstore_bytes"],
        }
        for field in _OPTIONAL:
            delta = snap[field] - prev.get(field, 0)
            if delta:
                record[field] = delta
        if record.get("step_flops") and step_time > 0:
            from . import goodput as _goodput
            mfu = _goodput.mfu_value(record["step_flops"], step_time,
                                     source=self.source)
            if mfu is not None:
                record["mfu"] = mfu
        # the loss scale once a scaler armed it: a gauge, not a delta
        scale_gauge = REGISTRY.get("numerics.loss_scale")
        if scale_gauge is not None and scale_gauge.labelsets():
            record["loss_scale"] = scale_gauge.get()
        for name, secs in self._phases.items():
            record[name + "_time"] = secs
        self._phases = {}
        if batch_size:
            record["batch_size"] = batch_size
            if step_time > 0:
                record["samples_per_sec"] = batch_size / step_time
        record.update(extra)
        trace_id = None
        if self._trace_span is not None:
            if self._trace_span.span_id:
                trace_id = self._trace_span.ctx.trace_id
                record["trace_id"] = trace_id
            self._trace_span.__exit__(None, None, None)
            self._trace_span = None
        self.step += 1
        # the worst steps keep their trace ids as exemplars
        STEP_SECONDS.observe(step_time, exemplar=trace_id,
                             source=self.source)
        if stream_path() is not None:
            emit(record)
        return record
