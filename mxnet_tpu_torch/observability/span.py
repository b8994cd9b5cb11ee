"""Host-side span tracing with thread-local parent propagation
(counterpart of mxnet_tpu/observability/span.py).

`span("name", **attrs)` is a context manager; nested spans record their
parent's name. Where the JAX package feeds its own profiler's event
stream, a span here is a `torch.profiler.record_function` range, so host
spans, the port's op launches and the CUDA kernels land in ONE
`torch.profiler` timeline.

Spans only record while the torch profiler is running. The disabled path
is one flag read per `__enter__` — no allocation beyond the span object,
no timestamps — so spans can stay in hot paths permanently.

`capture_context`/`restored` carry a request's span stack and its
distributed `TraceContext` across a thread hop (the batcher's and the
decode scheduler's threads).
"""
from __future__ import annotations

import contextlib
import threading

import torch

from . import trace as _trace

__all__ = ["span", "current_span", "capture_context", "restored",
           "profiling"]

_tls = threading.local()


def profiling():
    """True while a torch profiler records on this process."""
    try:
        return bool(torch.autograd.profiler._is_profiler_enabled)
    except AttributeError:
        return False


def _stack():
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def current_span():
    """Name of the innermost active span on this thread, or None."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def capture_context():
    """Snapshot the calling thread's span context — the legacy span
    name stack AND the distributed `TraceContext` — for crossing a
    thread-pool boundary. A span opened on a worker thread used to
    become an orphaned root because the parent lived in the submitting
    thread's thread-local; capture at submit, `restored()` at
    execution, and it parents to the submitting request instead.
    Cheap when nothing is active: an empty tuple copy + one attr read."""
    stack = getattr(_tls, "stack", None)
    return (tuple(stack) if stack else (), _trace.capture())


@contextlib.contextmanager
def restored(captured):
    """Install a `capture_context()` snapshot on the executing thread
    for the duration of the block (both the span parent stack and the
    trace context), restoring the thread's own context after."""
    stack, ctx = captured if captured else ((), None)
    prev_stack = getattr(_tls, "stack", None)
    _tls.stack = list(stack)
    with _trace.attached(ctx):
        try:
            yield
        finally:
            _tls.stack = prev_stack if prev_stack is not None else []


class span:
    """Context manager recording a host span as a
    `torch.profiler.record_function` range named `name` (its parent and
    any keyword attrs appended as ``name[k=v ...]``)."""

    __slots__ = ("name", "attrs", "_range", "_active")

    def __init__(self, name, **attrs):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        self._active = profiling()
        if self._active:
            stack = _stack()
            parent = stack[-1] if stack else None
            stack.append(self.name)
            args = dict(self.attrs, parent=parent) if parent else self.attrs
            label = self.name
            if args:
                label += "[%s]" % " ".join(
                    "%s=%s" % (k, args[k]) for k in sorted(args))
            self._range = torch.profiler.record_function(label)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._active:
            stack = _stack()
            if stack and stack[-1] == self.name:
                stack.pop()
            self._range.__exit__(*exc)
        return False
