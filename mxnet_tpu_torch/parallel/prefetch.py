"""Host-to-device double buffering for input pipelines (counterpart of
mxnet_tpu/parallel/prefetch.py: `DevicePrefetcher` :34, `stage_databatch`
:122; reference: src/io/iter_prefetcher.h).

A daemon thread pulls item k+1..k+depth from the (possibly slow) source
and stages each while the consumer trains on item k. On the card the
staging runs on a side CUDA stream of the prefetcher's own: host arrays
go through pinned memory and are copied with ``non_blocking=True``, so
the copy overlaps the consumer's kernels; an event recorded after each
item's copies is what the consumer's stream waits on before it uses the
item, and every staged tensor is marked as used on the consumer's stream
(`Tensor.record_stream`), so the allocator does not hand its memory back
to the side stream while the consumer's kernels still read it.

The time the consumer blocks on the queue feeds the same histogram as
`io.DataIter`'s own waits, ``io.batch_wait.seconds``; the worker thread
is marked a producer, so its own pulls from a DataIter count in
``io.batch_assemble.seconds`` instead.
"""
from __future__ import annotations

import queue
import threading
import time
import warnings

import numpy as np
import torch

from ..context import resolve_device
from ..ndarray import NDArray
from ..observability import registry as _obs
from ..observability.telemetry import mark_producer_thread

__all__ = ["DevicePrefetcher", "stage_databatch", "to_device"]

_END = object()

_BATCH_WAIT = _obs.histogram("io.batch_wait.seconds",
                             "Time the consumer blocked waiting for a batch")


def to_device(x, device):
    """`x` (a tensor, an NDArray's tensor, or an array) as a tensor on
    `device`. A host tensor bound for the card is copied through pinned
    memory with ``non_blocking=True`` on the current stream."""
    if isinstance(x, NDArray):
        x = x._data
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    if device.type == "cuda" and x.device.type == "cpu":
        if not x.is_pinned():
            x = x.pin_memory()
        return x.to(device, non_blocking=True)
    return x.to(device)


def _tensors(obj):
    """The tensors inside a staged item (tensors, NDArrays, lists and
    tuples of them, DataBatches)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, NDArray):
        yield obj._data
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif hasattr(obj, "data") and hasattr(obj, "label"):
        yield from _tensors(obj.data or [])
        yield from _tensors(obj.label or [])


class DevicePrefetcher:
    """Iterate `source`, running `stage(item)` on a background thread and
    keeping up to `depth` staged items ready (reference
    iter_prefetcher.h's buffer; 2 is classic double buffering).

    `device`: the device `stage` copies to; a CUDA device gives the
    staging a side stream and the consumer's stream an event to wait on
    (see the module's note). Exceptions in the source or in `stage`
    reach the consumer at its `next()`. `close()` stops the thread and
    joins it."""

    def __init__(self, source, stage=None, depth=2, device=None):
        if depth < 1:
            raise ValueError("DevicePrefetcher: depth must be >= 1")
        self._source = iter(source)
        self._stage = stage or (lambda x: x)
        dev = None if device is None else resolve_device(device)
        self._stream = torch.cuda.Stream(device=dev) \
            if dev is not None and dev.type == "cuda" else None
        self._q = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _staged(self, item):
        if self._stream is None:
            return self._stage(item), None
        with torch.cuda.stream(self._stream):
            staged = self._stage(item)
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return staged, ready

    def _worker(self):
        mark_producer_thread()
        try:
            for item in self._source:
                staged = self._staged(item)
                while not self._stop.is_set():
                    try:
                        self._q.put(staged, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
            self._q.put(_END)
        except BaseException as e:  # noqa: BLE001 — relayed to consumer
            self._q.put(e)

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        t0 = time.perf_counter()
        item = self._q.get()
        _BATCH_WAIT.observe(time.perf_counter() - t0)
        if item is _END:
            self._stop.set()
            raise StopIteration
        if isinstance(item, BaseException):
            self._stop.set()
            raise item
        staged, ready = item
        if ready is not None:
            consumer = torch.cuda.current_stream(self._stream.device)
            consumer.wait_event(ready)
            for t in _tensors(staged):
                if t.device.type == "cuda":
                    t.record_stream(consumer)
        return staged

    next = __next__  # DataIter-style alias

    def close(self, timeout=2.0):
        """Stop the background thread without draining the source, and
        join it (at most `timeout` seconds): once this returns True no
        stale worker can pull from a source that the caller resets and
        iterates again (as `fit` does each epoch)."""
        self._stop.set()
        deadline = time.monotonic() + timeout
        while self._thread.is_alive() and time.monotonic() < deadline:
            # unblock a worker waiting on a full queue, repeatedly: it may
            # complete one more put after each drain before seeing _stop
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(0.1)
        if self._thread.is_alive():
            warnings.warn(
                "DevicePrefetcher.close: worker still blocked in the source "
                "after %.1fs; it may consume one more batch before exiting"
                % timeout, RuntimeWarning)
            return False
        return True


def stage_databatch(batch, device=None):
    """One io.DataBatch's arrays staged onto `device` (default: the
    current context's) as NDArrays, in a NEW DataBatch: iterators that
    recycle one batch object must not see batch k's arrays swapped while
    the consumer still trains on them. A list of batches stages each;
    anything without ``data`` passes through."""
    if isinstance(batch, list):
        return [stage_databatch(b, device) for b in batch]
    if not hasattr(batch, "data"):
        return batch
    from ..io import DataBatch
    dev = resolve_device(device)

    def put(x):
        return NDArray(to_device(x, dev))

    return DataBatch(
        data=([put(d) for d in batch.data]
              if batch.data is not None else None),
        label=([put(d) for d in batch.label]
               if batch.label is not None else None),
        pad=batch.pad, index=batch.index,
        bucket_key=getattr(batch, "bucket_key", None),
        provide_data=getattr(batch, "provide_data", None),
        provide_label=getattr(batch, "provide_label", None))
