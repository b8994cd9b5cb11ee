"""ImageRecordIter: the threaded record-file image pipeline (counterpart
of mxnet_tpu/io_record.py; reference: src/io/iter_image_recordio_2.cc:727,
ImageRecordIOParser2: chunk reader -> N decode/augment threads -> batch
collator -> prefetcher).

The stages run on the host, off the card's critical path:

  the native PrefetchLoader (``src/recordio.cc``, its own C++ thread:
  chunked reads and record framing; `_PyRecordChunker` where the native
  library cannot be built)
    -> a ThreadPoolExecutor of `preprocess_threads` workers (JPEG decode
       through libjpeg or PIL, both of which release the GIL, then the
       `image` Augmenter chain per record)
    -> an assembler thread stacking batches (NCHW or NHWC)
    -> a bounded queue of `prefetch_buffer` ready batches.

Batches are host NDArrays, as `NDArrayIter`'s are; the trainer that
consumes them copies them to the card (`ShardedTrainer.prefetched`,
Module ``fit``'s prefetcher). Records, shuffles, crops and batches are
the JAX package's: the shuffle buffer draws from
``np.random.RandomState(seed)``, the decode pool keeps record order, and
the augmenters draw from the global `random`/`np.random` (so they are
deterministic only at one thread, or with deterministic augmenters).

The iterator says which reader and which decoder served it:
``reader`` ("native" or "python") and ``decoders`` (records by
"libjpeg", "pil" or "npy"); the registry counts the same in
``io.record.reader{reader}`` and ``io.record.decoded{decoder}``, beside
``io.record.queue_depth`` (sampled at each pull) and
``io.record.batches``.
"""
from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .base import MXNetError, getenv
from .io import DataIter, DataBatch, DataDesc
from . import image as img_mod
from . import recordio as rio
from .observability import registry as _obs
from .resilience import metrics as _metrics

__all__ = ["ImageRecordIter"]

# queue depth ~0 while the consumer waits: the decode pool cannot keep up
# (raise preprocess_threads / prefetch_buffer); pinned at capacity: the
# consumer is the bottleneck
_QUEUE_DEPTH = _obs.gauge("io.record.queue_depth",
                          "Ready batches in the ImageRecordIter prefetch "
                          "queue, sampled at each consumer pull")
_BATCHES = _obs.counter("io.record.batches",
                        "Batches served by ImageRecordIter")
_READER = _obs.counter("io.record.reader",
                       "ImageRecordIter epochs by record reader (label "
                       "reader: native or python)")
_DECODED = _obs.counter("io.record.decoded",
                        "Records decoded by ImageRecordIter, by decoder "
                        "(label decoder: libjpeg, pil or npy)")


class ImageRecordIter(DataIter):
    """Threaded image-record iterator (reference: io.ImageRecordIter,
    iter_image_recordio_2.cc), with the reference's common knobs;
    ``layout="NHWC"`` emits channels-last batches."""

    def __init__(self, path_imgrec, data_shape, batch_size,
                 label_width=1, shuffle=False, shuffle_chunk_size=None,
                 seed=0, rand_crop=False, rand_mirror=False, resize=-1,
                 mean_r=0.0, mean_g=0.0, mean_b=0.0,
                 std_r=1.0, std_g=1.0, std_b=1.0,
                 preprocess_threads=4, prefetch_buffer=4,
                 round_batch=True, data_name="data",
                 label_name="softmax_label", layout="NCHW",
                 aug_list=None, dtype="float32", part_index=0,
                 num_parts=1, bad_record_budget=None, **kwargs):
        super().__init__(batch_size)
        if len(data_shape) != 3:
            raise MXNetError("data_shape must be (C, H, W)")
        # sharding across workers (the kvstore-fed part_index/num_parts
        # of iter_image_recordio_2.cc): worker k keeps the records whose
        # index is k modulo n
        self._num_parts = int(num_parts)
        self._part_index = int(part_index)
        if not 0 <= self._part_index < self._num_parts:
            raise MXNetError("part_index must be in [0, num_parts)")
        self._path = path_imgrec
        self._data_shape = tuple(int(s) for s in data_shape)
        self._label_width = int(label_width)
        self._shuffle = shuffle
        # records are shuffled over a buffer spanning many batches, not
        # within one chunk (iter_image_recordio_2's shuffle_chunk_size)
        self._shuffle_chunk = int(shuffle_chunk_size or 16 * batch_size)
        self._rng = np.random.RandomState(seed)
        self._threads = max(1, int(preprocess_threads))
        self._depth = max(1, int(prefetch_buffer))
        self._round_batch = round_batch
        self._layout = layout
        if layout not in ("NCHW", "NHWC"):
            raise MXNetError("layout must be NCHW or NHWC")
        self._dtype = np.dtype(dtype)
        # corrupt-input budget: records whose decode fails (a torn JPEG,
        # a bad IRHeader) are skipped up to this count, cumulative across
        # epochs, before the pipeline fails; 0 keeps the reference's
        # die-on-first-bad-record behaviour
        if bad_record_budget is None:
            bad_record_budget = getenv("MXTPU_BAD_RECORD_BUDGET", 0)
        self._bad_budget = int(bad_record_budget)
        self.bad_record_count = 0
        self._bad_lock = threading.Lock()
        self.reader = None
        self.decoders = collections.Counter()

        c, h, w = self._data_shape
        if aug_list is None:
            mean = np.array([mean_r, mean_g, mean_b], np.float32)
            std = np.array([std_r, std_g, std_b], np.float32)
            aug_kwargs = {}
            if resize > 0:
                aug_kwargs["resize"] = resize
            aug_kwargs["rand_crop"] = bool(rand_crop)
            aug_kwargs["rand_mirror"] = bool(rand_mirror)
            if mean.any():
                aug_kwargs["mean"] = mean
            if (std != 1).any():
                aug_kwargs["std"] = std
            aug_list = img_mod.CreateAugmenter(self._data_shape,
                                               **aug_kwargs)
        self._auglist = aug_list

        shp = (batch_size, c, h, w) if layout == "NCHW" \
            else (batch_size, h, w, c)
        self.provide_data = [DataDesc(data_name, shp)]
        lshape = (batch_size,) if label_width == 1 \
            else (batch_size, label_width)
        self.provide_label = [DataDesc(label_name, lshape)]

        self._pool = ThreadPoolExecutor(self._threads)
        self._start()

    # -- pipeline -------------------------------------------------------
    def _start(self):
        from ._native import PrefetchLoader, NativeError, ensure_built
        try:
            ensure_built()
            self._loader = PrefetchLoader(self._path, self.batch_size,
                                          queue_cap=self._depth)
            self.reader = "native"
        except NativeError:
            # the JAX package's documented fallback: a Python reader
            self._loader = _PyRecordChunker(self._path, self.batch_size)
            self.reader = "python"
        _READER.inc(reader=self.reader)
        self._q = queue.Queue(self._depth)
        self._stop = threading.Event()
        self._exhausted = False
        self._assembler = threading.Thread(
            target=self._assemble, args=(self._q, self._stop, self._loader),
            daemon=True)
        self._assembler.start()

    def _decode_one(self, raw):
        header, s = rio.unpack(raw)
        im, how = rio._imdecode_how(s, 1)
        with self._bad_lock:
            self.decoders[how] += 1
        _DECODED.inc(decoder=how)
        im = img_mod.array(im)
        for aug in self._auglist:
            im = aug(im)
        x = im.asnumpy().astype(self._dtype, copy=False)
        if self._layout == "NCHW":
            x = np.transpose(x, (2, 0, 1))
        lbl = np.asarray(header.label, np.float32).reshape(-1)
        if self._label_width == 1:
            lbl = lbl[:1]
        else:
            lbl = lbl[:self._label_width]
        return x, lbl

    def _decode_safe(self, raw):
        """Decode one record under the corrupt-input budget: a failing
        record becomes None (skipped by the collator) while the budget
        lasts, then fails the pipeline with the original error chained
        (it surfaces in next(), like every pipeline fault)."""
        try:
            return self._decode_one(raw)
        except Exception as err:  # noqa: BLE001 — budget-gated below
            with self._bad_lock:
                self.bad_record_count += 1
                nbad = self.bad_record_count
            _metrics.bump("io.bad_records")
            if nbad > self._bad_budget:
                raise MXNetError(
                    "corrupt record %d exceeds the bad-record budget "
                    "of %d (MXTPU_BAD_RECORD_BUDGET) in %s: %s"
                    % (nbad, self._bad_budget, self._path, err)) from err
            import logging
            logging.getLogger("mxnet_tpu_torch.io").warning(
                "%s: skipping corrupt record (%s), %d/%d budget used",
                self._path, err, nbad, self._bad_budget)
            return None

    def _decoded(self, records, stop):
        """The decoded samples of `records` in record order, as they
        finish: at most a window of records is in flight, so a batch
        leaves as soon as its samples are ready (the JAX package decodes
        a whole shuffle buffer before its first batch)."""
        window = max(2 * self.batch_size, 4 * self._threads)
        pending = collections.deque()
        for raw in records:
            if stop.is_set():
                return
            pending.append(self._pool.submit(self._decode_safe, raw))
            if len(pending) >= window:
                yield pending.popleft().result()
        while pending and not stop.is_set():
            yield pending.popleft().result()

    def _assemble(self, q, stop, loader):
        # q/stop/loader arrive as arguments: a reset() that times out
        # waiting for this thread must not let it touch the NEW epoch's
        # queue through self
        carry = []
        buf = []  # shuffle buffer spanning ~shuffle_chunk records
        try:
            def emit(records):
                nonlocal carry
                for s in self._decoded(records, stop):
                    if s is None:
                        continue
                    carry.append(s)
                    if len(carry) == self.batch_size:
                        chunk, carry = carry, []
                        self._put(q, stop, self._collate(chunk, pad=0))

            rec_idx = 0  # position in the whole record stream
            for records in loader:
                if stop.is_set():
                    return
                if self._num_parts > 1:
                    kept = [r for i, r in enumerate(records, rec_idx)
                            if i % self._num_parts == self._part_index]
                    rec_idx += len(records)
                    records = kept
                if self._shuffle:
                    buf.extend(records)
                    if len(buf) >= self._shuffle_chunk:
                        self._rng.shuffle(buf)
                        chunk, buf = buf, []
                        emit(chunk)
                else:
                    emit(list(records))
            if buf and not stop.is_set():
                self._rng.shuffle(buf)
                emit(buf)
            if carry and self._round_batch:
                pad = self.batch_size - len(carry)
                carry = carry + [carry[-1]] * pad
                self._put(q, stop, self._collate(carry, pad=pad))
        except Exception as e:  # surface in next()
            self._put(q, stop, e)
            return
        self._put(q, stop, None)

    @staticmethod
    def _put(q, stop, item):
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _collate(self, samples, pad):
        data = np.stack([s[0] for s in samples])
        labels = np.stack([s[1] for s in samples])
        if self._label_width == 1:
            labels = labels[:, 0]
        return DataBatch([img_mod.array(data)], [img_mod.array(labels)],
                         pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)

    # -- DataIter protocol ---------------------------------------------
    def next(self):
        if self._exhausted:
            raise StopIteration  # repeatedly, as the reference does; a
            # blocking get() here would wait on no producer
        _QUEUE_DEPTH.set(self._q.qsize())
        item = self._q.get()
        if item is None:
            self._exhausted = True
            raise StopIteration
        if isinstance(item, Exception):
            self._exhausted = True
            raise item
        _BATCHES.inc()
        return item

    def _drain(self):
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                return

    def _shutdown(self):
        """Stop the assembler before freeing the native loader: closing
        the loader while the assembler is inside its next() would be a
        use-after-free in the C++ layer."""
        self._stop.set()
        self._drain()  # unblocks an assembler stuck in _put
        self._assembler.join(timeout=10)
        self._drain()
        try:
            self._loader.close()
        except Exception:
            pass

    def reset(self):
        self._shutdown()
        self._start()

    def close(self):
        self._shutdown()
        self._pool.shutdown(wait=False)


class _PyRecordChunker:
    """The chunk source where the native library is unavailable: lists of
    raw records read through `recordio.MXRecordIO`."""

    def __init__(self, path, batch_records):
        self._rec = rio.MXRecordIO(path, "r")
        self._n = batch_records
        self._closed = False

    def __iter__(self):
        chunk = []
        while not self._closed:
            raw = self._rec.read()
            if raw is None:
                break
            chunk.append(raw)
            if len(chunk) == self._n:
                yield chunk
                chunk = []
        if chunk:
            yield chunk

    def close(self):
        self._closed = True
        self._rec.close()
