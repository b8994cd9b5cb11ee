"""Data iterators, their in-memory part (counterpart of mxnet_tpu/io.py:
`DataDesc` :43, `DataBatch` :70, `DataIter` :94, `ResizeIter` :154,
`NDArrayIter` :336; reference: python/mxnet/io.py).

`NDArrayIter` serves in-memory arrays in batches: shuffled from the
global numpy RNG when asked (at construction and at every reset, as the
JAX package does), with the last partial batch padded by wrapping
around ("pad"), dropped ("discard") or carried into the next epoch
("roll_over"). Its batches are host (CPU) NDArrays, as MXNet's are: the
executor that consumes them copies them to its device.

The file iterators follow the JAX package's: `CSVIter` (:425) and
`MNISTIter` (:455) read their files into an `NDArrayIter`, `LibSVMIter`
(:500) emits `ndarray.sparse.CSRNDArray` batches, `PrefetchingIter`
(:204) pulls from its iterators on background threads, and
`ImageRecordIter` (`io_record.py`) resolves lazily (:491). Every
``next(it)`` passes the ``io.read`` injection site first, retried under
``MXTPU_IO_RETRIES`` (only the gate is retried: a queue-backed iterator
must never replay ``next()``).
"""
from __future__ import annotations

import threading
import time
from collections import namedtuple

import numpy as np

from .base import getenv
from .context import cpu
from .ndarray import NDArray, array as _nd_array
from .observability import registry as _obs
from .observability.telemetry import is_producer_thread
from .resilience.chaos import chaos_point
from .resilience.retry import RetryPolicy, TransientError, retry_call

# consumer-side data-stall telemetry: how long next() blocked before a
# batch was ready; pulls made on prefetch producer threads overlap the
# consumer's compute and count as assembly time instead
_BATCH_WAIT = _obs.histogram("io.batch_wait.seconds",
                             "Time the consumer blocked waiting for a batch")
_BATCH_ASSEMBLE = _obs.histogram(
    "io.batch_assemble.seconds",
    "Batch pull/assembly time on prefetch producer threads")

__all__ = ["DataDesc", "DataBatch", "DataIter", "NDArrayIter", "CSVIter",
           "ImageRecordIter", "LibSVMIter", "ResizeIter", "PrefetchingIter",
           "MNISTIter"]


def nd_array(x):
    """A host NDArray of numpy `x`."""
    return _nd_array(x, ctx=cpu())


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    """Data layout description (reference: io.py:DataDesc)."""

    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, tuple(shape))
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape, self.dtype,
                                          self.layout)

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")

    @staticmethod
    def get_list(shapes, types):
        if types is not None:
            type_dict = dict(types)
            return [DataDesc(x[0], x[1], type_dict[x[0]]) for x in shapes]
        return [DataDesc(x[0], x[1]) for x in shapes]


class DataBatch:
    """One mini-batch (reference: io.py:DataBatch)."""

    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            data = [data]
        if label is not None and not isinstance(label, (list, tuple)):
            label = [label]
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label

    def __str__(self):
        data_shapes = [d.shape for d in self.data]
        label_shapes = [l.shape for l in self.label] if self.label else None
        return "{}: data shapes: {} label shapes: {}".format(
            self.__class__.__name__, data_shapes, label_shapes)


class DataIter:
    """Base iterator (reference: io.py:182)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def _io_retry_policy(self):
        pol = getattr(self, "_io_retry_pol", None)
        if pol is None:     # one per iterator: no env parse per batch
            pol = self._io_retry_pol = RetryPolicy(
                max_attempts=getenv("MXTPU_IO_RETRIES", 8),
                base_delay=getenv("MXTPU_RETRY_BASE_DELAY_S", 0.01),
                max_delay=0.5, retry_on=(TransientError,), what="io.read")
        return pol

    def __next__(self):
        # the `io.read` injection site; only the gate is retried
        retry_call(chaos_point, "io.read", policy=self._io_retry_policy())
        t0 = time.perf_counter()
        batch = self.next()
        hist = _BATCH_ASSEMBLE if is_producer_thread() else _BATCH_WAIT
        hist.observe(time.perf_counter() - t0)
        return batch

    def iter_next(self):
        raise NotImplementedError

    def getdata(self):
        raise NotImplementedError

    def getlabel(self):
        raise NotImplementedError

    def getindex(self):
        return None

    def getpad(self):
        raise NotImplementedError


class ResizeIter(DataIter):
    """Resize the epoch length of another iterator (reference: io.py:284)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size
        if hasattr(data_iter, "default_bucket_key"):
            self.default_bucket_key = data_iter.default_bucket_key

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


class PrefetchingIter(DataIter):
    """Background-thread prefetcher (reference: io.py:349; the C++ analog
    is iter_prefetcher.h). Overlaps host batch assembly with device work."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        self.n_iter = len(iters)
        assert self.n_iter > 0
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0][1][0]
        self.data_ready = [threading.Event() for _ in range(self.n_iter)]
        self.data_taken = [threading.Event() for _ in range(self.n_iter)]
        for e in self.data_taken:
            e.set()
        self.started = True
        self.current_batch = [None for _ in range(self.n_iter)]
        self.next_batch = [None for _ in range(self.n_iter)]

        def prefetch_func(self, i):
            while True:
                self.data_taken[i].wait()
                if not self.started:
                    break
                try:
                    self.next_batch[i] = self.iters[i].next()
                except StopIteration:
                    self.next_batch[i] = None
                self.data_taken[i].clear()
                self.data_ready[i].set()

        self.prefetch_threads = [
            threading.Thread(target=prefetch_func, args=[self, i], daemon=True)
            for i in range(self.n_iter)]
        for thread in self.prefetch_threads:
            thread.start()

    def __del__(self):
        self.started = False
        for e in self.data_taken:
            e.set()

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([[
            DataDesc(r[x.name], x.shape, x.dtype)
            if isinstance(x, DataDesc) else DataDesc(*x)
            for x in i.provide_data
        ] for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([[
            DataDesc(r[x.name], x.shape, x.dtype)
            if isinstance(x, DataDesc) else DataDesc(*x)
            for x in i.provide_label
        ] for r, i in zip(self.rename_label, self.iters)], [])

    def reset(self):
        for e in self.data_ready:
            e.wait()
        for i in self.iters:
            i.reset()
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()

    def iter_next(self):
        for e in self.data_ready:
            e.wait()
        if self.next_batch[0] is None:
            return False
        self.current_batch = self.next_batch[0]
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


def _init_data(data, allow_empty, default_name):
    """Normalize input data to list of (name, numpy) (reference: io.py:466)."""
    assert data is not None or allow_empty
    if data is None:
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty:
            assert len(data) > 0
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d
                    for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of "
                        "them or dict with them as values")
    out = {}
    for k, v in data.items():
        if isinstance(v, NDArray):
            out[k] = v.asnumpy()
        else:
            out[k] = np.asarray(v)
    return list(sorted(out.items()))


class NDArrayIter(DataIter):
    """Iterate over in-memory arrays (reference: io.py:546)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, allow_empty=False,
                               default_name=data_name)
        self.label = _init_data(label, allow_empty=True,
                                default_name=label_name)
        self.idx = np.arange(self.data[0][1].shape[0])
        if shuffle:
            np.random.shuffle(self.idx)
        self.shuffle = shuffle
        if last_batch_handle == "discard":
            new_n = self.data[0][1].shape[0] - \
                self.data[0][1].shape[0] % batch_size
            self.idx = self.idx[:new_n]
        self.data_list = [x[1] for x in self.data] + \
            [x[1] for x in self.label]
        self.num_source = len(self.data_list)
        self.num_data = self.idx.shape[0]
        assert self.num_data >= batch_size, \
            "batch_size needs to be smaller than data size"
        self.cursor = -batch_size
        self.batch_size = batch_size
        self.last_batch_handle = last_batch_handle

    @property
    def provide_data(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype) for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, tuple([self.batch_size] + list(v.shape[1:])),
                         v.dtype) for k, v in self.label]

    def hard_reset(self):
        if self.shuffle:
            np.random.shuffle(self.idx)
        self.cursor = -self.batch_size

    def reset(self):
        if self.shuffle:
            np.random.shuffle(self.idx)
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data:
            self.cursor = -self.batch_size + (self.cursor % self.num_data) \
                % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=None)
        raise StopIteration

    def _getdata(self, data_source):
        assert self.cursor < self.num_data, "DataIter needs reset."
        if self.cursor + self.batch_size <= self.num_data:
            sel = self.idx[self.cursor:self.cursor + self.batch_size]
            return [nd_array(x[1][sel]) for x in data_source]
        # padding with wrap-around keeps the batch shape constant, so the
        # bound executor takes the last batch as it is
        pad = self.batch_size - self.num_data + self.cursor
        sel = np.concatenate([self.idx[self.cursor:],
                              self.idx[:pad]])
        return [nd_array(x[1][sel]) for x in data_source]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


class CSVIter(DataIter):
    """CSV file iterator (reference: src/io/iter_csv.cc, registered :218)."""

    def __init__(self, data_csv, data_shape, label_csv=None, label_shape=(1,),
                 batch_size=1, round_batch=True, dtype="float32", **kwargs):
        super().__init__(batch_size)
        data = np.loadtxt(data_csv, delimiter=",",
                          dtype=dtype).reshape((-1,) + tuple(data_shape))
        label = None
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=dtype)
            label = label.reshape((-1,) + tuple(label_shape))
            if label_shape == (1,):
                label = label.reshape(-1)
        else:
            label = np.zeros(data.shape[0], dtype=dtype)
        self._inner = NDArrayIter(data, label, batch_size=batch_size,
                                  last_batch_handle="pad"
                                  if round_batch else "discard",
                                  label_name="label")
        self.provide_data = self._inner.provide_data
        self.provide_label = self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


class MNISTIter(DataIter):
    """MNIST idx-format iterator (reference: src/io/iter_mnist.cc:260)."""

    def __init__(self, image, label, batch_size=128, shuffle=True, flat=False,
                 silent=False, seed=0, **kwargs):
        super().__init__(batch_size)
        import gzip
        import struct

        def read_idx(path):
            opener = gzip.open if path.endswith(".gz") else open
            with opener(path, "rb") as f:
                magic = struct.unpack(">I", f.read(4))[0]
                ndim = magic & 0xFF
                dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
                return np.frombuffer(f.read(), dtype=np.uint8).reshape(dims)

        img = read_idx(image).astype(np.float32) / 255.0
        lbl = read_idx(label).astype(np.float32)
        if flat:
            img = img.reshape(img.shape[0], -1)
        else:
            img = img.reshape(img.shape[0], 1, img.shape[1], img.shape[2])
        self._inner = NDArrayIter(img, lbl, batch_size=batch_size,
                                  shuffle=shuffle)
        self.provide_data = [DataDesc("data", self._inner.provide_data[0].shape)]
        self.provide_label = [DataDesc("label",
                                       self._inner.provide_label[0].shape)]

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


def __getattr__(name):
    # ImageRecordIter lives in io_record.py (the threaded pipeline); the
    # lazy import keeps `import mxnet_tpu_torch` light
    if name == "ImageRecordIter":
        from .io_record import ImageRecordIter
        return ImageRecordIter
    raise AttributeError(name)


class LibSVMIter(DataIter):
    """libsvm-format iterator emitting CSR batches
    (reference: src/io/iter_libsvm.cc, io.LibSVMIter).

    Lines: ``<label> <idx>:<val> <idx>:<val> ...``; indices 0-based like
    the reference's default. Labels may themselves be sparse via
    `label_libsvm`."""

    def __init__(self, data_libsvm, data_shape, batch_size,
                 label_libsvm=None, label_shape=None, round_batch=True,
                 data_name="data", label_name="softmax_label", **kwargs):
        super().__init__(batch_size)
        self._feat_dim = int(data_shape[0]) if not isinstance(
            data_shape, int) else int(data_shape)
        self._rows, self._labels = self._parse(data_libsvm,
                                               self._feat_dim)
        self._label_dim = 1
        if label_libsvm:
            ldim = int(label_shape[0]) if label_shape else 1
            lrows, _ = self._parse(label_libsvm, ldim)
            dense_labels = []
            for idxs, vals in lrows:
                row = np.zeros((ldim,), np.float32)
                row[idxs] = vals
                dense_labels.append(row)
            self._labels = dense_labels
            self._label_dim = ldim
        self._round_batch = round_batch
        self.provide_data = [DataDesc(data_name,
                                      (batch_size, self._feat_dim))]
        lshape = (batch_size,) if self._label_dim == 1 \
            else (batch_size, self._label_dim)
        self.provide_label = [DataDesc(label_name, lshape)]
        self._cur = 0

    @staticmethod
    def _parse(path, dim):
        rows, labels = [], []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if not parts:
                    continue
                labels.append(float(parts[0]))
                idxs, vals = [], []
                for tok in parts[1:]:
                    i, v = tok.split(":")
                    idxs.append(int(i))
                    vals.append(float(v))
                rows.append((np.asarray(idxs, np.int32),
                             np.asarray(vals, np.float32)))
        return rows, labels

    def reset(self):
        self._cur = 0

    def next(self):
        from .ndarray.sparse import CSRNDArray
        n = len(self._rows)
        if self._cur >= n:
            raise StopIteration
        end = self._cur + self.batch_size
        idx = list(range(self._cur, min(end, n)))
        pad = 0
        if end > n:
            if not self._round_batch or not idx:
                if len(idx) < self.batch_size:
                    raise StopIteration
            pad = end - n
            idx += idx[-1:] * pad
        indptr = [0]
        cols, vals = [], []
        for i in idx:
            ci, cv = self._rows[i]
            cols.extend(ci.tolist())
            vals.extend(cv.tolist())
            indptr.append(len(cols))
        data = CSRNDArray(nd_array(np.asarray(vals, np.float32)),
                          nd_array(np.asarray(cols, np.int32)),
                          nd_array(np.asarray(indptr, np.int32)),
                          (self.batch_size, self._feat_dim))
        labels = np.asarray([self._labels[i] for i in idx], np.float32)
        self._cur = end
        return DataBatch([data], [nd_array(labels)], pad=pad,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)
