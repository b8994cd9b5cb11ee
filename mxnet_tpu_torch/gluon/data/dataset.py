"""Datasets (counterpart of mxnet_tpu/gluon/data/dataset.py): Dataset with
its lazy `transform`/`transform_first`, SimpleDataset, ArrayDataset and
RecordFileDataset.

A dataset that holds an open file gives itself a `_fork()`, which a
DataLoader worker calls once after the fork (as later MXNet's
`worker_loop` does): forked workers must not share one file offset."""
from __future__ import annotations

import os

from ...ndarray import NDArray
from ... import recordio

__all__ = ["ArrayDataset", "Dataset", "RecordFileDataset", "SimpleDataset"]


class Dataset:
    """Abstract dataset: __getitem__ and __len__ (dataset.py:31)."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn, lazy=True):
        """A dataset whose samples are fn(*sample) (dataset.py:43), made
        on access (`lazy`) or at once."""
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn, lazy=True):
        """Transform only the first element of each sample
        (dataset.py:72)."""
        return self.transform(_TransformFirstClosure(fn), lazy)


class SimpleDataset(Dataset):
    """A dataset over a list or an array (dataset.py:98)."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def _fork(self):
        fork = getattr(self._data, "_fork", None)
        if fork is not None:
            fork()

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class _TransformFirstClosure:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, x, *args):
        if args:
            return (self._fn(x),) + args
        return self._fn(x)


class ArrayDataset(Dataset):
    """Samples zipped from several arrays or datasets of one length
    (dataset.py:116); a 1-D NDArray becomes a numpy array."""

    def __init__(self, *args):
        assert len(args) > 0, "Needs at least 1 arrays"
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            assert len(data) == self._length, \
                "All arrays must have the same length; array[0] has length " \
                "%d while array[%d] has %d." % (self._length, i, len(data))
            if isinstance(data, NDArray) and data.ndim == 1:
                data = data.asnumpy()
            self._data.append(data)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(data[idx] for data in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """Dataset over a RecordIO (.rec) file and its .idx
    (dataset.py:103; reference: data/dataset.py:148): item i is the raw
    record of the i-th key."""

    def __init__(self, filename):
        self.idx_file = os.path.splitext(filename)[0] + ".idx"
        self.filename = filename
        self._record = recordio.MXIndexedRecordIO(self.idx_file,
                                                  self.filename, "r")

    def _fork(self):
        """A file handle of this process's own (a forked worker's)."""
        self._record.reset()

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
