"""Compressed-sparse-row arrays, the part `io.LibSVMIter` emits
(counterpart of `CSRNDArray` in mxnet_tpu/ndarray/sparse.py:93;
reference: python/mxnet/ndarray/sparse.py).

A `CSRNDArray` holds its (data, indices, indptr) as NDArrays on one
device with the dense shape beside them; `asnumpy`/`todense` build the
dense matrix. The rest of sparse storage (row-sparse arrays, the sparse
operators, `cast_storage`) is not ported yet (ROADMAP A10).
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .ndarray import NDArray

__all__ = ["CSRNDArray"]


class CSRNDArray(NDArray):
    """Compressed sparse row matrix: (data, indices, indptr) and its
    dense shape (mxnet_tpu/ndarray/sparse.py:93)."""

    __slots__ = ("_values", "_indices", "_indptr", "_dense_shape")

    def __init__(self, data, indices, indptr, shape, ctx=None):
        as_nd = lambda x, dt: x if isinstance(x, NDArray) else \
            NDArray(torch.as_tensor(x, dtype=dt), ctx)  # noqa: E731
        self._values = as_nd(data, None)
        self._indices = as_nd(indices, torch.int32)
        self._indptr = as_nd(indptr, torch.int32)
        self._dense_shape = tuple(int(s) for s in shape)
        super().__init__(self._values._data)

    @property
    def shape(self):
        return self._dense_shape

    @property
    def size(self):
        m, n = self._dense_shape
        return m * n

    @property
    def ndim(self):
        return 2

    @property
    def data(self):
        return self._values

    @property
    def indices(self):
        return self._indices

    @property
    def indptr(self):
        return self._indptr

    @property
    def stype(self):
        return "csr"

    def _dense(self):
        m, n = self._dense_shape
        vals = self._values._data
        indptr = self._indptr._data.long()
        rows = torch.repeat_interleave(
            torch.arange(m, device=indptr.device), indptr[1:] - indptr[:-1])
        dense = torch.zeros((m, n), dtype=vals.dtype, device=vals.device)
        return dense.index_put_((rows.to(vals.device),
                                 self._indices._data.long().to(vals.device)),
                                vals, accumulate=True)

    def asnumpy(self):
        return self._dense().cpu().numpy()

    def todense(self):
        return NDArray(self._dense())

    def tostype(self, stype):
        if stype == "csr":
            return self
        if stype == "default":
            return self.todense()
        raise MXNetError("tostype(%r): only 'csr' and 'default' are ported"
                         % (stype,))

    def __repr__(self):
        return "\n<CSRNDArray %s @%s>" % (
            "x".join(str(s) for s in self.shape), self.context)
