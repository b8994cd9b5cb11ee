"""The reference's binary NDArray container, .params files (counterpart
of mxnet_tpu/ndarray/serialization.py, copied and cut to dense arrays).

Byte-level reimplementation of the reference's serializer, so files move
between this package, the JAX package and the reference framework
(reference: src/ndarray/ndarray.cc NDArray::Save/Load :1537-1762,
container magic kMXAPINDArrayListMagic 0x112 :1733).

Layout (little-endian):

    file   := u64 0x112 | u64 reserved=0 | vec<array> | vec<string names>
    vec<T> := u64 count | T*count
    string := u64 len | bytes
    array  := u32 0xF993fac9 (V2) | i32 stype | shape |
              (end if ndim==0) | i32 dev_type | i32 dev_id | i32 dtype |
              raw data
    shape  := u32 ndim | i64*ndim

V1 arrays (magic 0xF993fac8) and the pre-V1 layout (the magic field is
the ndim, u32 dims) are readable too. Only dense arrays are ported:
row-sparse and CSR storage (stype 1, 2) raise until sparse storage is.
bfloat16 has no reference flag and is stored as float32, as the JAX
package stores it.
"""
from __future__ import annotations

import struct

import numpy as np

from ..base import MXNetError

LIST_MAGIC = 0x112
V2_MAGIC = 0xF993FAC9
V1_MAGIC = 0xF993FAC8

# mshadow type flags (3rdparty/mshadow base.h)
_FLAG_TO_DTYPE = {0: np.float32, 1: np.float64, 2: np.float16,
                  3: np.uint8, 4: np.int32, 5: np.int8, 6: np.int64}
_DTYPE_TO_FLAG = {np.dtype(v): k for k, v in _FLAG_TO_DTYPE.items()}
# bfloat16 has no reference flag; checkpoints store it as float32
_STYPE_DENSE = 0
_DEV_CPU = 1


def _write_shape(out, shape):
    out.append(struct.pack("<I", len(shape)))
    if shape:
        out.append(struct.pack("<%dq" % len(shape), *shape))


def _np_of(arr):
    """numpy array of an NDArray-like, mapped to a reference dtype."""
    a = np.asarray(arr.asnumpy() if hasattr(arr, "asnumpy") else arr)
    if a.dtype not in _DTYPE_TO_FLAG:
        a = a.astype(np.float32)
    return np.ascontiguousarray(a)


def _save_one(out, arr):
    out.append(struct.pack("<I", V2_MAGIC))
    a = _np_of(arr)
    if a.ndim == 0:
        # the container has no rank 0 (ndim 0 means "none"): stored as
        # shape (1,), as the JAX package stores it
        import warnings
        warnings.warn(
            "nd.save: rank-0 array saved as shape (1,) — the "
            "reference .params container has no scalar rank",
            stacklevel=3)
        a = a.reshape(1)
    out.append(struct.pack("<i", _STYPE_DENSE))
    _write_shape(out, a.shape)
    out.append(struct.pack("<ii", _DEV_CPU, 0))
    out.append(struct.pack("<i", _DTYPE_TO_FLAG[a.dtype]))
    out.append(a.tobytes())


def dumps(data):
    """Serialize list-of-arrays or dict name->array to bytes."""
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
        if not all(isinstance(k, str) for k in names):
            raise MXNetError("nd.save: dict keys must be strings")
    elif isinstance(data, (list, tuple)):
        names = []
        arrays = list(data)
    else:
        names = []
        arrays = [data]
    out = [struct.pack("<QQ", LIST_MAGIC, 0),
           struct.pack("<Q", len(arrays))]
    for a in arrays:
        _save_one(out, a)
    out.append(struct.pack("<Q", len(names)))
    for n in names:
        b = n.encode("utf-8")
        out.append(struct.pack("<Q", len(b)))
        out.append(b)
    return b"".join(out)


class _Reader:
    def __init__(self, buf):
        self.buf = buf
        self.pos = 0

    def read(self, fmt):
        size = struct.calcsize(fmt)
        if self.pos + size > len(self.buf):
            raise MXNetError("invalid NDArray file format (truncated)")
        vals = struct.unpack_from("<" + fmt, self.buf, self.pos)
        self.pos += size
        return vals if len(vals) > 1 else vals[0]

    def read_bytes(self, n):
        if self.pos + n > len(self.buf):
            raise MXNetError("invalid NDArray file format (truncated)")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def read_shape(self, u32_dims=False):
        ndim = self.read("I")
        if ndim == 0:
            return ()
        if u32_dims:
            return tuple(self.read("%dI" % ndim)) if ndim > 1 \
                else (self.read("I"),)
        vals = struct.unpack_from("<%dq" % ndim, self.buf, self.pos)
        self.pos += 8 * ndim
        return tuple(vals)


def _read_dense_payload(r, shape):
    dev_type, _dev_id = r.read("ii")
    del dev_type
    flag = r.read("i")
    if flag not in _FLAG_TO_DTYPE:
        raise MXNetError("unknown dtype flag %d in NDArray file" % flag)
    dt = np.dtype(_FLAG_TO_DTYPE[flag])
    n = int(np.prod(shape)) if shape else 1
    raw = r.read_bytes(dt.itemsize * n)
    return np.frombuffer(raw, dtype=dt).reshape(shape).copy()


def _load_one(r):
    from .ndarray import array
    magic = r.read("I")
    if magic == V2_MAGIC:
        stype = r.read("i")
        if stype != _STYPE_DENSE:
            raise MXNetError("storage type %d in NDArray file: sparse "
                             "storage is not ported yet" % stype)
        shape = r.read_shape()
        if len(shape) == 0:
            return array(np.zeros((0,), np.float32))
        return array(_read_dense_payload(r, shape))
    if magic == V1_MAGIC:
        shape = r.read_shape()
    else:
        # legacy: magic is the ndim, u32 dims follow
        ndim = magic
        shape = tuple(r.read("%dI" % ndim)) if ndim > 1 else \
            ((r.read("I"),) if ndim == 1 else ())
    if len(shape) == 0:
        return array(np.zeros((0,), np.float32))
    return array(_read_dense_payload(r, shape))


def loads(buf):
    """Parse a reference .params byte buffer -> list or dict."""
    r = _Reader(buf)
    header, _reserved = r.read("QQ")
    if header != LIST_MAGIC:
        raise MXNetError("invalid NDArray file format (bad magic "
                         "0x%x)" % header)
    n = r.read("Q")
    arrays = [_load_one(r) for _ in range(n)]
    n_names = r.read("Q")
    if n_names == 0:
        return arrays
    if n_names != len(arrays):
        raise MXNetError("invalid NDArray file format (names/arrays "
                         "mismatch)")
    names = []
    for _ in range(n_names):
        ln = r.read("Q")
        names.append(r.read_bytes(ln).decode("utf-8"))
    return dict(zip(names, arrays))
