"""NDArray: the eager array type (counterpart of
mxnet_tpu/ndarray/ndarray.py: `NDArray` :118, `invoke` :523, creation
:599-655, `waitall` :665, `save`/`load` :688-725).

An `NDArray` wraps one `torch.Tensor` in ``_data``, as the JAX one wraps
a `jax.Array`. It is not a tensor subclass: MXNet's `shape` (a tuple),
`dtype` (a numpy type), `size` (an int), `grad` (the `attach_grad`
buffer), `T`, `reshape` with its special codes, ``sum(axis=...)`` and
``==`` (0/1 in x's dtype) all differ from `torch.Tensor`'s own, and a
subclass would pay ``__torch_function__`` dispatch on every torch call
inside the layers, which stay on plain tensors.

Operators run through `invoke`, the analog of ``Imperative::Invoke``:
the registry op's function on the tensors, with torch's grad mode on
exactly when `autograd.is_recording()`, so an op outside ``record()``
builds no graph. There is no per-op compile: an eager torch op is a
launch already.

In-place writes. ``x[...] = v``, ``x += y`` (and the other augmented
operators), ``out=``, `copyto` and the aux write-back of an op (BatchNorm's
moving statistics, an update op's state) write into the existing tensor,
in place, as MXNet does (the JAX package swaps ``_data`` instead), so an
array that shares a parameter's storage sees the write. Such a write is
never recorded, and under ``autograd.record()`` it raises `MXNetError`
when its target or its value takes part in the recorded graph (an
attached variable or a recorded result): the gradient through it would
be wrong. Outside ``record()`` it is allowed; a backward that still needs
the old value of what it overwrote then raises `MXNetError` (torch's
version counter sees the write) rather than compute with the new value.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import autograd
from .. import random as _random
from ..base import MXNetError, dtype_from_name, dtype_name, np_dtype
from ..context import Context, context_of, resolve_device
from ..ops import registry as _reg

__all__ = ["NDArray", "invoke", "array", "zeros", "ones", "full", "empty",
           "arange", "zeros_like", "ones_like", "concatenate", "moveaxis",
           "waitall", "load", "save", "load_frombuffer"]


def _write(dst, src):
    """Write tensor `src` into NDArray `dst`'s tensor in place (broadcast
    and cast to it), under the in-place rule of the module docstring."""
    t = dst._data
    if isinstance(src, torch.Tensor) and src.data_ptr() == t.data_ptr() \
            and src.dtype == t.dtype and src.shape == t.shape and \
            src.stride() == t.stride():
        return          # the same memory (a state an op passed through)
    if autograd.is_recording() and (t.requires_grad or (
            isinstance(src, torch.Tensor) and src.requires_grad)):
        raise MXNetError(
            "in-place write under autograd.record() into or from an array "
            "of the recorded graph: it would not be recorded; compute a "
            "new array instead (y = x + v)")
    with torch.no_grad():
        t.copy_(src) if isinstance(src, torch.Tensor) else t.fill_(src)


class NDArray:
    """A device array with MXNet's eager semantics."""

    __slots__ = ("_data", "_grad", "_grad_req", "_fresh_grad",
                 "__weakref__")

    def __init__(self, data, ctx=None):
        if isinstance(data, NDArray):
            data = data._data
        elif not isinstance(data, torch.Tensor):
            data = torch.as_tensor(np.asarray(data),
                                   device=resolve_device(ctx))
        self._data = data
        self._grad = None
        self._grad_req = None
        self._fresh_grad = False

    # -- properties ---------------------------------------------------------
    @property
    def shape(self):
        return tuple(self._data.shape)

    @property
    def dtype(self):
        return np_dtype(self._data.dtype)

    @property
    def ndim(self):
        return self._data.dim()

    @property
    def size(self):
        return self._data.numel()

    @property
    def stype(self):
        return "default"

    @property
    def context(self):
        return context_of(self._data.device)

    ctx = context

    @property
    def T(self):
        return _op1("transpose", self, {})

    @property
    def grad(self):
        return self._grad

    # -- sync and conversion ------------------------------------------------
    def asnumpy(self):
        """A numpy copy on the host (bfloat16 as float32)."""
        t = self._data.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar: asscalar "
                             "needs an array of one element, got shape %s"
                             % (self.shape,))
        return self.asnumpy().reshape(())[()]

    def item(self):
        return self.asscalar()

    def tolist(self):
        return self.asnumpy().tolist()

    def astuple(self):
        return tuple(self.asnumpy())

    def astorch(self):
        """The underlying `torch.Tensor` (no copy)."""
        return self._data

    def wait_to_read(self):
        """Wait for the work that produces this array: its device's
        current stream."""
        if self._data.is_cuda:
            torch.cuda.current_stream(self._data.device).synchronize()

    wait_to_write = wait_to_read

    def astype(self, dtype, copy=True):
        if not copy and dtype_from_name(dtype) == self._data.dtype:
            return self
        return _op1("Cast", self, {"dtype": dtype_name(dtype)})

    def copy(self):
        return NDArray(self._data.clone())

    def copyto(self, other):
        """Copy into the NDArray `other` in place, or to a new array on
        the `Context` `other`."""
        if isinstance(other, NDArray):
            if other.shape != self.shape:
                raise MXNetError("copyto: shapes %s and %s differ"
                                 % (self.shape, other.shape))
            _write(other, self._data)
            return other
        if isinstance(other, Context):
            return NDArray(self._data.detach().to(other.torch_device,
                                                  copy=True))
        raise MXNetError("copyto: bad target %r" % (other,))

    def as_in_context(self, ctx):
        if ctx == self.context:
            return self
        with torch.set_grad_enabled(autograd.is_recording()):
            return NDArray(self._data.to(ctx.torch_device))

    # -- autograd -----------------------------------------------------------
    def attach_grad(self, grad_req="write", stype=None):
        """Give the array a gradient buffer (zeros) that `backward`
        writes as `grad_req` says: "write", "add" or "null". The array
        becomes a variable of the graph: a leaf that shares its storage."""
        if grad_req not in ("write", "add", "null"):
            raise MXNetError("grad_req must be write, add or null; got %r"
                             % (grad_req,))
        t = self._data.detach()
        if grad_req != "null":
            t.requires_grad_(True)
        self._data = t
        self._grad = NDArray(torch.zeros_like(
            t, memory_format=torch.contiguous_format))
        self._grad_req = grad_req
        autograd._track_array(self)

    def detach(self):
        return NDArray(self._data.detach())

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        autograd.backward([self], None if out_grad is None else [out_grad],
                          retain_graph=retain_graph, train_mode=train_mode)

    # -- fluent methods (ndarray.py:256-331) --------------------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        shape = kwargs.get("shape", shape)
        return _op1("Reshape", self, {"shape": tuple(shape)})

    def reshape_like(self, other):
        return _op1("Reshape", self, {"shape": other.shape})

    def expand_dims(self, axis):
        return _op1("expand_dims", self, {"axis": axis})

    def flatten(self):
        return _op1("Flatten", self, {})

    def squeeze(self, axis=None):
        return _op1("squeeze", self, {"axis": axis})

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return _op1("transpose", self, {"axes": axes or None})

    def flip(self, axis):
        return _op1("flip", self, {"axis": axis})

    def sum(self, axis=None, keepdims=False):
        return _op1("sum", self, {"axis": axis, "keepdims": keepdims})

    def mean(self, axis=None, keepdims=False):
        return _op1("mean", self, {"axis": axis, "keepdims": keepdims})

    def max(self, axis=None, keepdims=False):
        return _op1("max", self, {"axis": axis, "keepdims": keepdims})

    def min(self, axis=None, keepdims=False):
        return _op1("min", self, {"axis": axis, "keepdims": keepdims})

    def argmax(self, axis=None):
        return _op1("argmax", self, {"axis": axis})

    def argmin(self, axis=None):
        return _op1("argmin", self, {"axis": axis})

    def norm(self):
        return _op1("norm", self, {})

    def abs(self):
        return _op1("abs", self, {})

    def clip(self, a_min, a_max):
        return _op1("clip", self, {"a_min": a_min, "a_max": a_max})

    def slice_axis(self, axis, begin, end):
        return _op1("slice_axis", self,
                    {"axis": axis, "begin": begin, "end": end})

    def take(self, indices, axis=0):
        return invoke(_reg.get("take"), [self, _as_nd(indices, self)],
                      {"axis": axis})[0]

    def one_hot(self, depth, **kw):
        return _op1("one_hot", self, dict(depth=depth, **kw))

    def tostype(self, stype):
        if stype != "default":
            raise MXNetError("tostype(%r): sparse storage is not ported yet"
                             % (stype,))
        return self

    def as_nd_ndarray(self):
        return self

    # -- operators ----------------------------------------------------------
    def _binop(self, other, op_name, scalar_op_name, reverse=False):
        if isinstance(other, NDArray):
            a, b = (other, self) if reverse else (self, other)
            return invoke(_reg.get(op_name), [a, b], {})[0]
        if isinstance(other, (int, float, bool, np.number)):
            name = scalar_op_name
            if reverse and _reg.exists("_r" + scalar_op_name.lstrip("_")):
                name = "_r" + scalar_op_name.lstrip("_")
            return _op1(name, self, {
                "scalar": other if isinstance(other, bool) else float(other)})
        return NotImplemented

    def __add__(self, o):
        return self._binop(o, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binop(o, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._binop(o, "broadcast_sub", "_minus_scalar", reverse=True)

    def __mul__(self, o):
        return self._binop(o, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binop(o, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, o):
        return self._binop(o, "broadcast_div", "_div_scalar", reverse=True)

    def __mod__(self, o):
        return self._binop(o, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, o):
        return self._binop(o, "broadcast_mod", "_mod_scalar", reverse=True)

    def __pow__(self, o):
        return self._binop(o, "broadcast_power", "_power_scalar")

    def __rpow__(self, o):
        return self._binop(o, "broadcast_power", "_power_scalar",
                           reverse=True)

    def __neg__(self):
        return _op1("negative", self, {})

    def __abs__(self):
        return _op1("abs", self, {})

    def __eq__(self, o):
        if o is None:
            return False
        return self._binop(o, "broadcast_equal", "_equal_scalar")

    def __ne__(self, o):
        if o is None:
            return True
        return self._binop(o, "broadcast_not_equal", "_not_equal_scalar")

    def __gt__(self, o):
        return self._binop(o, "broadcast_greater", "_greater_scalar")

    def __ge__(self, o):
        return self._binop(o, "broadcast_greater_equal",
                           "_greater_equal_scalar")

    def __lt__(self, o):
        return self._binop(o, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, o):
        return self._binop(o, "broadcast_lesser_equal",
                           "_lesser_equal_scalar")

    def __hash__(self):
        return id(self)

    def _inplace(self, o, method):
        """``self <op>= o`` in place (see the module docstring's rule):
        the result of ``self <op> o`` written into self's tensor."""
        other = o._data if isinstance(o, NDArray) else o
        if autograd.is_recording() and (self._data.requires_grad or (
                isinstance(other, torch.Tensor) and other.requires_grad)):
            _write(self, other)          # raises with the rule's message
        with torch.no_grad():
            res = getattr(self, method)(o)
            if res is NotImplemented:
                return NotImplemented
            self._data.copy_(res._data)
        return self

    def __iadd__(self, o):
        return self._inplace(o, "__add__")

    def __isub__(self, o):
        return self._inplace(o, "__sub__")

    def __imul__(self, o):
        return self._inplace(o, "__mul__")

    def __itruediv__(self, o):
        return self._inplace(o, "__truediv__")

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise MXNetError("truth value of multi-element NDArray is ambiguous")

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of 0-d array")
        return self.shape[0]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    # -- indexing: basic slices are views of this array's storage, as in
    # MXNet; an NDArray index selects (as integers) ------------------------
    def _conv_index(self, key):
        if isinstance(key, NDArray):
            return key._data.long()
        if isinstance(key, tuple):
            return tuple(self._conv_index(k) for k in key)
        if isinstance(key, (list, np.ndarray)):
            return torch.as_tensor(np.asarray(key), dtype=torch.long,
                                   device=self._data.device)
        return key

    def __getitem__(self, key):
        with torch.set_grad_enabled(autograd.is_recording()):
            return NDArray(self._data[self._conv_index(key)])

    def __setitem__(self, key, value):
        if isinstance(value, NDArray):
            value = value._data
        elif not isinstance(value, torch.Tensor):
            value = torch.as_tensor(np.asarray(value, dtype=self.dtype
                                               if self._data.dtype !=
                                               torch.bfloat16 else None))
        value = value.to(device=self._data.device, dtype=self._data.dtype)
        if isinstance(key, slice) and key == slice(None):
            _write(self, value)
            return
        if autograd.is_recording() and (self._data.requires_grad
                                        or value.requires_grad):
            _write(self, value)          # raises with the rule's message
        with torch.no_grad():
            self._data[self._conv_index(key)] = value

    def __repr__(self):
        return "\n%s\n<NDArray %s @%s>" % (
            self.asnumpy(), "x".join(str(s) for s in self.shape),
            self.context)

def _op1(name, x, params):
    return invoke(_reg.get(name), [x], params)[0]


def _as_nd(x, like=None, dtype=None):
    """`x` as an NDArray, on `like`'s device when it is one."""
    if isinstance(x, NDArray):
        return x
    if isinstance(x, torch.Tensor):
        return NDArray(x)
    ctx = like.context if isinstance(like, NDArray) else None
    return array(x, ctx=ctx, dtype=dtype)


# ---------------------------------------------------------------------------
# eager invoke
# ---------------------------------------------------------------------------

# apply_defaults results by (op, params): an op's full params are built
# once per distinct call (the types are part of the key: 1 and 1.0 give
# an int and a float result)
_FULL = {}
_FULL_CAP = 4096


def _full_params(op, params):
    if not params:
        key = op
    else:
        try:
            key = (op,) + tuple((k, type(v), v) for k, v in
                                sorted(params.items()))
            hash(key)
        except TypeError:
            return _reg.apply_defaults(op, params)
    full = _FULL.get(key)
    if full is None:
        if len(_FULL) >= _FULL_CAP:
            _FULL.clear()
        full = _FULL[key] = _reg.apply_defaults(op, params)
    return full


def _device_of(tensors, full):
    for t in tensors:
        return t.device
    return resolve_device(full.get("ctx"))


def _mark_recorded(raw, tensors):
    """Under record(), a float output with no gradient path (a constant
    such as ones_like's, or BlockGrad's) of an op with a recorded input
    is still part of the graph, with zero gradients, as in the JAX
    package: it becomes a leaf that requires grad, so it can be a head."""
    if not any(isinstance(t, torch.Tensor) and t.requires_grad
               for t in tensors):
        return
    for r in raw:
        if isinstance(r, torch.Tensor) and not r.requires_grad and \
                r.is_floating_point() and r.is_leaf and \
                not any(r is t for t in tensors):
            r.requires_grad_(True)


def invoke(op, inputs, params, out=None):
    """Run the registered `op` on NDArrays (or tensors, numpy arrays).

    Returns the list of visible output NDArrays; hidden outputs that the
    op's ``aux_write`` names (BatchNorm's moving statistics, an update
    op's state) are written into their input arrays in place, in training
    mode for a `takes_mode` op and always otherwise. `out` (an NDArray or
    a list of them) receives the visible outputs in place and is what
    comes back; an op with an ``out`` param of its own (the SGD updates)
    gets the target's tensor and writes it itself."""
    full = _full_params(op, params)
    tensors = []
    for x in inputs:
        if isinstance(x, NDArray):
            tensors.append(x._data)
        elif isinstance(x, torch.Tensor):
            tensors.append(x)
        else:
            dev = tensors[0].device if tensors else None
            tensors.append(array(x, ctx=None if dev is None else
                                 context_of(dev))._data)
    outs = None if out is None else (
        list(out) if isinstance(out, (list, tuple)) else [out])
    kw = full
    train = None
    if op.takes_mode or "ctx" in full or "out" in full:
        kw = dict(full)
        if op.takes_mode:
            train = autograd.is_training()
            kw["_mode"] = "train" if train else "predict"
        if "ctx" in full:
            kw["ctx"] = _device_of(tensors, full)
        if "out" in full:
            kw["out"] = None if outs is None else outs[0]._data
    if op.needs_rng:
        tensors.insert(0, _random.generator(_device_of(tensors, full)))
    recording = autograd.is_recording()
    prev = torch.is_grad_enabled()
    if prev != recording:
        torch.set_grad_enabled(recording)
    try:
        raw = op.fn(*tensors, **kw)
    finally:
        if prev != recording:
            torch.set_grad_enabled(prev)
    if not isinstance(raw, tuple):
        raw = (raw,)
    vis = op.visible_outputs
    n_visible = (vis(full) if callable(vis) else vis) or len(raw)
    if recording:
        _mark_recorded(raw[:n_visible], tensors)
    if op.aux_write and (not op.takes_mode or train):
        for out_idx, in_idx in op.aux_write.items():
            tgt = inputs[in_idx]
            if isinstance(tgt, NDArray) and raw[out_idx] is not tgt._data:
                _write(tgt, raw[out_idx])
    if outs is None:
        return [NDArray(r) for r in raw[:n_visible]]
    for o, r in zip(outs, raw[:n_visible]):
        if r is not o._data:
            _write(o, r)
    return outs


# ---------------------------------------------------------------------------
# creation (ndarray.py:599-655)
# ---------------------------------------------------------------------------


def _place(t, ctx):
    return NDArray(t.to(resolve_device(ctx)))


def array(source, ctx=None, dtype=None):
    """A new array from `source` (an NDArray, a tensor, a numpy array, a
    list or a number) on `ctx` (default: the current context, the card).
    Without `dtype`, float64 becomes float32 and int64 int32, as in the
    JAX package; a list or a number gives float32."""
    dev = resolve_device(ctx)
    if isinstance(source, NDArray):
        source = source._data
    if isinstance(source, torch.Tensor):
        t = source.detach()
        if dtype is None:
            dtype = {torch.float64: torch.float32,
                     torch.int64: torch.int32}.get(t.dtype, t.dtype)
        return NDArray(t.to(device=dev, dtype=dtype_from_name(dtype),
                            copy=True))
    if dtype is None:
        if isinstance(source, np.ndarray):
            dtype = {np.dtype(np.float64): np.float32,
                     np.dtype(np.int64): np.int32}.get(source.dtype,
                                                       source.dtype)
        else:
            dtype = np.float32
    tdt = dtype_from_name(dtype)
    if tdt == torch.bfloat16:
        host = torch.as_tensor(np.asarray(source, dtype=np.float32))
    else:
        host = torch.as_tensor(np.array(source, dtype=np_dtype(tdt)))
    return NDArray(host.to(device=dev, dtype=tdt))


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def zeros(shape, ctx=None, dtype="float32", stype=None, **kw):
    if stype not in (None, "default"):
        raise MXNetError("zeros(stype=%r): sparse storage is not ported yet"
                         % (stype,))
    return NDArray(torch.zeros(_shape(shape), dtype=dtype_from_name(dtype),
                               device=resolve_device(ctx)))


def ones(shape, ctx=None, dtype="float32", **kw):
    return NDArray(torch.ones(_shape(shape), dtype=dtype_from_name(dtype),
                              device=resolve_device(ctx)))


def full(shape, val, ctx=None, dtype="float32", **kw):
    return NDArray(torch.full(_shape(shape), val,
                              dtype=dtype_from_name(dtype),
                              device=resolve_device(ctx)))


def empty(shape, ctx=None, dtype="float32"):
    return zeros(shape, ctx=ctx, dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32"):
    return invoke(_reg.get("_arange"), [], {
        "start": start, "stop": stop, "step": step, "repeat": repeat,
        "dtype": dtype, "ctx": ctx})[0]


def zeros_like(other):
    return NDArray(torch.zeros_like(other._data))


def ones_like(other):
    return NDArray(torch.ones_like(other._data))


def concatenate(arrays, axis=0, always_copy=True):
    with torch.set_grad_enabled(autograd.is_recording()):
        return NDArray(torch.cat([a._data for a in arrays], dim=axis))


def moveaxis(tensor, source, destination):
    with torch.set_grad_enabled(autograd.is_recording()):
        return NDArray(torch.movedim(tensor._data, source, destination))


def waitall():
    """Wait for all work on every CUDA device (Engine::WaitForAll)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)


# ---------------------------------------------------------------------------
# serialization (ndarray.py:688-725), in the reference's .params format
# ---------------------------------------------------------------------------


def save(fname, data):
    """Save a list of arrays or a dict name -> array in the reference's
    binary .params container (`serialization`); the bytes go to a temp
    file that then takes the name, so a killed process leaves no torn
    file."""
    from .serialization import dumps
    from ..resilience.atomic import atomic_write
    with atomic_write(fname) as f:
        f.write(dumps(data))


def load(fname):
    """Load a .params file into arrays on the current context."""
    with open(fname, "rb") as f:
        return load_frombuffer(f.read())


def load_frombuffer(buf):
    from .serialization import loads
    return loads(buf)
