"""Gluon `Parameter`, `Constant` and `ParameterDict` (counterpart of
mxnet_tpu/gluon/parameter.py: `DeferredInitializationError` :36,
`Parameter` :54, deferred init :146-194, `grad` :251, `zero_grad` :274,
`cast` :291, `Constant` :302, `ParameterDict` :321, `get` :367,
`get_constant` :402, `initialize` :427, `save` :450, `load` :461).

A parameter's tensor lives in one of two places:

- in the blocks that hold it (the port's own layers): an `nn.Parameter`
  or buffer of the block, under the layer's attribute name (``weight``,
  ``running_mean``), which the layer's forward reads. Blocks that share
  the parameter (``params=``) hold the same tensor object. The parameter
  holds its blocks weakly, so a net and its parameters hold no cycle: a
  dropped net is freed at once, and its parameters leave the live set
  that `autograd.backward` differentiates against;
- in the parameter itself, for one made by ``block.params.get`` in a
  user's block, which its ``hybrid_forward`` receives.

What it adds is Gluon's: a declared shape whose unknown dims (0) the
first forward fills in (deferred initialization: `initialize` only
records the initializer and device then, and the layer's forward calls
`_finish_deferred_init` once it knows the shape), ``grad_req``,
``lr_mult``, ``wd_mult``, and a gradient with MXNet's semantics, written
by `autograd.backward`: "write" replaces it on every backward, "add"
adds to it, "null" has none (and `grad()` raises). A gradient that a
backward wrote carries the fresh mark that
``Trainer.step(ignore_stale_grad=True)`` reads and an update clears.

What keeps a parameter's storage where it is: `set_data`, `initialize`
and loading write in place. `cast`, a move to another device and the
end of a deferred init put a new tensor in its holders; whoever keeps
pointers to the old one (an update plan) must notice, and
`parallel.FusedUpdater` does, by the pointers.

Files: `save`/`load` write and read ``nd.save``'s format in the JAX
package's layouts, so files cross between the two packages: an NHWC
convolution weight, (O, I, kh, kw) here, is (O, kh, kw, I) in a file
(`_file_perm`).
"""
from __future__ import annotations

import warnings
import weakref

import numpy as np
import torch
from torch import nn

from .. import autograd, initializer
from ..base import MXNetError
from ..context import cpu, resolve_device

__all__ = ["Constant", "DeferredInitializationError", "Parameter",
           "ParameterDict", "as_dtype"]


class DeferredInitializationError(MXNetError):
    """A parameter waits for the first forward to know its shape."""


def as_dtype(dtype):
    """A torch dtype from a torch dtype, a numpy dtype or its name
    ('float32', 'bfloat16', 'float16')."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, (np.dtype, type)):
        dtype = np.dtype(dtype).name
    found = getattr(torch, str(dtype).replace("torch.", ""), None)
    if not isinstance(found, torch.dtype):
        raise MXNetError("unknown dtype %r" % (dtype,))
    return found


def _as_device(ctx):
    if isinstance(ctx, (list, tuple)):
        if len(ctx) != 1:
            raise MXNetError("the port keeps one copy of a parameter: give "
                             "one device, got %s" % (ctx,))
        ctx = ctx[0]
    return resolve_device(ctx)


def _known(shape):
    return shape is not None and all(d > 0 for d in shape)


def _shapes_agree(declared, concrete):
    """A declared shape matches a concrete one if every non-zero declared
    dim equals it; 0 means 'infer me'."""
    return (len(declared) == len(concrete)
            and all(d in (0, c) for d, c in zip(declared, concrete)))


def _as_tensor(value):
    from ..ndarray import NDArray
    if isinstance(value, NDArray):
        return value._data
    return torch.as_tensor(np.asarray(value) if not isinstance(
        value, torch.Tensor) else value)


class Parameter:
    """A weight of a block, with Gluon's gradient, update and init
    settings (parameter.py:54)."""

    def __init__(self, name, grad_req="write", shape=None, dtype="float32",
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        for st in (stype, grad_stype):
            if st not in ("default", "row_sparse", "csr"):
                raise ValueError("invalid stype %r" % (st,))
        self.name = name
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        if isinstance(shape, int):
            shape = (shape,)
        self._shape = None if shape is None else tuple(int(d) for d in shape)
        self._dtype = dtype
        self._differentiable = bool(differentiable)
        self._holders = []          # [(weakref to a block, attr, buffer?)]
        self._data = None           # the tensor, when no block holds it
        self._fan_shape = None
        self._file_perm = None      # tensor dims -> the file's layout
        self._grad = None
        self._fresh_grad = False
        self._initialized = False
        self._deferred_init = None  # (init, device, default_init, value)
        self._grad_req = None
        self.grad_req = grad_req

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (
            self.name, self.shape, self.dtype)

    # -- where the tensor lives -----------------------------------------
    def _live_holders(self):
        out = []
        for ref, attr, buf in self._holders:
            blk = ref()
            if blk is not None:
                out.append((blk, attr, buf))
        if self._holders and not out:
            raise MXNetError("parameter %r: its block no longer exists"
                             % self.name)
        return out

    def _tensor(self):
        """The tensor, or None before it exists."""
        if not self._holders:
            return self._data
        blk, attr, buf = self._live_holders()[0]
        return (blk._buffers if buf else blk._parameters).get(attr)

    def _attach(self, block, attr, buffer=False):
        """Make `block` hold this parameter as its `attr`, sharing the
        tensor with the blocks that already hold it."""
        t = self._tensor()
        if self._data is not None:
            t, self._data = self._data, None
        self._holders.append((weakref.ref(block), attr, buffer))
        if t is not None and not buffer and \
                not isinstance(t, nn.Parameter):
            t = nn.Parameter(t.detach(), requires_grad=t.requires_grad)
        if buffer:
            block._buffers[attr] = t
        else:
            block._parameters[attr] = t

    def _set_tensor(self, t):
        """Put the tensor `t` (a new one) in every holder."""
        t = t.detach()
        takes = self._grad_req != "null" and t.is_floating_point()
        if self._holders:
            holders = self._live_holders()
            obj = t if holders[0][2] else nn.Parameter(t,
                                                       requires_grad=takes)
            for blk, attr, buf in holders:
                (blk._buffers if buf else blk._parameters)[attr] = obj
        else:
            self._data = t.requires_grad_(takes)
        self._grad = None
        self._fresh_grad = False

    def data(self, ctx=None):
        """The parameter's tensor (the block's own: writes to it are the
        block's). Raises `DeferredInitializationError` while it waits
        for its shape, RuntimeError before `initialize`."""
        t = self._tensor()
        if t is None:
            if self._deferred_init:
                raise DeferredInitializationError(
                    "parameter %r is waiting for shape inference on the "
                    "first forward pass" % self.name)
            raise RuntimeError("parameter %r has no value yet: run "
                               "collect_params().initialize() first"
                               % self.name)
        return t

    def list_data(self):
        return [self.data()]

    def list_ctx(self):
        t = self._tensor()
        if t is None:
            if self._deferred_init:
                return [self._deferred_init[1]]
            raise RuntimeError("Parameter '%s' has not been initialized"
                               % self.name)
        return [t.device]

    @property
    def shape(self):
        t = self._tensor()
        return tuple(t.shape) if t is not None else self._shape

    @shape.setter
    def shape(self, new_shape):
        new_shape = tuple(int(d) for d in new_shape)
        if self._shape is not None and not _shapes_agree(self._shape,
                                                         new_shape):
            raise MXNetError(
                "parameter %r: declared shape %s cannot be refined to %s "
                "(only 0-dims are inferable)"
                % (self.name, self._shape, new_shape))
        self._shape = new_shape

    @property
    def dtype(self):
        t = self._tensor()
        return t.dtype if t is not None else as_dtype(self._dtype)

    @dtype.setter
    def dtype(self, dtype):
        self._dtype = dtype

    # -- gradient -------------------------------------------------------
    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in ("write", "add", "null"):
            raise ValueError("grad_req must be write, add or null; got %r"
                             % (req,))
        effective = req if self._differentiable else "null"
        self._grad_req = effective
        t = self._tensor()
        if t is not None and t.is_leaf and t.is_floating_point():
            t.requires_grad_(effective != "null")
        if effective == "null":
            self._grad = None
        else:
            autograd._track(self)

    def _takes_grad(self):
        if self._grad_req == "null":
            return False
        try:
            t = self._tensor()
        except MXNetError:       # its block is gone
            return False
        return t is not None and t.requires_grad

    def _write_grad(self, g):
        """`autograd.backward`'s write: replace ("write") or add ("add")."""
        g = g.contiguous()
        if self._grad_req == "add" and self._grad is not None:
            self._grad = self._grad + g
        else:
            self._grad = g
        self._fresh_grad = True

    def grad(self, ctx=None):
        """The gradient (zeros until a backward writes one). Raises for
        grad_req 'null'."""
        if self._grad_req == "null":
            raise MXNetError("parameter %r tracks no gradient "
                             "(grad_req='null')" % self.name)
        if self._grad is None:
            self._grad = torch.zeros_like(
                self.data(), memory_format=torch.contiguous_format)
        return self._grad

    def list_grad(self):
        return [self.grad()]

    def zero_grad(self):
        """Set the gradient to 0 in place (it does not become fresh)."""
        if self._grad is not None:
            self._grad.zero_()

    # -- value ----------------------------------------------------------
    def set_data(self, data):
        """Write `data` into the parameter's tensor, in place; before a
        deferred init ends, it becomes the value that init takes."""
        data = _as_tensor(data)
        t = self._tensor()
        if t is None:
            if not self._deferred_init:
                raise MXNetError("parameter %r has no storage to set; "
                                 "initialize it first" % self.name)
            self.shape = data.shape
            init, dev, fallback, _ = self._deferred_init
            self._deferred_init = (init, dev, fallback, data)
            return
        if tuple(data.shape) != tuple(t.shape):
            raise MXNetError("parameter %r has shape %s, got %s"
                             % (self.name, tuple(t.shape),
                                tuple(data.shape)))
        with torch.no_grad():
            t.copy_(data)
        self._initialized = True

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Initialize the parameter by its own initializer (`init` given
        here, else the one it was made with), else `default_init` (else
        Uniform()), on `ctx` (default: where it is, else the current
        context). A shape with unknown dims waits for the first forward
        (deferred init). A second call warns and does nothing unless
        `force_reinit`."""
        if self._initialized and not force_reinit:
            warnings.warn("parameter %r already has a value; pass "
                          "force_reinit=True to overwrite it" % self.name)
            return
        chosen = init if init is not None else self.init
        fallback = default_init if default_init is not None \
            else initializer.Uniform()
        t = self._tensor()
        if ctx is not None:
            dev = _as_device(ctx)
        else:
            dev = t.device if t is not None else resolve_device(None)
        self._deferred_init = (chosen, dev, fallback, None)
        if t is None and not _known(self._shape):
            if not self.allow_deferred_init:
                self._deferred_init = None
                raise ValueError(
                    "parameter %r has shape %s with unknown dims and "
                    "deferred init disabled" % (self.name, self._shape))
            return
        self._finish_deferred_init()

    def _finish_deferred_init(self):
        """Make the tensor (the shape is known by now) and fill it."""
        if not self._deferred_init:
            return
        init, dev, fallback, value = self._deferred_init
        shape = self.shape
        if not _known(shape):
            raise MXNetError("deferred init of %r finished with unusable "
                             "shape %s" % (self.name, shape))
        self._deferred_init = None
        t = self._tensor()
        if t is None or t.device != dev:
            self._set_tensor(torch.zeros(shape, dtype=self.dtype,
                                         device=dev))
            t = self._tensor()
        if value is not None:
            with torch.no_grad():
                t.copy_(value)
        else:
            initializer.create(init if init is not None else fallback)(
                initializer.InitDesc(self.name, fan_shape=self._fan_shape),
                t)
        self._grad = None
        self._fresh_grad = False
        self._initialized = True

    def _load_init(self, data, ctx=None, from_file=False):
        """Adopt a loaded array as the value: in place where the tensor
        exists (moved to `ctx` first if one is given), else as a new
        tensor on `ctx` (else the pending init's device, else the
        current context). `from_file`: `data` is in the file's layout."""
        data = _as_tensor(data).detach()
        if from_file and self._file_perm is not None and data.dim() == \
                len(self._file_perm):
            inv = [self._file_perm.index(i) for i in range(data.dim())]
            data = data.permute(*inv)
        want = self.shape
        if want is not None and not _shapes_agree(want, data.shape):
            raise MXNetError("parameter %r: the loaded value has shape %s, "
                             "the parameter %s"
                             % (self.name, tuple(data.shape), want))
        if ctx is not None:
            dev = _as_device(ctx)
        elif self._tensor() is not None:
            dev = self._tensor().device
        elif self._deferred_init:
            dev = self._deferred_init[1]
        else:
            dev = resolve_device(None)
        t = self._tensor()
        if t is not None and t.device == dev:
            with torch.no_grad():
                t.copy_(data)
        else:
            self._shape = tuple(data.shape)
            self._set_tensor(data.to(device=dev, dtype=self.dtype).clone())
        self._deferred_init = None
        self._grad = None
        self._fresh_grad = False
        self._initialized = True

    def _file_value(self):
        """The value as a file holds it (the JAX package's layout)."""
        t = self.data().detach()
        return t.permute(*self._file_perm) if self._file_perm else t

    def reset_ctx(self, ctx):
        """Move the parameter to the device `ctx` (a new tensor there)."""
        dev = _as_device(ctx)
        t = self._tensor()
        if t is not None:
            if t.device != dev:
                self._set_tensor(t.detach().to(dev))
        elif self._deferred_init:
            init, _, fallback, value = self._deferred_init
            self._deferred_init = (init, dev, fallback, value)
        else:
            raise ValueError("parameter %r has no value or pending init "
                             "to move" % self.name)

    def cast(self, dtype):
        """Cast the tensor to `dtype` (a new tensor; the gradient goes)."""
        dtype = as_dtype(dtype)
        self._dtype = dtype
        t = self._tensor()
        if t is not None and t.dtype != dtype:
            self._set_tensor(t.detach().to(dtype))


class _FillFromValue(initializer.Initializer):
    def __init__(self, value):
        super().__init__()
        self._value = value

    def _init_weight(self, _, arr):
        initializer._fill(arr, self._value.to(arr.device))

    _init_default = _init_weight


class Constant(Parameter):
    """A parameter that takes no gradient, holding `value`
    (parameter.py:302)."""

    def __init__(self, name, value):
        from ..ndarray import NDArray
        value = _as_tensor(value).detach().cpu()
        # nd.array's defaults: float64 -> float32, int64 -> int32
        value = value.to({torch.float64: torch.float32,
                          torch.int64: torch.int32}.get(value.dtype,
                                                        value.dtype))
        self.value = NDArray(value)
        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype, init=_FillFromValue(value))


class ParameterDict:
    """Parameters by Gluon name, in the order Gluon collects them
    (parameter.py:321). `shared`: a dict whose parameters `get` adopts
    by name."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._shared = shared
        self._store = {}
        # the blocks that hold the parameters, by id: a collection kept
        # by a caller (collect_params, a Trainer) keeps them alive
        self._owners = {}

    def _add(self, param):
        self._store[param.name] = param
        for blk, _, _ in param._live_holders():
            self._owners[id(blk)] = blk

    def __getitem__(self, key):
        return self._store[key]

    def __repr__(self):
        head = (self._prefix + " ") if self._prefix else ""
        rows = "\n".join("  " + repr(v) for v in self.values())
        return "%s(\n%s\n)" % (head, rows)

    def __iter__(self):
        return iter(self._store)

    def __len__(self):
        return len(self._store)

    def __contains__(self, key):
        return key in self._store

    def items(self):
        return self._store.items()

    def keys(self):
        return self._store.keys()

    def values(self):
        return self._store.values()

    @property
    def prefix(self):
        return self._prefix

    def _get_impl(self, name):
        found = self._store.get(name)
        if found is None and self._shared is not None:
            found = self._shared._store.get(name)
            if found is not None:
                self._store[name] = found     # adopt the shared object
        return found

    def get(self, name, **kwargs):
        """The parameter named prefix + `name`, made with `kwargs` if
        there is none (parameter.py:367); an existing one takes the
        attributes it lacks, and conflicting ones raise."""
        name = self.prefix + name
        param = self._get_impl(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._store[name] = param
            return param
        for attr, wanted in kwargs.items():
            self._reconcile_attr(param, attr, wanted)
        return param

    @staticmethod
    def _reconcile_attr(param, attr, wanted):
        current = getattr(param, attr, None)
        if current is None:
            setattr(param, attr, wanted)
            return
        if wanted is None or wanted is current:
            return
        if attr == "shape":
            wanted = tuple(wanted)
            if len(wanted) == len(current):
                unified = tuple(a or b for a, b in zip(wanted, current))
                if all(a in (0, u) and b in (0, u)
                       for a, b, u in zip(wanted, current, unified)):
                    if param._tensor() is None:
                        param._shape = unified
                    return
        elif attr == "dtype":
            if as_dtype(wanted) == as_dtype(current):
                return
        elif wanted == current:
            return
        if attr == "init":
            return          # a shared parameter keeps its first init
        raise MXNetError(
            "parameter %r is shared with %s=%r; a second user asked for "
            "%r, which conflicts" % (param.name, attr, current, wanted))

    def get_constant(self, name, value=None):
        """The `Constant` named prefix + `name`, made from `value` if
        there is none (parameter.py:402)."""
        name = self.prefix + name
        param = self._get_impl(name)
        if param is not None:
            if value is not None and not isinstance(param, Constant):
                raise MXNetError("%r exists as a trainable Parameter; it "
                                 "cannot also be a Constant" % name)
            return param
        if value is None:
            raise KeyError("no Constant named %r; pass value= to create "
                           "one" % name)
        self._store[name] = Constant(name, value)
        return self._store[name]

    def update(self, other):
        for key, theirs in other.items():
            ours = self._store.get(key, theirs)
            if ours is not theirs:
                raise MXNetError("both dicts define %r but as distinct "
                                 "Parameter objects" % key)
            self._add(theirs)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter (parameter.py:427): each by its own
        initializer, else `init` (default Uniform())."""
        init = init or initializer.Uniform()
        if verbose:
            init.set_verbosity(verbose=verbose)
        for p in self.values():
            p.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self):
        for p in self.values():
            p.zero_grad()

    def reset_ctx(self, ctx):
        for p in self.values():
            p.reset_ctx(ctx)

    def setattr(self, name, value):
        """Set an attribute (grad_req, lr_mult, wd_mult) on every
        parameter."""
        for p in self.values():
            setattr(p, name, value)

    def save(self, filename, strip_prefix=""):
        """Write every parameter to `filename` in ``nd.save``'s format,
        named without `strip_prefix` (parameter.py:450)."""
        from ..ndarray import NDArray, save
        payload = {}
        for param in self.values():
            if strip_prefix and not param.name.startswith(strip_prefix):
                raise ValueError(
                    "cannot strip prefix %r from parameter %r when saving"
                    % (strip_prefix, param.name))
            payload[param.name[len(strip_prefix):]] = \
                NDArray(param._file_value())
        save(filename, payload)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        """Read a file that `save` (or the JAX package) wrote
        (parameter.py:461); names gain `restore_prefix`."""
        if restore_prefix:
            bad = [n for n in self.keys()
                   if not n.startswith(restore_prefix)]
            if bad:
                raise MXNetError(
                    "restore_prefix %r does not prefix parameter(s) %s"
                    % (restore_prefix, ", ".join(bad)))
        saved = {restore_prefix + key.split(":", 1)[-1]: val
                 for key, val in _load_file(filename).items()}
        self._load_dict(saved, ctx, allow_missing, ignore_extra, filename,
                        from_file=True)

    def _load_dict(self, saved, ctx, allow_missing, ignore_extra, where,
                   from_file):
        missing = [n for n in self.keys() if n not in saved]
        if missing and not allow_missing:
            raise MXNetError("%s lacks parameter(s) %s (missing; pass "
                             "allow_missing=True to initialize them "
                             "separately)" % (where,
                                              ", ".join(sorted(missing))))
        extra = [n for n in saved if n not in self._store]
        if extra and not ignore_extra:
            raise MXNetError("%s carries parameter(s) %s, unexpected here "
                             "(pass ignore_extra=True to skip them)"
                             % (where, ", ".join(sorted(extra))))
        for name, value in saved.items():
            if name in self._store:
                self._store[name]._load_init(value, ctx, from_file)


def _load_file(filename):
    """{name: host tensor} of an ``nd.save`` file."""
    from ..ndarray import load
    with cpu():
        loaded = load(filename)
    if not isinstance(loaded, dict):
        raise MXNetError("%s holds a list of arrays, not named parameters"
                         % filename)
    return {k: v._data for k, v in loaded.items()}
