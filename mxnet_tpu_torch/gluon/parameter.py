"""Gluon `Parameter` and `ParameterDict` (counterpart of
mxnet_tpu/gluon/parameter.py: `Parameter` :54, `grad` :251, `list_grad`
:262, `zero_grad` :274, `cast` :291, `ParameterDict` :321, `initialize`
:427).

A port `Parameter` does not own storage: it wraps one `nn.Parameter` or
buffer of the block that registered it, under the Gluon name that
`collect_params` gives it, and reads the block's tensor live. What it
adds is Gluon's: ``grad_req``, ``lr_mult``, ``wd_mult``, an initializer,
and a gradient with MXNet's semantics, written by `autograd.backward`:
"write" replaces it on every backward, "add" adds to it, "null" has none
(and `grad()` raises). A gradient that a backward wrote carries the fresh
mark that ``Trainer.step(ignore_stale_grad=True)`` reads and an update
clears.

A parameter holds its block weakly, so a net and its parameters hold no
cycle: a dropped net is freed at once, and its parameters leave the live
set that `autograd.backward` differentiates against. Whoever holds a
collection of parameters keeps their blocks: a `ParameterDict` (and so a
`gluon.Trainer` made from one) does. A parameter whose block is gone
raises.

What keeps a parameter's storage where it is: `set_data`, `initialize`
(forced or not) and `HybridBlock.load_parameters` write in place. `cast`
and a move to another device (`initialize(ctx=...)`, `reset_ctx`) put a
new tensor in the block; whoever keeps pointers to the old one (an update
plan) must notice, and `parallel.FusedUpdater` does, by the pointers.
"""
from __future__ import annotations

import warnings
import weakref

import torch
from torch import nn

from .. import autograd, initializer
from ..base import MXNetError
from ..context import resolve_device

__all__ = ["Parameter", "ParameterDict", "as_dtype"]


def as_dtype(dtype):
    """A torch dtype from a torch dtype or its name ('float32',
    'bfloat16', 'float16')."""
    if isinstance(dtype, torch.dtype):
        return dtype
    found = getattr(torch, str(dtype), None)
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


class Parameter:
    """One tensor of a block, with Gluon's gradient and update settings."""

    def __init__(self, name, block, attr, grad_req="write", lr_mult=1.0,
                 wd_mult=1.0, init=None, differentiable=True,
                 fan_shape=None):
        self.name = name
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.init = init
        self._block_ref = weakref.ref(block)
        self._attr = attr
        self._differentiable = bool(differentiable)
        self._fan_shape = fan_shape
        self._grad = None
        self._fresh_grad = False
        self._initialized = False
        self._grad_req = None
        self.grad_req = grad_req

    def __repr__(self):
        return "Parameter %s (shape=%s, dtype=%s)" % (
            self.name, self.shape, self.dtype)

    # -- the block's tensor ---------------------------------------------
    @property
    def _block(self):
        block = self._block_ref()
        if block is None:
            raise MXNetError("parameter %r: its block no longer exists"
                             % self.name)
        return block

    def _is_buffer(self):
        return self._attr in self._block._buffers

    def _replace(self, tensor):
        """Put a new tensor in the block in place of this one's."""
        block = self._block
        if self._is_buffer():
            block._buffers[self._attr] = tensor
        else:
            block._parameters[self._attr] = nn.Parameter(
                tensor, requires_grad=self._grad_req != "null")
        self._grad = None
        self._fresh_grad = False

    def data(self, ctx=None):
        """The parameter's tensor (the block's own: writes to it are the
        block's)."""
        block = self._block
        if self._attr in block._buffers:
            return block._buffers[self._attr]
        return block._parameters[self._attr]

    def list_data(self):
        return [self.data()]

    def list_ctx(self):
        return [self.data().device]

    @property
    def shape(self):
        return tuple(self.data().shape)

    @property
    def dtype(self):
        return self.data().dtype

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
        data = self.data()
        if isinstance(data, nn.Parameter):
            data.requires_grad_(effective != "null")
        if effective == "null":
            self._grad = None
        else:
            autograd._track(self)

    def _takes_grad(self):
        return self._grad_req != "null" and self.data().requires_grad

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
        """Write `data` into the parameter's tensor, in place."""
        data = torch.as_tensor(data)
        dst = self.data()
        if tuple(data.shape) != tuple(dst.shape):
            raise MXNetError("parameter %r has shape %s, got %s"
                             % (self.name, tuple(dst.shape),
                                tuple(data.shape)))
        with torch.no_grad():
            dst.copy_(data)
        self._initialized = True

    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        """Fill the tensor in place by this parameter's own initializer
        (`init` given here, else the one it was made with), else
        `default_init` (else Uniform()); a second call warns and does
        nothing unless `force_reinit`. `ctx`: move the parameter there
        first."""
        if self._initialized and not force_reinit:
            warnings.warn("parameter %r already has a value; pass "
                          "force_reinit=True to overwrite it" % self.name)
            return
        if ctx is not None:
            self.reset_ctx(ctx)
        chosen = init if init is not None else self.init
        if chosen is None:
            chosen = default_init if default_init is not None \
                else initializer.Uniform()
        initializer.create(chosen)(
            initializer.InitDesc(self.name, fan_shape=self._fan_shape),
            self.data())
        if self._grad is not None:
            self._grad = None
        self._fresh_grad = False
        self._initialized = True

    def reset_ctx(self, ctx):
        """Move the parameter to the device `ctx` (a new tensor there)."""
        dev = _as_device(ctx)
        data = self.data()
        if data.device != dev:
            self._replace(data.detach().to(dev))

    def cast(self, dtype):
        """Cast the tensor to `dtype` (a new tensor; the gradient goes)."""
        dtype = as_dtype(dtype)
        data = self.data()
        if data.dtype != dtype:
            self._replace(data.detach().to(dtype))


class ParameterDict:
    """Parameters by Gluon name, in the order Gluon collects them."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._store = {}
        # the blocks that own the parameters, by id: kept alive here
        self._owners = {}

    def _add(self, param):
        self._store[param.name] = param
        block = param._block
        self._owners[id(block)] = block

    def __getitem__(self, key):
        return self._store[key]

    def __repr__(self):
        rows = "\n".join("  " + repr(v) for v in self.values())
        return "%s(\n%s\n)" % (self._prefix, rows)

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
