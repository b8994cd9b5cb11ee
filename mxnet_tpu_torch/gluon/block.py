"""`HybridBlock`: an `nn.Module` that carries its Gluon name (counterpart of
mxnet_tpu/gluon/block.py).

The port does not trace a symbol graph: a block is a plain `nn.Module`
whose forward runs on tensors. What it keeps of Gluon is the naming, so
that every parameter has the name the JAX package gives it and weights
carry over by name: a block made inside another block's `name_scope()`
gets the prefix ``<hint><n>_`` (``conv0_``, ``batchnorm3_``, ``stage2_``)
from that scope's counters, under the scope owner's prefix, as
`_BlockNaming.create` (block.py:39) gives it. A block made outside any
scope has the empty prefix, so names are relative to the outermost
block: the JAX package's ``resnetv10_stage1_conv0_weight`` is the port's
``stage1_conv0_weight``.

Every parameter and buffer a block registers also gets a Gluon
`Parameter` under that name (made by `register_parameter` /
`register_buffer`), which `collect_params()` gathers into a
`ParameterDict` for `gluon.Trainer`; `initialize` and `cast` act on
them, as block.py:292-309 does.

Calling a block: the outermost call runs under
``torch.set_grad_enabled(autograd.is_recording())``, so a forward outside
``autograd.record()`` builds no graph. Type in, type out: `NDArray`
inputs are unwrapped once there and the outputs wrapped as NDArrays; the
layers inside run on plain tensors, and tensor inputs give tensors.
"""
from __future__ import annotations

import re
import threading

import torch
from torch import nn

from .. import autograd
from ..base import MXNetError
from ..ndarray import NDArray
from .parameter import Parameter, ParameterDict

__all__ = ["HybridBlock", "collect_params"]

_local = threading.local()


class _Scope:
    """A block's name scope. It keeps the block's prefix, not the block:
    a block and its parameters hold no cycle, so a dropped net is freed
    at once (and its parameters leave `autograd`'s live set)."""

    def __init__(self, prefix, empty):
        self.prefix = prefix
        self._empty = empty
        self._counts = {}
        self._old = None

    def next_prefix(self, hint):
        n = self._counts.get(hint, 0)
        self._counts[hint] = n + 1
        return "%s%d_" % (hint, n)

    def __enter__(self):
        if self._empty:
            return self
        self._old = getattr(_local, "scope", None)
        _local.scope = self
        return self

    def __exit__(self, *exc):
        if not self._empty:
            _local.scope = self._old


class HybridBlock(nn.Module):
    """Base of the port's layers. ``prefix=""`` shares the enclosing
    scope's prefix and makes `name_scope` a no-op, as in Gluon."""

    def __init__(self, prefix=None):
        super().__init__()
        scope = getattr(_local, "scope", None)
        self._empty_prefix = prefix == ""
        if prefix is None:
            prefix = scope.next_prefix(self._alias()) if scope else ""
        self.prefix = (scope.prefix if scope else "") + prefix
        self._naming = _Scope(self.prefix, self._empty_prefix)
        self._gluon_params = {}

    def _alias(self):
        return type(self).__name__.lower()

    def __call__(self, *args, **kwargs):
        if getattr(_local, "inside", False):
            return super().__call__(*args, **kwargs)
        wrap = any(isinstance(a, NDArray) for a in args)
        if wrap:
            args = [a._data if isinstance(a, NDArray) else a for a in args]
        _local.inside = True
        try:
            with torch.set_grad_enabled(autograd.is_recording()):
                out = super().__call__(*args, **kwargs)
        finally:
            _local.inside = False
        if not wrap:
            return out
        if isinstance(out, (tuple, list)):
            return type(out)(_wrap(o) for o in out)
        return _wrap(out)

    def name_scope(self):
        return self._naming

    # -- Gluon parameters ---------------------------------------------------
    def _param_spec(self, attr, is_buffer):
        """Keyword arguments of the `Parameter` for the tensor `attr`: a
        buffer takes no gradient; a bias starts at zero (Gluon's
        bias_initializer); other weights take the global initializer."""
        if is_buffer:
            return {"grad_req": "null", "differentiable": False}
        return {"init": "zeros" if attr == "bias" else None}

    def _add_gluon_param(self, attr, is_buffer):
        self._gluon_params[attr] = Parameter(
            self.prefix + attr, self, attr,
            **self._param_spec(attr, is_buffer))

    def register_parameter(self, name, param):
        super().register_parameter(name, param)
        if param is not None:
            self._add_gluon_param(name, False)

    def register_buffer(self, name, tensor, persistent=True):
        super().register_buffer(name, tensor, persistent)
        if tensor is not None:
            self._add_gluon_param(name, True)

    def collect_params(self, select=None):
        """A `ParameterDict` of this block's and its children's
        parameters (block.py:193), by Gluon name in Gluon's order;
        `select` keeps the names a regex matches."""
        keep = re.compile(select).match if select else (lambda _: True)
        out = ParameterDict(self.prefix)
        for mod in self.modules():
            if not isinstance(mod, HybridBlock):
                continue
            for attr, _ in list(mod.named_parameters(recurse=False)) + \
                    list(mod.named_buffers(recurse=False)):
                p = mod._gluon_params[attr]
                if keep(p.name):
                    out._add(p)
        return out

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter of the block (block.py:292)."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def cast(self, dtype):
        """Cast the block's and its children's parameters to `dtype`
        (block.py:303); the input must then be of that dtype too."""
        for child in self.children():
            if isinstance(child, HybridBlock):
                child.cast(dtype)
        for p in self._gluon_params.values():
            p.cast(dtype)

    def hybridize(self, active=True, **kwargs):
        """Accepted for Gluon's API; the port always runs eagerly."""

    def load_parameters(self, params):
        """Copy {Gluon name: tensor} into this block's parameters and
        buffers, in place. Every name must match exactly one of them,
        with its shape; a missing or an extra name raises."""
        own = dict(self.named_parameters())
        own.update(self.named_buffers())
        names = collect_params(self)
        missing = sorted(set(names) - set(params))
        extra = sorted(set(params) - set(names))
        if missing or extra:
            raise MXNetError("load_parameters: missing %s, unexpected %s"
                             % (missing, extra))
        for name, path in names.items():
            dst, src = own[path], params[name]
            if tuple(dst.shape) != tuple(src.shape):
                raise MXNetError("load_parameters: %s has shape %s, the "
                                 "block's %s" % (name, tuple(src.shape),
                                                 tuple(dst.shape)))
            with torch.no_grad():
                dst.copy_(src)
        for p in self.collect_params().values():
            p._initialized = True


def _wrap(out):
    return NDArray(out) if isinstance(out, torch.Tensor) else out


def collect_params(module):
    """{Gluon name: module path} of every parameter and buffer of
    `module` held by a `HybridBlock`, in the order Gluon collects them
    (the module path is what `torch.func.functional_call` takes)."""
    out = {}
    for path, mod in module.named_modules():
        if not isinstance(mod, HybridBlock):
            continue
        for name, _ in list(mod.named_parameters(recurse=False)) + \
                list(mod.named_buffers(recurse=False)):
            out[mod.prefix + name] = "%s.%s" % (path, name) if path else name
    return out
