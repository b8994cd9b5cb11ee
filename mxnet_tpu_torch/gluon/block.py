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
"""
from __future__ import annotations

import threading

import torch
from torch import nn

from ..base import MXNetError

__all__ = ["HybridBlock", "collect_params"]

_local = threading.local()


class _Scope:
    def __init__(self, block):
        self._block = block
        self._counts = {}
        self._old = None

    def next_prefix(self, hint):
        n = self._counts.get(hint, 0)
        self._counts[hint] = n + 1
        return "%s%d_" % (hint, n)

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old = getattr(_local, "scope", None)
        _local.scope = self
        return self

    def __exit__(self, *exc):
        if not self._block._empty_prefix:
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
        self.prefix = (scope._block.prefix if scope else "") + prefix
        self._naming = _Scope(self)

    def _alias(self):
        return type(self).__name__.lower()

    def name_scope(self):
        return self._naming

    def load_parameters(self, params):
        """Copy {Gluon name: tensor} into this block's parameters and
        buffers. Every name must match exactly one of them, with its
        shape; a missing or an extra name raises."""
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
