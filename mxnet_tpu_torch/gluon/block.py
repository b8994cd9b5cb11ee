"""`Block` and `HybridBlock`: `nn.Module`s that carry Gluon's names,
parameters and calling convention (counterpart of
mxnet_tpu/gluon/block.py: `_BlockNaming` :33, `Block` :126,
`_collect_params_with_prefix` :205, `save_parameters`/`load_parameters`
:218-263, `register_child` :280, hooks :285-293, `apply` :295,
`HybridBlock` :331, `forward` :522-546).

Naming. A block made inside another block's `name_scope()` gets the
prefix ``<hint><n>_`` (``conv0_``, ``batchnorm3_``, ``stage2_``) from
that scope's counters, under the scope owner's prefix; a top-level block
draws ``<hint><n>_`` from the global `name.NameManager` (``dense0_``,
``resnetv10_``), as `_BlockNaming.create` does, so `collect_params()`
keys, `prefix` and `name` equal the JAX package's for the same
construction sequence in a fresh process. ``prefix=""`` shares the
enclosing scope's prefix and makes `name_scope` a no-op; ``params=``
shares the parameters of that `ParameterDict` by name.

Parameters. A layer of the port registers its tensors with
`_new_param`: each is a Gluon `Parameter` (in `self.params`, under the
prefixed name) whose tensor the block holds as an `nn.Parameter` or
buffer under the attribute name, so the layer's forward reads
``self.weight`` as a tensor. A shape with unknown dims (``in_units=0``)
waits for the first forward: the layer's `_infer_shapes` gives the
shapes from its input and the parameters finish their deferred init
there. A user's block makes its parameters with ``self.params.get``
and assigns them as attributes; its ``hybrid_forward`` receives them as
NDArrays.

Calling a block. The built-in layers (their ``forward`` is defined in
this package) run on tensors; a user's ``Block.forward`` or
``hybrid_forward(F, x, ...)`` (``F`` is `mxnet_tpu_torch.ndarray`) runs
on NDArrays, as in the JAX package. Each call converts at the boundary,
type in, type out: a built-in layer given NDArrays unwraps them and
wraps its outputs, a user block given tensors wraps them and unwraps its
outputs; an NDArray wraps the tensor itself, so gradients flow through.
The outermost call runs under
``torch.set_grad_enabled(autograd.is_recording())``, so a forward
outside ``autograd.record()`` builds no graph.

Hybridizing. ``hybridize()`` makes a HybridBlock trace itself once to a
`Symbol`, on the first call, and replay that graph as a `CachedOp` on
every call after (block.py:298-506 of the JAX package): a user block's
``hybrid_forward(F, ...)`` runs with ``F`` = `mxnet_tpu_torch.symbol`
and Symbol inputs, and each layer of this package gives its graph with
``_sym_forward``, which builds the nodes the JAX package's
``hybrid_forward`` builds, names and params alike, so `export` writes
the JAX package's JSON. Parameters feed the graph in the JAX package's
layouts (an NHWC convolution weight as its (O, kh, kw, I) view). A
parameter whose dims are still unknown takes them from the graph's
shape inference at the first call; a user block that is not hybridized
does the same in its first eager forward. `export` writes the graph
and its parameters; `SymbolBlock` (and `SymbolBlock.imports`) runs a
graph file, either package's, as a block.
"""
from __future__ import annotations

import copy
import os
import re
import threading
import warnings

import torch
from torch import nn

from .. import autograd
from .. import name as _name
from .. import ndarray as _nd
from .. import symbol as _sym
from ..base import MXNetError
from ..cached_op import CachedOp
from ..context import resolve_device
from ..graph import infer_structs
from ..ndarray import NDArray
from ..symbol import Symbol
from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict, _as_tensor, _known, _load_file)

__all__ = ["Block", "HybridBlock", "SymbolBlock", "collect_params"]

_local = threading.local()
_PACKAGE = __name__.split(".")[0] + "."


class _Scope:
    """A block's name scope. It keeps the block's prefixes, not the
    block: a block and its parameters hold no cycle."""

    def __init__(self, prefix, params, empty):
        self.prefix = prefix
        self.params_prefix = params.prefix
        self.shared = params._shared
        self._empty = empty
        self._counts = {}
        self._old = None
        self._names = None

    def next_prefix(self, hint):
        n = self._counts.get(hint, 0)
        self._counts[hint] = n + 1
        return "%s%d_" % (hint, n)

    def __enter__(self):
        if self._empty:
            return self
        self._old = getattr(_local, "scope", None)
        _local.scope = self
        # symbols made in the scope are named under the block's prefix
        self._names = _name.Prefix(self.prefix)
        self._names.__enter__()
        return self

    def __exit__(self, *exc):
        if not self._empty:
            self._names.__exit__(*exc)
            self._names = None
            _local.scope = self._old


class _HookHandle:
    def __init__(self, hooks, hook):
        self._hooks = hooks
        self._hook = hook

    def detach(self):
        if self._hook in self._hooks:
            self._hooks.remove(self._hook)


_MODES = {}


def _forward_mode(cls):
    """How a block class runs: "tensor" (a forward of this package),
    "hybrid" (a hybrid_forward on NDArrays) or "ndarray" (a user's
    forward on NDArrays, or one of this package's that says
    ``_ndarray_forward = True``)."""
    mode = _MODES.get(cls)
    if mode is None:
        fwd = next(c for c in cls.__mro__ if "forward" in c.__dict__)
        hyb = next((c for c in cls.__mro__
                    if "hybrid_forward" in c.__dict__), None)
        if hyb is not None and hyb is not HybridBlock and (
                fwd is HybridBlock or issubclass(hyb, fwd)):
            mode = "hybrid"
        elif fwd.__module__.startswith(_PACKAGE) and \
                fwd not in (Block, HybridBlock) and \
                not fwd.__dict__.get("_ndarray_forward"):
            mode = "tensor"
        else:
            mode = "ndarray"
        _MODES[cls] = mode
    return mode


def _unwrap(x):
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap(v) for v in x)
    return x


def _wrap(x):
    if isinstance(x, torch.Tensor):
        return NDArray(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_wrap(v) for v in x)
    return x


def _tree_flatten(tree, where):
    """(leaves, spec) of a nested list of tensors, NDArrays or Symbols
    (block.py:83). A multi-output Symbol leaf stands for as many values
    as it has outputs, which the spec records."""
    leaves = []

    def walk(node):
        if isinstance(node, (NDArray, torch.Tensor)):
            leaves.append(node)
            return 1
        if isinstance(node, Symbol):
            leaves.append(node)
            n = len(node.list_outputs())
            return n if n > 1 else 1
        if not isinstance(node, (list, tuple)):
            raise TypeError(
                "HybridBlock %s: expected NDArray, Symbol, or a (nested) "
                "list of them, found %r" % (where, type(node).__name__))
        return tuple(walk(child) for child in node)

    return leaves, walk(tree)


def _tree_unflatten(values, spec):
    """The nested structure of `spec` over the flat `values` (block.py:111);
    a multi-value entry becomes a list."""
    it = iter(values)

    def build(s):
        if isinstance(s, tuple):
            return [build(child) for child in s]
        if s == 1:
            return next(it)
        return [next(it) for _ in range(s)]

    return build(spec)


def _has(kind, args, kwargs):
    """Whether an argument, or an item of a list argument, is a `kind`."""
    return any(isinstance(a, kind) or (
        isinstance(a, (list, tuple)) and any(isinstance(v, kind)
                                             for v in a))
               for a in list(args) + list(kwargs.values()))


class Block(nn.Module):
    """Base of every layer and model (block.py:126)."""

    def __init__(self, prefix=None, params=None):
        super().__init__()
        scope = getattr(_local, "scope", None)
        self._empty_prefix = prefix == ""
        hint = self._alias()
        if scope is not None and prefix is None:
            prefix = scope.next_prefix(hint)
        elif prefix is None:
            prefix = _name.current().get(None, hint) + "_"
        if params is not None:
            shared = ParameterDict(params.prefix, params)
        elif scope is not None:
            shared = ParameterDict(scope.params_prefix + prefix,
                                   scope.shared)
        else:
            shared = ParameterDict(prefix)
        self._prefix = prefix if scope is None else scope.prefix + prefix
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._params = shared
        self._naming = _Scope(self._prefix, shared, self._empty_prefix)
        self._attr_params = {}
        self._gluon_pre_hooks = []
        self._gluon_hooks = []
        self._params_ready = False

    def _alias(self):
        return type(self).__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    @property
    def params(self):
        """This block's own `ParameterDict` (not its children's)."""
        return self._params

    def name_scope(self):
        """The scope in which children get names under this block's
        prefix (block.py:238)."""
        return self._naming

    # -- attributes, children -------------------------------------------
    def __setattr__(self, name, value):
        prev = self.__dict__.get(name, self.__dict__.get(
            "_modules", {}).get(name))
        if isinstance(prev, (Parameter, Block)) and \
                not isinstance(value, type(prev)):
            raise TypeError(
                "attribute %r holds a %s; rebinding it to a %s would "
                "orphan the registered one" % (name, type(prev).__name__,
                                               type(value).__name__))
        if isinstance(value, Parameter):
            known = self._attr_params.get(name)
            if known is not None and known is not value:
                raise MXNetError("a Parameter named %r is already "
                                 "registered on this block" % name)
            self._attr_params[name] = value
        elif isinstance(value, Block):
            self._check_child(value)
        super().__setattr__(name, value)

    def _check_child(self, block):
        pass

    def register_child(self, block, name=None):
        """Register `block` as a child, under `name` or its index
        (block.py:280)."""
        self._check_child(block)
        self.add_module(str(len(self._modules)) if name is None else name,
                        block)

    def register_forward_pre_hook(self, hook):
        """`hook(block, args)` before each forward, the args as NDArrays;
        returns a handle whose `detach()` removes it."""
        self._gluon_pre_hooks.append(hook)
        return _HookHandle(self._gluon_pre_hooks, hook)

    def register_forward_hook(self, hook):
        """`hook(block, args, output)` after each forward."""
        self._gluon_hooks.append(hook)
        return _HookHandle(self._gluon_hooks, hook)

    def _blocks(self):
        return [m for m in self.modules() if isinstance(m, Block)]

    # -- parameters -----------------------------------------------------
    def _new_param(self, attr, shape, buffer=False, device=None, **kwargs):
        """Make the Gluon parameter `attr` of this layer (shared by name
        through ``params=``), held as the block's tensor `attr`: zeros
        on `device` when `shape` is known, else None until the first
        forward finishes its deferred init."""
        p = self._params.get(attr, shape=shape, allow_deferred_init=True,
                             **kwargs)
        p._attach(self, attr, buffer)
        if p._tensor() is None and _known(p._shape):
            p._set_tensor(torch.zeros(p._shape, dtype=p.dtype,
                                      device=resolve_device(device)))
        self._attr_params[attr] = p
        return p

    def _infer_shapes(self, *args):
        """{attr: shape} of this block's parameters, from the inputs of
        its first forward. The port's layers know theirs; a user block
        must declare full shapes."""
        raise MXNetError(
            "%s: a parameter has unknown dims; the port infers them only "
            "in its own layers, so give the full shape to params.get"
            % type(self).__name__)

    def _ensure_params(self, *args):
        """Finish the deferred init of this block's parameters, with the
        shapes its inputs give, before the first forward that needs
        them."""
        if self._params_ready:
            return
        pending = [(a, p) for a, p in self._attr_params.items()
                   if p._tensor() is None]
        if pending:
            shapes = None
            for attr, p in pending:
                if not _known(p._shape):
                    # the JAX package traces the block here, which makes
                    # the variable with the unknown dims (its export shows
                    # them); make it at the same moment
                    p.var()
                    if shapes is None:
                        shapes = self._infer_shapes(*args)
                    p.shape = shapes[attr]
                p._finish_deferred_init()
                p.data()         # raises when it was never initialized
        self._params_ready = True

    def collect_params(self, select=None):
        """A `ParameterDict` of this block's and its children's
        parameters (block.py:193), by Gluon name in Gluon's order;
        `select` keeps the names a regex matches."""
        keep = re.compile(select).match if select else (lambda _: True)
        out = ParameterDict(self._params.prefix)
        for blk in self._blocks():
            out.update({k: v for k, v in blk._params.items() if keep(k)})
        return out

    def _collect_params_with_prefix(self, prefix=""):
        """{dotted block path: parameter} (block.py:205): the names
        `save_parameters` writes."""
        dot = prefix + "." if prefix else ""
        out = {dot + key: p for key, p in self._attr_params.items()}
        for name, child in self._modules.items():
            if isinstance(child, Block):
                out.update(child._collect_params_with_prefix(dot + name))
        return out

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        """Initialize every parameter of the block (block.py:292)."""
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def cast(self, dtype):
        """Cast the block's and its children's parameters to `dtype`
        (block.py:303); the input must then be of that dtype too."""
        for child in self.children():
            if isinstance(child, Block):
                child.cast(dtype)
        for p in self._params.values():
            p.cast(dtype)

    def hybridize(self, active=True, **kwargs):
        """Activate (or deactivate) hybridizing in every HybridBlock of
        this block (block.py:442)."""
        for child in self.children():
            if isinstance(child, Block):
                child.hybridize(active, **kwargs)

    # -- files ----------------------------------------------------------
    def save_parameters(self, filename):
        """Write the parameters to `filename` in ``nd.save``'s format,
        under their dotted block paths (block.py:218), in the JAX
        package's layouts: the two packages read each other's files."""
        _nd.save(filename, {k: NDArray(p._file_value()) for k, p in
                            self._collect_params_with_prefix().items()})

    def save_params(self, filename):
        warnings.warn("save_params is deprecated. Please use "
                      "save_parameters.")
        self.collect_params().save(filename, strip_prefix=self.prefix)

    def load_parameters(self, filename, ctx=None, allow_missing=False,
                        ignore_extra=False):
        """Load the parameters from a file that `save_parameters` or
        `save_params` wrote (either package's), or from a dict
        {name: tensor or NDArray} in this package's layouts (block.py:232).
        Dotted names are block paths; other names are Gluon names
        without this block's prefix. Existing tensors are written in
        place; a missing name, an extra name or a shape that differs
        raises unless allowed."""
        if isinstance(filename, dict):
            saved = {k: _as_tensor(v) for k, v in filename.items()}
            where, from_file = "load_parameters", False
        else:
            saved, where, from_file = _load_file(filename), filename, True
        own = self._collect_params_with_prefix()
        if not (saved or own):
            return
        if not any("." in k for k in saved):
            self.collect_params()._load_dict(
                {self.prefix + k.split(":", 1)[-1]: v
                 for k, v in saved.items()},
                ctx, allow_missing, ignore_extra, where, from_file)
            return
        missing = sorted(k for k in own if k not in saved)
        if missing and not allow_missing:
            raise MXNetError("%s lacks parameter(s) %s (missing; pass "
                             "allow_missing=True to initialize them "
                             "separately)" % (where, ", ".join(missing)))
        stray = sorted(k for k in saved if k not in own)
        if stray and not ignore_extra:
            raise MXNetError("%s carries parameter(s) %s, unexpected for "
                             "this block (pass ignore_extra=True to skip "
                             "them)" % (where, ", ".join(stray)))
        for key, value in saved.items():
            if key in own:
                own[key]._load_init(value, ctx, from_file)

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False):
        warnings.warn("load_params is deprecated. Please use "
                      "load_parameters.")
        self.load_parameters(filename, ctx, allow_missing, ignore_extra)

    # -- calling --------------------------------------------------------
    def __call__(self, *args, **kwargs):
        top = not getattr(_local, "inside", False)
        if top:
            _local.inside = True
            grad_was = torch.is_grad_enabled()
            torch.set_grad_enabled(autograd.is_recording())
        try:
            # hooks see NDArrays, as in the JAX package
            for hook in self._gluon_pre_hooks:
                hook(self, _wrap(args))
            out = self._dispatch(args, kwargs)
            for hook in self._gluon_hooks:
                hook(self, _wrap(args), _wrap(out))
        finally:
            if top:
                _local.inside = False
                torch.set_grad_enabled(grad_was)
        return out

    def _dispatch(self, args, kwargs):
        if _has(Symbol, args, kwargs):
            pvars = {k: p.var() for k, p in self._attr_params.items()}
            with self._naming:
                return self._symbolic(*args, **kwargs, **pvars)
        if getattr(self, "_active", False):
            return self._call_cached_op(args, kwargs)
        mode = _forward_mode(type(self))
        nd_in = _has(NDArray, args, kwargs)
        if mode == "tensor":
            out = self.forward(*_unwrap(args), **{
                k: _unwrap(v) for k, v in kwargs.items()})
            return _wrap(out) if nd_in else out
        fn = self.forward if mode == "ndarray" else \
            (lambda *a, **kw: HybridBlock.forward(self, *a, **kw))
        out = fn(*_wrap(args), **{k: _wrap(v) for k, v in kwargs.items()})
        return out if nd_in else _unwrap(out)

    def forward(self, *args):
        """Override to implement the computation (on NDArrays)."""
        raise NotImplementedError

    def _symbolic(self, *args, **kwargs):
        """This block's graph, on Symbol inputs: ``hybrid_forward`` with
        F = `symbol` for a user's block, ``_sym_forward`` for a layer of
        this package."""
        if _forward_mode(type(self)) == "hybrid":
            return self.hybrid_forward(_sym, *args, **kwargs)
        if not isinstance(self, HybridBlock):
            raise MXNetError("%s is not a HybridBlock: only a HybridBlock "
                             "traces to a Symbol" % type(self).__name__)
        return self._sym_forward(_sym, *args, **kwargs)

    def _sym_forward(self, F, *args, **params):
        """The graph of a layer of this package (F = `symbol`, `params`
        its parameters' variables): by default its forward, which then
        calls its children on Symbols."""
        return self.forward(*args)

    def _adopt_graph_shapes(self, shapes):
        """Finish the deferred init of this block's parameters with the
        shapes {name: shape in the graph's layout} a graph inferred."""
        pending = [p for p in self._attr_params.values()
                   if p._tensor() is None]
        for p in pending:
            if not _known(p._shape) and p.name in shapes:
                p.shape = p._from_graph_shape(shapes[p.name])
        if pending:
            self._shapes_known()
        for p in pending:
            p._finish_deferred_init()

    def _shapes_known(self):
        """Called when the block's parameter shapes have been filled in
        from a graph, before their tensors are made."""

    def summary(self, *inputs):
        """Print each block's name, type, output shape (when `inputs`
        are given, one forward runs without recording) and parameter
        count (block.py:555)."""
        shapes, handles = {}, []
        if inputs:
            for blk in self._blocks():
                handles.append(blk.register_forward_hook(
                    lambda b, _, out: shapes.setdefault(
                        id(b), [tuple(o.shape) for o in (
                            out if isinstance(out, (list, tuple))
                            else [out])])))
            try:
                with autograd.pause():
                    self(*inputs)
            finally:
                for h in handles:
                    h.detach()
        lines = ["%-40s %-20s %-24s %10s" % ("Layer", "Type", "Output",
                                             "Params")]
        total = 0
        for path, blk in self.named_modules():
            if not isinstance(blk, Block):
                continue
            n = sum(int(p.data().numel()) for p in blk._params.values()
                    if p._tensor() is not None)
            total += n
            depth = path.count(".") + bool(path)
            out = shapes.get(id(blk), "")
            lines.append("%-40s %-20s %-24s %10d" % (
                "  " * depth + blk.name, type(blk).__name__,
                str(out[0] if len(out) == 1 else out), n))
        lines.append("Parameters in total: %d" % total)
        print("\n".join(lines))


class HybridBlock(Block):
    """A block whose children are all HybridBlocks (block.py:331). A
    subclass that defines ``hybrid_forward(self, F, x, *args,
    **params)`` gets ``F`` = `mxnet_tpu_torch.ndarray`, NDArray inputs
    and its attribute parameters as NDArrays (block.py:522-546); once
    hybridized, F = `mxnet_tpu_torch.symbol` and Symbols, traced once."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._flags = []
        self._cached_op = None
        self._cached_graph = ()
        self._in_format = self._out_format = None
        self._binding_plan = None

    def _check_child(self, block):
        if not isinstance(block, HybridBlock):
            raise ValueError(
                "every child of a HybridBlock must itself be hybridizable; "
                "%r is a %s (use HybridSequential rather than Sequential "
                "for containers)" % (block.name, type(block).__name__))
        self._clear_cached_op()

    def _clear_cached_op(self):
        self._cached_graph = ()
        self._cached_op = None

    def hybridize(self, active=True, **kwargs):
        """Trace this block and its children to one graph at the next
        call and replay it after (block.py:298)."""
        self._active = active
        self._flags = list(kwargs.items())
        self._clear_cached_op()
        if active and (self._gluon_hooks or self._gluon_pre_hooks):
            warnings.warn("Forward hooks will not be invoked in "
                          "hybridized mode.")
        super().hybridize(active, **kwargs)

    def cast(self, dtype):
        self._clear_cached_op()
        super().cast(dtype)

    # -- the traced graph (block.py:360-470) ------------------------------
    def _get_graph(self, *args):
        """Trace once with Symbol inputs named ``data`` (``data0``, ...);
        cache the (input variables, grouped outputs) pair."""
        if not self._cached_graph:
            leaves, self._in_format = _tree_flatten(args, "input")
            names = (["data"] if len(leaves) == 1
                     else ["data%d" % i for i in range(len(leaves))])
            tracers = [_sym.var(n) for n in names]
            nested = _tree_unflatten(tracers, self._in_format)
            pvars = {k: p.var() for k, p in self._attr_params.items()}
            with self._naming:
                out = self._symbolic(*nested, **pvars)
            out_leaves, self._out_format = _tree_flatten(out, "output")
            self._cached_graph = tracers, _sym.Group(out_leaves)
        return self._cached_graph

    def _build_cache(self, *args):
        """The CachedOp of the traced graph, and where each of its inputs
        comes from at call time: a forward argument or a parameter
        (block.py:383)."""
        tracers, out = self._get_graph(*args)
        slot_of = {t.name: i for i, t in enumerate(tracers)}
        params = self.collect_params()
        graph_inputs = out.list_inputs()
        for name in graph_inputs:
            if name not in slot_of and name not in params:
                raise MXNetError(
                    "HybridBlock graph wants input %r, which is neither a "
                    "forward argument nor a collected Parameter" % name)
        wanted = set(graph_inputs)
        idle_data = sorted(i for n, i in slot_of.items() if n not in wanted)
        if idle_data:
            warnings.warn(
                "forward argument(s) %s of this HybridBlock do not reach "
                "the traced computation" % idle_data, stacklevel=4)
        idle_params = sorted(n for n in params if n not in wanted)
        if idle_params:
            warnings.warn(
                "Parameter(s) %s do not reach the traced computation"
                % ", ".join(idle_params), stacklevel=4)
        self._binding_plan = [
            ("data", slot_of[name]) if name in slot_of
            else ("param", params[name])
            for name in out.list_arguments() + out.list_auxiliary_states()]
        self._cached_op = CachedOp(out, self._flags)

    def _graph_shapes(self, *args):
        """{graph input name: shape} that the traced graph infers from
        `args` (their shapes and dtypes)."""
        tracers, out = self._get_graph(*args)
        leaves, _ = _tree_flatten(args, "input")
        known = {t.name: (tuple(x.shape), x.dtype if isinstance(
            x, torch.Tensor) else x._data.dtype)
            for t, x in zip(tracers, leaves)}
        var_structs, _ = infer_structs(out._entries, known)
        return {n: tuple(s.shape) for n, s in var_structs.items()
                if s is not None}

    def _deferred_infer_shape(self, *args):
        try:
            shapes = self._graph_shapes(*args)
        except Exception as e:  # noqa: BLE001 — the reference's message
            raise ValueError(
                "Deferred initialization failed because shape cannot be "
                "inferred. {}".format(e)) from None
        for blk in self._blocks():
            blk._adopt_graph_shapes(shapes)

    def _infer_shapes(self, *args):
        """The shapes of this block's own parameters, from its graph
        (a user block whose parameter has unknown dims)."""
        shapes = self._graph_shapes(*args)
        return {attr: p._from_graph_shape(shapes[p.name])
                for attr, p in self._attr_params.items()
                if p.name in shapes}

    def infer_shape(self, *args):
        """Fill in every parameter's shape from the inputs `args`
        (block.py:858)."""
        shapes = self._graph_shapes(*args)
        for p in self.collect_params().values():
            if p.name in shapes:
                p.shape = p._from_graph_shape(shapes[p.name])

    def _bind_plan(self, leaves):
        return [leaves[src] if kind == "data" else src._graph_value()
                for kind, src in self._binding_plan]

    def _call_cached_op(self, args, kwargs):
        """Run the cached graph on `args` (block.py:430), type in, type
        out: NDArrays give NDArrays, tensors give tensors."""
        if kwargs:
            raise MXNetError("a hybridized block takes its inputs "
                             "positionally, got %s" % sorted(kwargs))
        nd_in = _has(NDArray, args, kwargs)
        args = _unwrap(args)
        if self._cached_op is None:
            self._build_cache(*args)
        leaves, fmt = _tree_flatten(args, "input")
        if fmt != self._in_format:
            raise MXNetError(
                "HybridBlock called with input structure %r; traced with %r"
                % (fmt, self._in_format))
        try:
            bound = self._bind_plan(leaves)
        except DeferredInitializationError:
            self._deferred_infer_shape(*args)
            bound = self._bind_plan(leaves)
        out = _tree_unflatten(self._cached_op.run(bound), self._out_format)
        return _wrap(out) if nd_in else out

    def export(self, path, epoch=0):
        """Write ``path-symbol.json`` (the traced graph) and
        ``path-%04d.params`` (its parameters as ``arg:``/``aux:``
        entries, in the JAX package's layouts), which `SymbolBlock`, the
        Module API and the JAX package load (block.py:506)."""
        if not self._cached_graph:
            raise RuntimeError(
                "Please first call block.hybridize() and then run forward "
                "with this block at least once before calling export.")
        sym = self._cached_graph[1]
        sym.save("%s-symbol.json" % path)
        kind_of = {n: "arg" for n in sym.list_arguments()}
        kind_of.update((n, "aux") for n in sym.list_auxiliary_states())
        payload = {"%s:%s" % (kind_of[name], name): NDArray(p._file_value())
                   for name, p in self.collect_params().items()
                   if name in kind_of}
        _nd.save("%s-%04d.params" % (path, epoch), payload)

    def forward(self, x, *args, **kwargs):
        """Calls ``hybrid_forward(F, x, *args, **params)`` on NDArrays,
        finishing the deferred init of the block's own parameters first
        (block.py:522)."""
        try:
            pdata = {k: NDArray(p.data())
                     for k, p in self._attr_params.items()}
        except DeferredInitializationError:
            self._ensure_params(x, *args)
            pdata = {k: NDArray(p.data())
                     for k, p in self._attr_params.items()}
        return self.hybrid_forward(_nd, x, *args, **kwargs, **pdata)

    def hybrid_forward(self, F, x, *args, **kwargs):
        """Override to implement the computation."""
        raise NotImplementedError


class SymbolBlock(HybridBlock):
    """A block that runs a Symbol graph (block.py:555): every graph input
    that is not one of `inputs` becomes a parameter (aux states with
    ``grad_req="null"``), waiting for its shape until the first call.
    It always runs through its CachedOp."""

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock from files that `export` (or the JAX package's
        export, or `Module.save_checkpoint`) wrote (block.py:580)."""
        if isinstance(input_names, str):
            input_names = [input_names]
        blk = SymbolBlock(_sym.load(symbol_file),
                          [_sym.var(n) for n in input_names])
        if param_file is not None:
            saved = _load_file(param_file)
            for name, p in blk.collect_params().items():
                # prefer the export format's explicit tags over bare names
                for key in ("arg:" + name, "aux:" + name, name):
                    if key in saved:
                        p._load_init(saved[key], ctx)
                        break
        return blk

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix=None, params=params)
        self._prefix = ""
        self._params = ParameterDict("", params)
        if isinstance(outputs, (list, tuple)):
            if len(outputs) == 1 and isinstance(outputs[0], list):
                outputs = outputs[0]
            outputs = _sym.Group(outputs)
        if isinstance(inputs, Symbol) and len(inputs.list_outputs()) == 1:
            inputs = [inputs]
        in_syms, self._in_format = _tree_flatten(inputs, "input")
        out_leaves, self._out_format = _tree_flatten(outputs, "output")
        graph = _sym.Group(out_leaves)
        feed_names = set()
        for s_ in in_syms:
            ent = s_._entries
            if len(ent) != 1 or not ent[0][0].is_variable:
                raise MXNetError(
                    "SymbolBlock inputs must be plain variables; %r is "
                    "computed by an operator" % str(s_))
            feed_names.add(s_.name)
        for name in graph.list_arguments():
            if name not in feed_names:
                self.params.get(name, allow_deferred_init=True)
        for name in graph.list_auxiliary_states():
            if name not in feed_names:
                self.params.get(name, grad_req="null",
                                allow_deferred_init=True)
        self._cached_graph = in_syms, graph
        strip = len(os.path.commonprefix(list(self._params.keys()))) \
            if len(self._params) else 0
        self._attr_params = {k[strip:]: v for k, v in self._params.items()}
        self._active = True

    def hybridize(self, active=True, **kwargs):
        """A SymbolBlock is a graph already: it always replays it."""
        super().hybridize(active, **kwargs)
        self._active = True

    def _clear_cached_op(self):
        keep = self._cached_graph     # the graph is this block's definition
        super()._clear_cached_op()
        self._cached_graph = keep

    def _sym_forward(self, F, x, *args, **params):
        _, in_fmt = _tree_flatten([x] + list(args), "input")
        if in_fmt != self._in_format:
            raise MXNetError(
                "SymbolBlock called with input structure %r; built with %r"
                % (in_fmt, self._in_format))
        ret = copy.copy(self._cached_graph[1])
        return _tree_unflatten(list(ret), self._out_format)


def collect_params(module):
    """{Gluon name: module path} of every parameter tensor held by a
    block of `module`, in the order Gluon collects them (the module path
    is what `torch.func.functional_call` takes). Parameters whose
    deferred init has not run yet have no tensor and are left out."""
    out = {}
    for path, mod in module.named_modules():
        if not isinstance(mod, Block):
            continue
        for attr, p in mod._attr_params.items():
            held = attr in mod._parameters or attr in mod._buffers
            if held and p.name not in out and \
                    (mod._parameters.get(attr) is not None
                     or mod._buffers.get(attr) is not None):
                out[p.name] = "%s.%s" % (path, attr) if path else attr
    return out
