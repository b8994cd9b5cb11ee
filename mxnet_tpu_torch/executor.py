"""Executor: a bound symbol graph with its argument, gradient and aux
arrays (counterpart of mxnet_tpu/executor.py: `Executor` :32,
`_simple_bind` :77, `_bind` :125, `forward` :214, `backward` :243,
`copy_params_from` :277, `reshape` :294, `set_monitor_callback` :308;
reference: src/executor/graph_executor.cc and python/mxnet/executor.py).

`bind` turns the whole graph into one function over tensors
(`graph.build_graph_fn`), one per mode. A training forward runs it with
torch's autograd on, against leaf aliases of the arrays whose `grad_req`
is not "null", and keeps the recorded graph; `backward` is
`torch.autograd.grad` through it, with ones as the head gradients unless
`out_grads` are given (the JAX package takes `jax.vjp` of the same
function, :173-189). Gradients land in the gradient arrays in place:
"write" replaces, "add" accumulates. BatchNorm's moving statistics are
written into the aux arrays in place after a training forward.
"""
from __future__ import annotations

import torch

from .base import MXNetError, dtype_from_name, dtype_name
from .context import resolve_device
from .graph import build_graph_fn, collect_vars, infer_structs
from .ndarray import NDArray

__all__ = ["Executor"]


def _tensor_of(v, like):
    t = v._data if isinstance(v, NDArray) else torch.as_tensor(v)
    return t.to(device=like.device, dtype=like.dtype)


def _assign(arr, value):
    """Write `value` into NDArray `arr`'s tensor in place (cast and moved
    to it); a value of another shape replaces the tensor."""
    t = value._data if isinstance(value, NDArray) else torch.as_tensor(value)
    if tuple(t.shape) != arr.shape:
        arr._data = t.to(device=arr._data.device, dtype=arr._data.dtype)
        return
    if t.data_ptr() == arr._data.data_ptr() and t.dtype == arr._data.dtype:
        return
    with torch.no_grad():
        arr._data.copy_(t)


class Executor:
    def __init__(self, symbol, ctx, arg_dict, grad_dict, grad_req_dict,
                 aux_dict):
        self._symbol = symbol
        self._ctx = ctx
        self.arg_dict = arg_dict          # name -> NDArray
        self.grad_dict = grad_dict        # name -> NDArray (grad buffers)
        self.aux_dict = aux_dict          # name -> NDArray
        self._grad_req = grad_req_dict    # name -> 'write'|'add'|'null'
        arg_nodes, aux_nodes = collect_vars(symbol._entries)
        self._arg_names = [n.name for n in arg_nodes]
        self._aux_names = [n.name for n in aux_nodes]
        self._grad_names = [n for n in self._arg_names
                            if grad_req_dict.get(n, "null") != "null"]
        self.arg_arrays = [arg_dict[n] for n in self._arg_names]
        self.grad_arrays = [grad_dict.get(n) for n in self._arg_names]
        self.aux_arrays = [aux_dict[n] for n in self._aux_names]
        self.outputs = []
        self._fns = {}          # mode -> graph function
        self._pending = None    # (outputs, leaves) of a training forward
        self._monitor_callback = None

    # ------------------------------------------------------------------
    # binding constructors (reference: MXExecutorSimpleBind / Bind)
    # ------------------------------------------------------------------
    @staticmethod
    def _normalize_grad_req(grad_req, arg_names):
        if isinstance(grad_req, str):
            return {n: grad_req for n in arg_names}
        if isinstance(grad_req, (list, tuple)):
            return dict(zip(arg_names, grad_req))
        out = {n: "null" for n in arg_names}
        out.update(grad_req or {})
        return out

    @classmethod
    def _simple_bind(cls, symbol, ctx, grad_req="write", type_dict=None,
                     shared_exec=None, shape_kwargs=None):
        shape_kwargs = shape_kwargs or {}
        type_dict = type_dict or {}
        known = {}
        for k, v in shape_kwargs.items():
            known[k] = (tuple(v), dtype_from_name(type_dict.get(k,
                                                                "float32")))
        # honor __shape__ attrs on variables (reference: var(shape=...)),
        # those without unknown (0) dims
        arg_nodes, aux_nodes = collect_vars(symbol._entries)
        for n in arg_nodes + aux_nodes:
            if n.name not in known and "__shape__" in n.attrs and \
                    0 not in tuple(n.attrs["__shape__"]):
                dt = dtype_from_name(
                    n.attrs.get("__dtype__", type_dict.get(n.name, "float32")))
                known[n.name] = (tuple(n.attrs["__shape__"]), dt)
        var_structs, _ = infer_structs(symbol._entries, known, mode="train")
        arg_names = [n.name for n in arg_nodes]
        missing = [n for n in arg_names + [a.name for a in aux_nodes]
                   if var_structs.get(n) is None]
        if missing:
            raise MXNetError(
                "simple_bind: could not infer shapes for %s — provide their "
                "shapes as keyword arguments" % missing)
        device = resolve_device(ctx)

        def alloc(name):
            s = var_structs[name]
            # reuse shared executor memory where shapes match (reference:
            # shared_exec bucketing path)
            if shared_exec is not None:
                prev = shared_exec.arg_dict.get(name)
                if prev is None:
                    prev = shared_exec.aux_dict.get(name)
                if prev is not None and prev.shape == tuple(s.shape) and \
                        prev._data.dtype == s.dtype:
                    return prev
            return NDArray(torch.zeros(s.shape, dtype=s.dtype,
                                       device=device))

        arg_dict = {n: alloc(n) for n in arg_names}
        aux_dict = {n.name: alloc(n.name) for n in aux_nodes}
        req = cls._normalize_grad_req(grad_req, arg_names)
        grad_dict = {}
        for n in arg_names:
            if req.get(n, "null") != "null":
                s = var_structs[n]
                grad_dict[n] = NDArray(torch.zeros(s.shape, dtype=s.dtype,
                                                   device=device))
        return cls(symbol, ctx, arg_dict, grad_dict, req, aux_dict)

    @classmethod
    def _bind(cls, symbol, ctx, args=None, args_grad=None, grad_req="write",
              aux_states=None, shared_exec=None):
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        if isinstance(args, (list, tuple)):
            arg_dict = dict(zip(arg_names, args))
        else:
            arg_dict = dict(args or {})
        if isinstance(aux_states, (list, tuple)):
            aux_dict = dict(zip(aux_names, aux_states))
        else:
            aux_dict = dict(aux_states or {})
        missing = [n for n in arg_names if n not in arg_dict]
        if missing:
            raise MXNetError("bind: missing arguments %s" % missing)
        missing_aux = [n for n in aux_names if n not in aux_dict]
        if missing_aux:
            raise MXNetError("bind: missing aux states %s" % missing_aux)
        device = resolve_device(ctx)
        arg_dict = {k: v if isinstance(v, NDArray) else
                    NDArray(torch.as_tensor(v, device=device))
                    for k, v in arg_dict.items()}
        req = cls._normalize_grad_req(grad_req, arg_names)
        if isinstance(args_grad, (list, tuple)):
            grad_dict = {n: g for n, g in zip(arg_names, args_grad)
                         if g is not None}
        else:
            grad_dict = dict(args_grad or {})
        for n in arg_names:
            if req.get(n, "null") != "null" and n not in grad_dict:
                grad_dict[n] = NDArray(torch.zeros_like(arg_dict[n]._data))
        for n in list(grad_dict):
            if req.get(n, "null") == "null":
                del grad_dict[n]
        return cls(symbol, ctx, arg_dict, grad_dict, req, aux_dict)

    # ------------------------------------------------------------------
    # the graph functions
    # ------------------------------------------------------------------
    def _fn(self, mode):
        fn = self._fns.get(mode)
        if fn is None:
            fn = self._fns[mode] = build_graph_fn(self._symbol._entries,
                                                  mode=mode)[0]
        return fn

    def _raw_inputs(self):
        args = {n: self.arg_dict[n]._data for n in self._arg_names}
        aux = {n: self.aux_dict[n]._data for n in self._aux_names}
        return args, aux

    def _run_recorded(self, args, aux):
        """The training graph with autograd on, against leaf aliases of
        the arrays that take gradients: (outputs, aux_updates, leaves)."""
        leaves = {n: args[n].detach().requires_grad_(True)
                  for n in self._grad_names
                  if args[n].is_floating_point()}
        with torch.enable_grad():
            outs, auxup = self._fn("train")({**args, **leaves}, aux)
        return outs, auxup, leaves

    # ------------------------------------------------------------------
    # public API (reference: executor.py forward/backward/outputs)
    # ------------------------------------------------------------------
    def forward(self, is_train=False, **kwargs):
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("forward: unknown argument %r" % k)
            _assign(self.arg_dict[k], v)
        args, aux = self._raw_inputs()
        if is_train and self._grad_names:
            outs, auxup, leaves = self._run_recorded(args, aux)
            self._pending = (outs, leaves)
        else:
            with torch.no_grad():
                outs, auxup = self._fn("train" if is_train else
                                       "predict")(args, aux)
            self._pending = None
        if is_train:
            for name, val in auxup.items():
                _assign(self.aux_dict[name], val.detach())
        self.outputs = [NDArray(o.detach()) for o in outs]
        if self._monitor_callback is not None:
            for name, out in zip(self._symbol.list_outputs(), self.outputs):
                self._monitor_callback(name, out)
        return self.outputs

    def backward(self, out_grads=None, is_train=True):
        if not self._grad_names:
            return
        if self._pending is None:
            # no training forward to differentiate: replay one from the
            # current arrays, leaving the aux states as they are
            outs, _, leaves = self._run_recorded(*self._raw_inputs())
        else:
            outs, leaves = self._pending
        self._pending = None
        if out_grads is None:
            seeds = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, (NDArray, torch.Tensor)):
                out_grads = [out_grads]
            seeds = [_tensor_of(g, o) for g, o in zip(out_grads, outs)]
        heads = [(o, s) for o, s in zip(outs, seeds) if o.requires_grad]
        names = list(leaves)
        grads = [None] * len(names)
        if heads:
            grads = torch.autograd.grad(
                [h for h, _ in heads], [leaves[n] for n in names],
                grad_outputs=[s for _, s in heads], allow_unused=True)
        with torch.no_grad():
            for name, g in zip(names, grads):
                buf = self.grad_dict.get(name)
                if buf is None:
                    continue
                if g is None:
                    if self._grad_req.get(name) != "add":
                        buf._data.zero_()
                elif self._grad_req.get(name) == "add":
                    buf._data.add_(g)
                else:
                    buf._data.copy_(g)

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for name, arr in (arg_params or {}).items():
            if name in self.arg_dict:
                _assign(self.arg_dict[name], arr)
            elif not allow_extra_params:
                raise MXNetError("copy_params_from: %r not an argument" % name)
        for name, arr in (aux_params or {}).items():
            if name in self.aux_dict:
                _assign(self.aux_dict[name], arr)
            elif not allow_extra_params:
                raise MXNetError("copy_params_from: %r not an aux state"
                                 % name)

    def reshape(self, partial_shaping=False, allow_up_sizing=False, **kwargs):
        """A new executor for new input shapes; arrays whose shapes do not
        change are shared with this one."""
        type_dict = {n: dtype_name(self.arg_dict[n]._data.dtype)
                     for n in kwargs if n in self.arg_dict}
        return Executor._simple_bind(
            self._symbol, self._ctx, grad_req=self._grad_req,
            type_dict=type_dict, shape_kwargs=dict(kwargs), shared_exec=self)

    def set_monitor_callback(self, callback, monitor_all=False):
        self._monitor_callback = callback

    @property
    def symbol(self):
        return self._symbol

    def debug_str(self):
        return self._symbol.debug_str()
