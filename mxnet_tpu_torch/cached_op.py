"""CachedOp: a traced graph replayed as one function over tensors
(counterpart of mxnet_tpu/cached_op.py: `CachedOp` :45; reference:
src/imperative/cached_op.cc, the backend of Gluon's hybridize()).

The graph function is built once per mode ("train" under
`autograd.is_training()`, else "predict", `graph.build_graph_fn`) and
replayed on every call. Nothing compiles it: the JAX package's one
`jax.jit` program is, here, the same sequence of registry ops with the
per-node work (parameter defaults, mode, the conv1x1+BN rewrite) done
once at build time. Under `autograd.record()` torch's autograd records
the replay, so the gradients reach the block's parameters through it,
as the JAX package's tape node does through its vjp (:107-124).
BatchNorm's new moving statistics are written back into the aux inputs
in place after a training call (:113-118).
"""
from __future__ import annotations

import torch

from . import autograd
from .base import MXNetError
from .graph import build_graph_fn, collect_vars
from .ndarray import NDArray

__all__ = ["CachedOp"]


class CachedOp:
    def __init__(self, sym, flags=()):
        self._symbol = sym
        self._flags = dict(flags) if not isinstance(flags, dict) else flags
        arg_nodes, aux_nodes = collect_vars(sym._entries)
        self._arg_names = [n.name for n in arg_nodes]
        self._aux_names = [n.name for n in aux_nodes]
        # call convention: inputs in list_inputs() order = args then aux
        self._input_names = self._arg_names + self._aux_names
        self._fns = {}

    @property
    def input_names(self):
        return list(self._input_names)

    @property
    def symbol(self):
        """The traced graph this op replays."""
        return self._symbol

    def _fn(self, mode):
        fn = self._fns.get(mode)
        if fn is None:
            fn = self._fns[mode] = build_graph_fn(self._symbol._entries,
                                                  mode)[0]
        return fn

    def run(self, tensors):
        """Replay the graph on `tensors` (in `input_names` order) in the
        mode `autograd` says; returns the output tensors."""
        if len(tensors) != len(self._input_names):
            raise MXNetError(
                "CachedOp: expected %d inputs (%s), got %d"
                % (len(self._input_names), self._input_names, len(tensors)))
        n_args = len(self._arg_names)
        args = dict(zip(self._arg_names, tensors[:n_args]))
        aux = dict(zip(self._aux_names, tensors[n_args:]))
        train = autograd.is_training()
        outs, auxup = self._fn("train" if train else "predict")(args, aux)
        if auxup:
            with torch.no_grad():
                for name, val in auxup.items():
                    tgt = aux[name]
                    if val.data_ptr() != tgt.data_ptr():
                        tgt.copy_(val)
        return outs

    def __call__(self, *inputs):
        """Run on NDArrays (or tensors); returns a list of NDArrays,
        recorded when `autograd.is_recording()`."""
        tensors = [x._data if isinstance(x, NDArray) else x for x in inputs]
        with torch.set_grad_enabled(autograd.is_recording()):
            outs = self.run(tensors)
        return [NDArray(o) for o in outs]
