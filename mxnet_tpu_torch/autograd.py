"""Imperative autograd scopes and backward (counterpart of
mxnet_tpu/autograd.py).

Two thread-local flags, as in the JAX package (:31-45): *recording*
(`record` :71 turns it on, `pause` :76 off) and *training* (`record` and
`train_mode` :80 turn it on, `pause` and `predict_mode` :84 off). The
port's layers read `is_training()` for their mode: BatchNorm normalises
with batch statistics and moves its running statistics only in training
mode, so ``net(x)`` outside `record()` predicts and writes nothing.

The tape is PyTorch's: `record()` turns torch's grad mode on and `pause()`
turns it off, for the scope. Outside them torch's grad mode is whatever
the caller set, so every entry point of the port that computes (a
top-level `HybridBlock` call, `ndarray.invoke`) runs under
``torch.set_grad_enabled(is_recording())``: a predict-mode ``net(x)``
builds no graph and keeps no activation alive.

`backward` (:266) takes the gradients of the heads (NDArrays or
tensors recorded by the port) with respect to every live variable: each
Gluon `Parameter` whose ``grad_req`` is "write" or "add", and each
NDArray given a gradient buffer by ``attach_grad`` or `mark_variables`,
through `torch.autograd.grad`, and writes them with MXNet's semantics:
"write" replaces the gradient, "add" adds to it, "null" has none, and a
variable the heads do not reach keeps its gradient. Each written
gradient gets the fresh mark that ``Trainer.step(ignore_stale_grad=True)``
reads. Torch's own ``.grad`` accumulation is not used. A head that the
port did not record (computed outside ``record()``) raises `MXNetError`
with the reference's words (:171-174).

`grad` (:486) returns the gradients instead of writing them, and with
``create_graph=True`` records them, so they can be differentiated again;
`Function` (:513) is a custom differentiable function on NDArrays.
"""
from __future__ import annotations

import threading
import weakref

import torch

from .base import MXNetError

__all__ = ["Function", "backward", "grad", "is_recording", "is_training",
           "mark_variables", "pause", "predict_mode", "record",
           "set_recording", "set_training", "train_mode"]

_state = threading.local()

# every Gluon Parameter that may take a gradient, and every NDArray with a
# gradient buffer; `backward` writes those the heads reach (weak sets: a
# dropped block's parameters, a dropped array, leave them)
_live = weakref.WeakSet()
_live_arrays = weakref.WeakSet()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
    return _state


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def set_recording(is_record):
    """Set the recording flag; returns the previous one. Torch's grad mode
    follows it."""
    prev = _st().recording
    _state.recording = bool(is_record)
    torch.set_grad_enabled(bool(is_record))
    return prev


def set_training(train_mode):
    prev = _st().training
    _state.training = bool(train_mode)
    return prev


class _RecordingStateScope:
    def __init__(self, is_record, train_mode):
        self._record = is_record
        self._train = train_mode
        self._prev = None
        self._grad = None

    def __enter__(self):
        st = _st()
        self._prev = (st.recording, st.training)
        if self._record is not None:
            st.recording = self._record
            self._grad = torch.is_grad_enabled()
            torch.set_grad_enabled(self._record)
        if self._train is not None:
            st.training = self._train
        return self

    def __exit__(self, *exc):
        _state.recording, _state.training = self._prev
        if self._grad is not None:
            torch.set_grad_enabled(self._grad)
        return False


def record(train_mode=True):
    """Scope in which operations are recorded for `backward`."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


def _track(param):
    """Called by `gluon.Parameter` when it may take a gradient."""
    _live.add(param)


def _track_array(arr):
    """Called by `NDArray.attach_grad`."""
    _live_arrays.add(arr)


_NOT_RECORDED = ("cannot differentiate: output is not in the recorded "
                 "graph (was it computed under autograd.record()?)")


def _tensors(heads, head_grads):
    """(head tensors, seeds): NDArrays unwrapped, None seeds as ones."""
    from .ndarray import NDArray
    if isinstance(heads, (NDArray, torch.Tensor)):
        heads = [heads]
    hs = [h._data if isinstance(h, NDArray) else h for h in heads]
    if head_grads is None:
        head_grads = [None] * len(hs)
    elif isinstance(head_grads, (NDArray, torch.Tensor)):
        head_grads = [head_grads]
    seeds = [torch.ones_like(h) if g is None else
             (g._data if isinstance(g, NDArray) else g)
             for h, g in zip(hs, head_grads)]
    for h in hs:
        if not h.requires_grad:
            raise MXNetError(_NOT_RECORDED)
    return hs, seeds


def _autograd(heads, leaves, seeds, retain_graph, create_graph=False):
    try:
        return torch.autograd.grad(heads, leaves, seeds,
                                   retain_graph=retain_graph,
                                   create_graph=create_graph,
                                   allow_unused=True)
    except RuntimeError as e:
        if "modified by an inplace operation" in str(e):
            raise MXNetError(
                "backward: an array that the recorded graph saved was "
                "overwritten in place since: %s" % e) from None
        if "backward through the graph a second time" in str(e):
            raise MXNetError(
                "backward: graph was already freed (pass "
                "retain_graph=True to backward() to reuse it)") from None
        raise


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of `heads` (an NDArray or tensor, or a list) with respect
    to every live variable they reach, written as each one's
    ``grad_req`` says. `head_grads` seed the heads (None: ones, MXNet's
    seed for a per-sample loss). Raises `MXNetError` for a head the port
    did not record."""
    hs, seeds = _tensors(heads, head_grads)
    params = [p for p in list(_live) if p._takes_grad()]
    arrays = [a for a in list(_live_arrays)
              if a._grad_req in ("write", "add") and a._data.requires_grad
              and a._data.is_leaf]
    leaves = [p.data() for p in params] + [a._data for a in arrays]
    if not leaves:
        return
    with torch.set_grad_enabled(False):
        grads = _autograd(hs, leaves, seeds, retain_graph)
    for p, g in zip(params, grads):
        if g is not None:
            p._write_grad(g)
    for a, g in zip(arrays, grads[len(params):]):
        if g is not None:
            _write_array_grad(a, g)


def _write_array_grad(arr, g):
    """"write" replaces the buffer's values, "add" adds to them, in
    place; the buffer becomes fresh."""
    buf = arr._grad
    with torch.no_grad():
        if arr._grad_req == "add":
            buf._data.add_(g)
        else:
            buf._data.copy_(g)
    buf._fresh_grad = True


def mark_variables(variables, gradients=None, grad_reqs="write"):
    """Make arrays variables of the graph (:127): each gets a gradient
    buffer, the array in `gradients` where one is given (backward writes
    into it in place), with its `grad_reqs`."""
    from .ndarray import NDArray
    if isinstance(variables, NDArray):
        variables = [variables]
    if gradients is None:
        gradients = [None] * len(variables)
    elif isinstance(gradients, NDArray):
        gradients = [gradients]
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for v, g, req in zip(variables, gradients, grad_reqs):
        v.attach_grad(grad_req=req)
        if g is not None:
            v._grad = g


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """The gradients of `heads` with respect to `variables` (NDArrays of
    the recorded graph), returned as NDArrays and written nowhere
    (:486). With ``create_graph=True`` they are recorded themselves, so
    a later backward or grad differentiates through them."""
    from .ndarray import NDArray
    hs, seeds = _tensors(heads, head_grads)
    if isinstance(variables, NDArray):
        variables = [variables]
    if retain_graph is None:
        retain_graph = create_graph
    leaves = [v._data for v in variables]
    for t in leaves:
        if not t.requires_grad:
            raise MXNetError("autograd.grad: a variable is not in the "
                             "recorded graph (call attach_grad first)")
    with torch.set_grad_enabled(bool(create_graph)):
        gs = _autograd(hs, leaves, seeds, retain_graph, create_graph)
    out = []
    for g in gs:
        if g is None:
            raise MXNetError("autograd.grad: a variable is unreachable "
                             "from the heads")
        out.append(NDArray(g))
    return out


class Function:
    """A custom differentiable function on NDArrays (:513): subclass it
    with `forward(self, *inputs)` and `backward(self, *output_grads)`,
    both on NDArrays; `save_for_backward` keeps what backward needs."""

    def __init__(self):
        self._saved = ()

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

    def __call__(self, *inputs):
        from .ndarray import NDArray
        func = self
        single = [False]

        class _Apply(torch.autograd.Function):
            @staticmethod
            def forward(ctx, *ts):
                with pause():
                    outs = func.forward(*[NDArray(t) for t in ts])
                single[0] = not isinstance(outs, (list, tuple))
                outs = [outs] if single[0] else list(outs)
                return tuple(o._data for o in outs)

            @staticmethod
            def backward(ctx, *gs):
                with pause():
                    grads = func.backward(*[NDArray(g) for g in gs])
                if not isinstance(grads, (list, tuple)):
                    grads = [grads]
                return tuple(None if g is None else g._data for g in grads)

        tensors = [x._data for x in inputs]
        if is_recording():
            res = _Apply.apply(*tensors)
        else:
            with pause():
                res = func.forward(*inputs)
            return res
        outs = [NDArray(t) for t in res]
        return outs[0] if single[0] else outs
