"""Imperative autograd scopes and backward (counterpart of
mxnet_tpu/autograd.py).

Two thread-local flags, as in the JAX package (:31-45): *recording*
(`record` :71 turns it on, `pause` :76 off) and *training* (`record` and
`train_mode` :80 turn it on, `pause` and `predict_mode` :84 off). The
port's layers read `is_training()` for their mode: BatchNorm normalises
with batch statistics and moves its running statistics only in training
mode, so ``net(x)`` outside `record()` predicts and writes nothing.

The tape is PyTorch's: `record()` turns torch's grad mode on and `pause()`
turns it off, for the scope. `backward` (:266) takes the gradients of the
heads with respect to every live Gluon `Parameter` whose ``grad_req`` is
"write" or "add", through `torch.autograd.grad`, and writes them with
MXNet's semantics: "write" replaces the parameter's gradient, "add" adds
to it, and a parameter the heads do not reach keeps its gradient. Each
written gradient gets the fresh mark that
``Trainer.step(ignore_stale_grad=True)`` reads. Torch's own ``.grad``
accumulation is not used.
"""
from __future__ import annotations

import threading
import weakref

import torch

from .base import MXNetError

__all__ = ["backward", "is_recording", "is_training", "pause",
           "predict_mode", "record", "set_recording", "set_training",
           "train_mode"]

_state = threading.local()

# every Gluon Parameter that may take a gradient; `backward` writes those
# the heads reach (a weak set: a dropped block's parameters leave it)
_live = weakref.WeakSet()


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


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Gradients of `heads` (a tensor or a list) with respect to every
    live parameter they reach, written as each one's ``grad_req`` says.
    `head_grads` seed the heads (None: ones, MXNet's seed for a
    per-sample loss). Raises `MXNetError` when no head was recorded."""
    if isinstance(heads, torch.Tensor):
        heads = [heads]
    # plain tensors: the gradients must not inherit NDArray's type
    heads = [h.as_subclass(torch.Tensor) for h in heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, torch.Tensor):
        head_grads = [head_grads]
    seeds = [torch.ones_like(h) if g is None
             else g.as_subclass(torch.Tensor)
             for h, g in zip(heads, head_grads)]
    if not all(h.requires_grad for h in heads):
        raise MXNetError("cannot differentiate: output is not in the "
                         "recorded graph (was it computed under "
                         "autograd.record()?)")
    params = [p for p in list(_live) if p._takes_grad()]
    leaves = [p.data() for p in params]
    if not leaves:
        return
    grads = torch.autograd.grad(heads, leaves, seeds,
                                retain_graph=retain_graph, allow_unused=True)
    for p, g in zip(params, grads):
        if g is not None:
            p._write_grad(g)
