"""Momentum SGD over many tensors in one pass: a hand-written CUDA kernel
and its plain PyTorch version.

Replaces mxnet_tpu/ops/pallas_kernels.py `fused_sgd_momentum` (:225, body
`_sgd_mom_kernel` :216). The kernel is ``csrc/sgd_momentum.cu``; its
source note says what bounds it on the H100 (device memory, and the host
that feeds it) and how its design answers that: one launch for all of a
step's tensors, through a table of the parameter and momentum pointers
that an `SGDMomentumPlan` uploads once, with the gradients' pointers
passed by value at each launch.

Per element, for fp32 m and fp32 or bf16 w and g::

    m' = momentum * m + (rescale * g + wd * w)
    w' = w - lr * m'.to(w.dtype)

accumulated in fp32, each output cast back to its input's dtype. With
``rescale=1`` this is `sgd_update` of mxnet_tpu/parallel/data_parallel.py
(:56) exactly. The Pallas body casts m to g's dtype before it accumulates
(:220), so with bf16 g it accumulates in bf16; both versions here take
the promoted dtype, fp32, as that function's docstring says.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from . import _build

__all__ = ["SGDMomentumPlan", "fused_sgd_momentum", "sgd_momentum_plain"]

_fn = None
_chunk = None
_cap = None


def _kernel():
    global _fn, _chunk, _cap
    if _fn is None:
        lib = _build.load("sgd_momentum")
        fn = lib.mxtpu_sgd_momentum
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int] + [
                           ctypes.c_float] * 4 + [ctypes.c_int,
                                                  ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.mxtpu_sgd_momentum_chunk.restype = ctypes.c_longlong
        _chunk = int(lib.mxtpu_sgd_momentum_chunk())
        _cap = int(lib.mxtpu_sgd_momentum_max_tensors())
        _fn = fn
    return _fn


def sgd_momentum_plain(w, g, m, lr, momentum=0.9, wd=0.0, rescale=1.0):
    """The kernel's function on one tensor in plain PyTorch (the CPU path
    and the reference the kernel is held against). Returns (w', m')."""
    wf = w.float()
    mf = momentum * m.float() + (g.float() * rescale + wd * wf)
    w_new = wf - lr * mf.to(w.dtype).float()
    return w_new.to(w.dtype), mf.to(m.dtype)


def _check_state(ws, ms):
    if len(ws) != len(ms) or not ws:
        raise MXNetError("fused_sgd_momentum: needs equal, non-empty lists "
                         "of weights and momenta, got %d, %d"
                         % (len(ws), len(ms)))
    dev, dt = ws[0].device, ws[0].dtype
    for i, (w, m) in enumerate(zip(ws, ms)):
        if w.dtype != dt or m.dtype != torch.float32:
            raise MXNetError(
                "fused_sgd_momentum: tensor %d: w must share one dtype "
                "across the list and m must be float32, got w %s, m %s"
                % (i, w.dtype, m.dtype))
        if m.shape != w.shape:
            raise MXNetError("fused_sgd_momentum: tensor %d: shapes w %s, "
                             "m %s differ" % (i, tuple(w.shape),
                                              tuple(m.shape)))
        for name, t in (("w", w), ("m", m)):
            if t.device != dev:
                raise MXNetError("fused_sgd_momentum: tensor %d: %s is on "
                                 "%s, not %s" % (i, name, t.device, dev))
            if not t.is_contiguous():
                raise MXNetError("fused_sgd_momentum: tensor %d: %s must "
                                 "be contiguous" % (i, name))


def _check_grads(gs, shapes, dtype, dev):
    for i, (g, shape) in enumerate(zip(gs, shapes)):
        if g.shape != shape:
            raise MXNetError("fused_sgd_momentum: tensor %d: shapes w %s, g "
                             "%s differ" % (i, tuple(shape), tuple(g.shape)))
        if g.dtype != dtype or g.device != dev or not g.is_contiguous():
            raise MXNetError(
                "fused_sgd_momentum: tensor %d: g must be a contiguous %s "
                "tensor on %s, got %s on %s (contiguous: %s)"
                % (i, dtype, dev, g.dtype, g.device, g.is_contiguous()))


class SGDMomentumPlan:
    """The momentum-SGD update of fixed weight and momentum lists, set up
    once and run every step with new gradients.

    Building the plan validates `ws` and `ms` (w of one dtype, float32 m
    of w's shape, all contiguous on one device) and, on CUDA, uploads the
    kernel's table of their pointers, sizes and chunks; the plan holds
    references to the tensors, so the pointers stay valid. A call takes
    the gradients, in `ws` order, and the hyper-parameters, checks each
    gradient's dtype, shape, device and contiguity, and updates every w
    and m in place: on CUDA tensors by launching the kernel (one launch
    per 480 tensors, the pointers a launch's parameters carry; counted in
    ``fused_sgd_momentum.launches``) or raising, on CPU tensors by
    `sgd_momentum_plain` per tensor. Only the gradient pointers go to the
    device per call, inside the launch.
    """

    def __init__(self, ws, ms):
        ws, ms = list(ws), list(ms)
        _check_state(ws, ms)
        self._ws, self._ms = ws, ms
        self._dev = ws[0].device
        self._dtype = ws[0].dtype
        self._shapes = [w.shape for w in ws]
        # -1 on the CPU, as Tensor.get_device() gives it
        self._dev_index = -1 if self._dev.type == "cpu" else self._dev.index
        # per launch: (device table, tensor indices, chunks, the launch's
        # gradient-pointer array, refilled each call)
        self._launches = []
        if self._dev.type == "cpu":
            return
        _kernel()
        live = [i for i, w in enumerate(ws) if w.numel()]
        for start in range(0, len(live), _cap):
            idx = live[start:start + _cap]
            rows, nchunks = [], 0
            for i in idx:
                n = ws[i].numel()
                rows += [ws[i].data_ptr(), ms[i].data_ptr(), n, nchunks]
                nchunks += -(-n // _chunk)
            # a blocking copy: every later launch, on whatever stream is
            # current then, finds the table in place
            table = torch.tensor(rows, dtype=torch.int64).to(self._dev)
            self._launches.append((table, idx, nchunks,
                                   (ctypes.c_void_p * len(idx))()))

    def __call__(self, gs, lr, momentum=0.9, wd=0.0, rescale=1.0):
        if len(gs) != len(self._ws):
            raise MXNetError("fused_sgd_momentum: the plan has %d tensors, "
                             "got %d gradients" % (len(self._ws), len(gs)))
        dt, di = self._dtype, self._dev_index
        for g, shape in zip(gs, self._shapes):
            if g.shape != shape or g.dtype != dt or g.get_device() != di \
                    or not g.is_contiguous():
                _check_grads(gs, self._shapes, dt, self._dev)
        if di < 0:
            for w, g, m in zip(self._ws, gs, self._ms):
                w_new, m_new = sgd_momentum_plain(w, g, m, lr, momentum, wd,
                                                  rescale)
                w.copy_(w_new)
                m.copy_(m_new)
            return
        code = _build.dtype_code(self._ws[0])
        stream = _build.stream_of(self._ws[0])
        for table, idx, nchunks, ptrs in self._launches:
            ptrs[:] = [gs[i].data_ptr() for i in idx]
            rc = _fn(table.data_ptr(), ptrs, len(idx), nchunks, code,
                     float(lr), float(momentum), float(wd), float(rescale),
                     di, stream)
            _build.check_launch(rc, "fused_sgd_momentum")
            fused_sgd_momentum.launches += 1


def fused_sgd_momentum(ws, gs, ms, lr, momentum=0.9, wd=0.0, rescale=1.0):
    """Update every w in `ws` and m in `ms` in place from the gradients
    `gs` (lists of tensors of matching shapes), through a one-off
    `SGDMomentumPlan`. On CUDA tensors this is one launch of the kernel
    for all of them (counted in ``fused_sgd_momentum.launches``), or it
    raises; on CPU tensors it runs `sgd_momentum_plain` per tensor. A
    caller that updates the same tensors every step keeps a plan."""
    ws, gs, ms = list(ws), list(gs), list(ms)
    if not (len(ws) == len(gs) == len(ms)) or not ws:
        raise MXNetError("fused_sgd_momentum: needs equal, non-empty lists "
                         "of weights, gradients and momenta, got %d, %d, %d"
                         % (len(ws), len(gs), len(ms)))
    # the gradients first: the plan loads the kernel once ws, ms check out
    _check_grads(gs, [w.shape for w in ws], ws[0].dtype, ws[0].device)
    SGDMomentumPlan(ws, ms)(gs, lr, momentum, wd, rescale)


#: kernel launches so far (the plain CPU path does not count)
fused_sgd_momentum.launches = 0
