"""Momentum SGD over many tensors in one pass: a hand-written CUDA kernel
and its plain PyTorch version.

Replaces mxnet_tpu/ops/pallas_kernels.py `fused_sgd_momentum` (:225, body
`_sgd_mom_kernel` :216). The kernel is ``csrc/sgd_momentum.cu``; its
source note says what bounds it on the H100 (device memory) and how its
design answers that (one launch for all of a step's tensors, through a
table of pointers).

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

__all__ = ["fused_sgd_momentum", "sgd_momentum_plain"]

_fn = None
_chunk = None


def _kernel():
    global _fn, _chunk
    if _fn is None:
        lib = _build.load("sgd_momentum")
        fn = lib.mxtpu_sgd_momentum
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int] + [ctypes.c_float] * 4 + [
                           ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.mxtpu_sgd_momentum_chunk.restype = ctypes.c_longlong
        _chunk = int(lib.mxtpu_sgd_momentum_chunk())
        _fn = fn
    return _fn


def sgd_momentum_plain(w, g, m, lr, momentum=0.9, wd=0.0, rescale=1.0):
    """The kernel's function on one tensor in plain PyTorch (the CPU path
    and the reference the kernel is held against). Returns (w', m')."""
    wf = w.float()
    mf = momentum * m.float() + (g.float() * rescale + wd * wf)
    w_new = wf - lr * mf.to(w.dtype).float()
    return w_new.to(w.dtype), mf.to(m.dtype)


def _check(ws, gs, ms):
    if not (len(ws) == len(gs) == len(ms)) or not ws:
        raise MXNetError("fused_sgd_momentum: needs equal, non-empty lists "
                         "of weights, gradients and momenta, got %d, %d, %d"
                         % (len(ws), len(gs), len(ms)))
    dev, dt = ws[0].device, ws[0].dtype
    for i, (w, g, m) in enumerate(zip(ws, gs, ms)):
        if w.dtype != dt or g.dtype != dt or m.dtype != torch.float32:
            raise MXNetError(
                "fused_sgd_momentum: tensor %d: w and g must share one "
                "dtype across the lists and m must be float32, got w %s, "
                "g %s, m %s" % (i, w.dtype, g.dtype, m.dtype))
        if g.shape != w.shape or m.shape != w.shape:
            raise MXNetError("fused_sgd_momentum: tensor %d: shapes w %s, "
                             "g %s, m %s differ" % (i, tuple(w.shape),
                                                    tuple(g.shape),
                                                    tuple(m.shape)))
        for name, t in (("w", w), ("g", g), ("m", m)):
            if t.device != dev:
                raise MXNetError("fused_sgd_momentum: tensor %d: %s is on "
                                 "%s, not %s" % (i, name, t.device, dev))
            if not t.is_contiguous():
                raise MXNetError("fused_sgd_momentum: tensor %d: %s must "
                                 "be contiguous" % (i, name))


def fused_sgd_momentum(ws, gs, ms, lr, momentum=0.9, wd=0.0, rescale=1.0):
    """Update every w in `ws` and m in `ms` in place from the gradients
    `gs` (lists of tensors of matching shapes). On CUDA tensors this is
    one launch of the kernel for all of them (counted in
    ``fused_sgd_momentum.launches``), or it raises; on CPU tensors it runs
    `sgd_momentum_plain` per tensor."""
    ws, gs, ms = list(ws), list(gs), list(ms)
    _check(ws, gs, ms)
    dev = ws[0].device
    if dev.type == "cpu":
        for w, g, m in zip(ws, gs, ms):
            w_new, m_new = sgd_momentum_plain(w, g, m, lr, momentum, wd,
                                              rescale)
            w.copy_(w_new)
            m.copy_(m_new)
        return
    fn = _kernel()
    rows, nchunks = [], 0
    for w, g, m in zip(ws, gs, ms):
        n = w.numel()
        if n == 0:
            continue
        rows += [w.data_ptr(), g.data_ptr(), m.data_ptr(), n, nchunks]
        nchunks += -(-n // _chunk)
    if not rows:
        return
    # pinned, so the upload is asynchronous: no host wait on the stream
    table = torch.tensor(rows, dtype=torch.int64).pin_memory().to(
        dev, non_blocking=True)
    with torch.cuda.device(dev):
        rc = fn(table.data_ptr(), len(rows) // 5, nchunks,
                _build.dtype_code(ws[0]), float(lr), float(momentum),
                float(wd), float(rescale), _build.stream_of(ws[0]))
    _build.check_launch(rc, "fused_sgd_momentum")
    fused_sgd_momentum.launches += 1


#: kernel launches so far (the plain CPU path does not count)
fused_sgd_momentum.launches = 0
