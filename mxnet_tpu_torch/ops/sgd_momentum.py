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

The same kernel has MXNet's form, ``SGDMomentumPlan(..., form="mxnet")``
and its plain version `sgd_mxnet_plain`: the update of Gluon's SGD
(mxnet_tpu/optimizer.py `_prep` :226, `_sgd_math` :241), with
multi-precision (an fp32 master and velocity beside a bf16 weight, which
the same pass writes), gradient clipping, no state at momentum 0, and a
device flag that vetoes a launch (the numerics guard's verdict). The two
forms differ once lr changes: MXNet's velocity carries the old lr's
steps, the m-form's momentum does not.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from . import _build

__all__ = ["SGDMomentumPlan", "cached_mxnet_plan", "fused_sgd_momentum",
           "sgd_momentum_plain", "sgd_mxnet_plain"]

_fn = None
_fn_mxnet = None
_chunk = None
_cap = None


def _kernel():
    global _fn, _fn_mxnet, _chunk, _cap
    if _fn is None:
        lib = _build.load("sgd_momentum")
        fn = lib.mxtpu_sgd_momentum
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int] + [
                           ctypes.c_float] * 4 + [ctypes.c_void_p,
                                                  ctypes.c_int,
                                                  ctypes.c_void_p]
        fn.restype = ctypes.c_int
        mx = lib.mxtpu_sgd_mxnet
        mx.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int] + [
                           ctypes.c_float] * 5 + [
                           ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_void_p]
        mx.restype = ctypes.c_int
        lib.mxtpu_sgd_momentum_chunk.restype = ctypes.c_longlong
        _chunk = int(lib.mxtpu_sgd_momentum_chunk())
        _cap = int(lib.mxtpu_sgd_momentum_max_tensors())
        _fn_mxnet = mx
        _fn = fn
    return _fn


def sgd_momentum_plain(w, g, m, lr, momentum=0.9, wd=0.0, rescale=1.0):
    """The kernel's function on one tensor in plain PyTorch (the CPU path
    and the reference the kernel is held against). Returns (w', m')."""
    wf = w.float()
    mf = momentum * m.float() + (g.float() * rescale + wd * wf)
    w_new = wf - lr * mf.to(w.dtype).float()
    return w_new.to(w.dtype), mf.to(m.dtype)


def sgd_mxnet_plain(w, g, v, lr, momentum=0.0, wd=0.0, rescale=1.0,
                    clip=None):
    """MXNet's form on one tensor in plain PyTorch (the CPU path and the
    reference the kernel is held against): fp32 arithmetic, each product
    and sum rounded on its own, in `_prep`'s and `_sgd_math`'s order.
    `w` is the weight, or the fp32 master in multi-precision; `v` the
    velocity, or None at momentum 0. Returns (w', v') in w's and v's
    dtypes (v' None without v); a multi-precision caller writes
    w'.to(weight dtype) too."""
    wf = w.float()
    r = g.float() * rescale
    if clip is not None and clip >= 0:   # MXNet: a negative clip is none
        r = torch.clamp(r, -clip, clip)
    if wd:
        r = r + wd * wf
    if momentum and v is not None:
        vf = momentum * v.float() - lr * r
        return (wf + vf).to(w.dtype), vf.to(v.dtype)
    return (wf - lr * r).to(w.dtype), None


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


def _check_mxnet_state(ws, ms, lows):
    """MXNet's form: w of one float dtype (fp32 or bf16 on the card),
    v (None: no momentum) of w's dtype; with `lows` (multi-precision), w
    and v fp32 and the weights of one dtype. All of one shape per
    tensor, contiguous, on one device."""
    if not ws:
        raise MXNetError("fused_sgd_momentum: needs a non-empty weight list")
    for name, other in (("velocities", ms), ("weights", lows)):
        if other is not None and len(other) != len(ws):
            raise MXNetError("fused_sgd_momentum: %d tensors but %d %s"
                             % (len(ws), len(other), name))
    dev, dt = ws[0].device, ws[0].dtype
    low_dt = lows[0].dtype if lows is not None else None
    if lows is not None and dt != torch.float32:
        raise MXNetError("fused_sgd_momentum: multi-precision needs fp32 "
                         "masters, got %s" % dt)
    for i, w in enumerate(ws):
        group = [("w", w)]
        if ms is not None:
            group.append(("v", ms[i]))
        if lows is not None:
            group.append(("weight", lows[i]))
        for name, t in group:
            want = low_dt if name == "weight" else dt
            if t.dtype != want or t.shape != w.shape or t.device != dev \
                    or not t.is_contiguous():
                raise MXNetError(
                    "fused_sgd_momentum: tensor %d: %s must be a contiguous "
                    "%s tensor of shape %s on %s, got %s %s on %s "
                    "(contiguous: %s)" % (i, name, want, tuple(w.shape), dev,
                                          t.dtype, tuple(t.shape), t.device,
                                          t.is_contiguous()))


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

    ``form="mxnet"`` is MXNet's update (`sgd_mxnet_plain` on the CPU):
    `ms` are the velocities (None: momentum 0, no state), of w's dtype;
    `weights`, for multi-precision, the low-precision weights that `ws`
    (fp32 masters, with fp32 `ms`) are the masters of, written in the same
    launch. Its call takes ``clip`` (None: no clipping).

    A call of either form takes ``ok``, a 0-d bool tensor on the plan's
    device: when it is false, nothing is written (on the card the launch
    reads it; no host read, so a CUDA graph can capture the call).
    """

    def __init__(self, ws, ms, form="m", weights=None):
        if form not in ("m", "mxnet"):
            raise MXNetError("fused_sgd_momentum: form must be 'm' or "
                             "'mxnet', got %r" % (form,))
        ws = list(ws)
        ms = None if ms is None else list(ms)
        lows = None if weights is None else list(weights)
        if form == "m":
            if lows is not None:
                raise MXNetError("fused_sgd_momentum: the m-form has no "
                                 "multi-precision weights")
            _check_state(ws, ms or [])
        else:
            _check_mxnet_state(ws, ms, lows)
        self._form = form
        self._ws, self._ms, self._lows = ws, ms, lows
        self._dev = ws[0].device
        # the gradients' dtype: the weights', or the low-precision weights'
        self._dtype = (lows or ws)[0].dtype
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
                rows += [ws[i].data_ptr(),
                         ms[i].data_ptr() if ms is not None else 0, n,
                         nchunks,
                         lows[i].data_ptr() if lows is not None else 0]
                nchunks += -(-n // _chunk)
            # a blocking copy: every later launch, on whatever stream is
            # current then, finds the table in place
            table = torch.tensor(rows, dtype=torch.int64).to(self._dev)
            self._launches.append((table, idx, nchunks,
                                   (ctypes.c_void_p * len(idx))()))

    def __call__(self, gs, lr, momentum=0.9, wd=0.0, rescale=1.0, clip=None,
                 ok=None):
        if len(gs) != len(self._ws):
            raise MXNetError("fused_sgd_momentum: the plan has %d tensors, "
                             "got %d gradients" % (len(self._ws), len(gs)))
        dt, di = self._dtype, self._dev_index
        for g, shape in zip(gs, self._shapes):
            if g.shape != shape or g.dtype != dt or g.get_device() != di \
                    or not g.is_contiguous():
                _check_grads(gs, self._shapes, dt, self._dev)
        mxnet = self._form == "mxnet"
        if not mxnet and clip is not None:
            raise MXNetError("fused_sgd_momentum: clip is MXNet's form's")
        if mxnet and momentum and self._ms is None:
            raise MXNetError("fused_sgd_momentum: momentum %g needs the "
                             "velocities the plan was built without"
                             % momentum)
        if ok is not None and (ok.dtype != torch.bool or ok.numel() != 1
                               or ok.get_device() != di):
            raise MXNetError("fused_sgd_momentum: ok must be a one-element "
                             "bool tensor on %s" % self._dev)
        if di < 0:
            self._plain(gs, lr, momentum, wd, rescale, clip, ok)
            return
        code = _build.dtype_code(gs[0])
        stream = _build.stream_of(self._ws[0])
        for table, idx, nchunks, ptrs in self._launches:
            ptrs[:] = [gs[i].data_ptr() for i in idx]
            if mxnet:
                rc = _fn_mxnet(
                    table.data_ptr(), ptrs, len(idx), nchunks, code,
                    int(self._lows is not None), float(lr), float(momentum),
                    float(wd), float(rescale),
                    -1.0 if clip is None else float(clip),
                    int(bool(momentum)),
                    None if ok is None else ok.data_ptr(), di, stream)
            else:
                rc = _fn(table.data_ptr(), ptrs, len(idx), nchunks, code,
                         float(lr), float(momentum), float(wd),
                         float(rescale), None if ok is None else
                         ok.data_ptr(), di, stream)
            _build.check_launch(rc, "fused_sgd_momentum")
            fused_sgd_momentum.launches += 1

    def _plain(self, gs, lr, momentum, wd, rescale, clip, ok):
        """The CPU path: the plain version per tensor, in place."""
        if ok is not None and not bool(ok):
            return
        if self._form == "m":
            for w, g, m in zip(self._ws, gs, self._ms):
                w_new, m_new = sgd_momentum_plain(w, g, m, lr, momentum, wd,
                                                  rescale)
                w.copy_(w_new)
                m.copy_(m_new)
            return
        for i, (w, g) in enumerate(zip(self._ws, gs)):
            v = self._ms[i] if self._ms is not None else None
            w_new, v_new = sgd_mxnet_plain(w, g, v, lr, momentum, wd,
                                           rescale, clip)
            w.copy_(w_new)
            if v_new is not None:
                v.copy_(v_new)
            if self._lows is not None:
                self._lows[i].copy_(w_new)


def cached_mxnet_plan(cache, key, ws, vs=None, weights=None):
    """The MXNet-form plan over `ws` (velocities `vs`, multi-precision
    `weights`), kept in the dict `cache` under `key` together with the
    pointers of every tensor it writes, and built anew when they differ
    (after a cast, a move to another device, new optimizer states). The
    plan holds aliases of its tensors (their storage, not the tensor
    objects), so no other live tensor can take one of their addresses,
    and a cache keyed weakly by one of the tensors drops the entry with
    it."""
    ptrs = tuple(t.data_ptr() for t in [*ws, *(vs or ()), *(weights or ())])
    held = cache.get(key)
    if held is None or held[0] != ptrs:
        def alias(ts):
            return None if ts is None else [t.detach() for t in ts]
        held = cache[key] = (ptrs, SGDMomentumPlan(
            alias(ws), alias(vs), form="mxnet", weights=alias(weights)))
    return held[1]


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
