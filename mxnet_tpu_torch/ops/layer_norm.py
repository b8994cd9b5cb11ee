"""LayerNorm over the last axis: a hand-written CUDA kernel and its plain
PyTorch version.

Replaces mxnet_tpu/ops/pallas_kernels.py `pallas_layer_norm` (:173, body
`_ln_kernel` :163). The kernel is ``csrc/layer_norm.cu``; its source note
says what bounds it on the H100 (device memory, and launch latency at the
decode shapes) and how its design answers that: one read of each row
into registers with 16-byte loads, and a launch path without a device
context or a stream object.

`layer_norm` launches the kernel for a CUDA tensor and takes the plain
version only for a tensor on the CPU. Numerics of both: fp32 mean, then
the mean of the centred square (two passes), ``rsqrt(var + eps)``, the
affine in fp32, one cast back to x's dtype.
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from . import _build

__all__ = ["layer_norm", "layer_norm_plain"]

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        fn = _build.load("layer_norm").mxtpu_layer_norm
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def layer_norm_plain(x, gamma, beta, eps=1e-5):
    """The kernel's function in plain PyTorch (the CPU path and the
    reference the kernel is held against)."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def layer_norm(x, gamma, beta, eps=1e-5):
    """LayerNorm of x (..., D) with gamma, beta (D,). On a CUDA tensor this
    launches the kernel (and counts it in ``layer_norm.launches``) or
    raises; on a CPU tensor it runs `layer_norm_plain`. The launch path is
    kept short: most calls are decode steps, where it is all the time
    there is."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, gamma, beta, eps)
    D = x.shape[-1]
    dev, dt = x.device, x.dtype
    # one test on the path every call takes; the messages only on failure
    if not (gamma.shape == beta.shape == (D,) and
            gamma.dtype == beta.dtype == dt and
            gamma.device == beta.device == dev and gamma.is_contiguous()
            and beta.is_contiguous()):
        for name, t in (("gamma", gamma), ("beta", beta)):
            if t.device != dev or t.dtype != dt or t.shape != (D,) or \
                    not t.is_contiguous():
                raise MXNetError(
                    "layer_norm: %s must be a contiguous (%d,) %s tensor on "
                    "%s, got %s %s on %s" % (name, D, dt, dev,
                                             tuple(t.shape), t.dtype,
                                             t.device))
    if not x.is_contiguous():
        raise MXNetError("layer_norm: x must be contiguous")
    rows = x.numel() // D if D else 0
    if rows < 1 or rows >= 2 ** 31 or D < 1:
        raise MXNetError("layer_norm: cannot take x of shape %s"
                         % (tuple(x.shape),))
    fn = _kernel()
    out = torch.empty_like(x)
    rc = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
            rows, D, _build.dtype_code(x), eps, dev.index,
            _build.stream_of(x))
    _build.check_launch(rc, "layer_norm")
    layer_norm.launches += 1
    return out


#: kernel launches so far (the plain CPU path does not count)
layer_norm.launches = 0
