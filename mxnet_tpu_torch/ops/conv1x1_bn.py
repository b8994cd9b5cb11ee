"""1x1 convolution with the BatchNorm batch statistics in its epilogue: a
hand-written CUDA kernel, its plain PyTorch version, and the
`torch.autograd.Function` that trains through it.

Replaces mxnet_tpu/ops/pallas_kernels.py `conv1x1_bn_stats` (:296, body
`_conv1x1_bn_kernel` :277). The kernels are in
``csrc/conv1x1_bn_stats.cu``; its source note says what bounds them on
the H100, how the design answers that, and why the statistics are reduced
in a second, fixed-order pass where the TPU kernel accumulated across
grid steps. bf16 runs a wgmma GEMM fed by TMA where TMA takes the shape
(Cin and Cout multiples of 8, 16-byte aligned x and w), else a WMMA
kernel; fp32 runs a CUDA-core kernel.

For x (M, Cin), contiguous, and w (Cin, Cout), row-major or the transpose
of a row-major (Cout, Cin) (a conv weight as it lies), the function is::

    y    = x @ w                    fp32 accumulation, y in x's dtype
    mean = mean_rows(y)             fp32, from the fp32 product
    var  = max(mean_rows(y^2) - mean^2, 0)

the single-pass statistics of mxnet_tpu/ops/nn.py's training BatchNorm
(:489-493). In bf16 the statistics come from the fp32 accumulator, where
the JAX BatchNorm takes them from the bf16-rounded conv output.

Its gradient is plain PyTorch on every device, since these are the large
products that XLA computes for JAX's backward too::

    dy_eff = dy + dmean / M + dvar * 2 (y - mean) / M
    dx = dy_eff @ w.T        dw = x.T @ dy_eff
"""
from __future__ import annotations

import ctypes

import torch

from ..base import MXNetError
from . import _build

__all__ = ["conv1x1_bn_stats", "conv1x1_bn_stats_plain", "Conv1x1BNStats",
           "conv1x1_bn_nhwc"]

_fn = None
_rows = None
# mxtpu_conv1x1_bn_partial_rows by (M, N, path, device)
_partial_rows = {}

# kernel paths of the C entry point
_SIMT, _WMMA, _WGMMA = 0, 1, 2


def _kernel():
    global _fn, _rows
    if _fn is None:
        lib = _build.load("conv1x1_bn_stats")
        fn = lib.mxtpu_conv1x1_bn_stats
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_longlong] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        rows = lib.mxtpu_conv1x1_bn_partial_rows
        rows.argtypes = [ctypes.c_int] * 4
        rows.restype = ctypes.c_int
        _rows = rows
        _fn = fn
    return _fn


def conv1x1_bn_stats_plain(x, w):
    """The kernel's function in plain PyTorch (the CPU path and the
    reference the kernel is held against). Returns (y, mean, var)."""
    y = x.float() @ w.float()
    mean = y.mean(dim=0)
    var = torch.clamp((y * y).mean(dim=0) - mean * mean, min=0.0)
    return y.to(x.dtype), mean, var


def conv1x1_bn_stats(x, w):
    """(y, mean, var) of x (M, Cin) @ w (Cin, Cout). On CUDA tensors this
    launches the kernel (counted in ``conv1x1_bn_stats.launches``) or
    raises; on CPU tensors it runs `conv1x1_bn_stats_plain`. No
    gradient: `Conv1x1BNStats` is the differentiable form."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise MXNetError("conv1x1_bn_stats: needs x (M, Cin) and w (Cin, "
                         "Cout), got %s and %s" % (tuple(x.shape),
                                                   tuple(w.shape)))
    if x.dtype != w.dtype or w.device != x.device:
        raise MXNetError("conv1x1_bn_stats: x and w must share dtype and "
                         "device, got %s on %s and %s on %s"
                         % (x.dtype, x.device, w.dtype, w.device))
    if x.device.type == "cpu":
        return conv1x1_bn_stats_plain(x, w)
    if not x.is_contiguous():
        raise MXNetError("conv1x1_bn_stats: x must be contiguous")
    M, K = x.shape
    N = w.shape[1]
    if w.is_contiguous():
        sk, sn = N, 1
    else:
        sk, sn = w.stride()
    if (sk, sn) != (N, 1) and (sk, sn) != (1, K):
        raise MXNetError("conv1x1_bn_stats: w must be row-major (Cin, Cout) "
                         "or the transpose of a row-major (Cout, Cin), got "
                         "strides %s" % (w.stride(),))
    if min(M, K, N) < 1 or max(M, K, N) >= 2 ** 31:
        raise MXNetError("conv1x1_bn_stats: cannot take x %s, w %s"
                         % (tuple(x.shape), tuple(w.shape)))
    fn = _kernel()
    if _build.dtype_code(x) == 0:
        path = _SIMT
    elif K % 8 == 0 and N % 8 == 0 and x.data_ptr() % 16 == 0 \
            and w.data_ptr() % 16 == 0:
        path = _WGMMA       # the main path: TMA takes these
    else:
        path = _WMMA
    device = x.device
    dev = device.index
    key = (M, N, path, dev)
    rows = _partial_rows.get(key)
    if rows is None:
        rows = _partial_rows[key] = _rows(M, N, path, dev)
    if rows < 1:
        raise MXNetError("conv1x1_bn_stats: no partials layout for M %d, "
                         "N %d on device %d" % (M, N, dev))
    y = torch.empty((M, N), dtype=x.dtype, device=device)
    part = torch.empty((2, rows, N), dtype=torch.float64, device=device)
    stats = torch.empty((2, N), dtype=torch.float32, device=device)
    mean, var = stats
    ptr = stats.data_ptr()
    rc = fn(x.data_ptr(), w.data_ptr(), y.data_ptr(), part.data_ptr(), ptr,
            ptr + 4 * N, M, K, N, sk, sn, path, dev,
            _build.stream_of(x))
    _build.check_launch(rc, "conv1x1_bn_stats")
    conv1x1_bn_stats.launches += 1
    return y, mean, var


#: kernel launches so far (the plain CPU path does not count)
conv1x1_bn_stats.launches = 0


class Conv1x1BNStats(torch.autograd.Function):
    """Differentiable `conv1x1_bn_stats`: the forward runs the kernel on
    CUDA (the plain version on the CPU), the backward is plain PyTorch."""

    @staticmethod
    def forward(ctx, x, w):
        y, mean, var = conv1x1_bn_stats(x, w)
        ctx.save_for_backward(x, w, y, mean)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x, w, y, mean = ctx.saved_tensors
        M = x.shape[0]
        g = dy.float() + dmean / M + (2.0 / M) * dvar * (y.float() - mean)
        g = g.to(x.dtype)
        return g @ w.t(), x.t() @ g


#: the dtypes the kernel takes
STATS_DTYPES = (torch.float32, torch.bfloat16)


def fuses_bn_stats(kernel, stride, pad, dilate, groups, layout, bn_axis,
                   dtype=None):
    """Whether a convolution and the training-mode BatchNorm over its
    output run as `conv1x1_bn_nhwc`: a 1x1 NHWC convolution without
    padding, dilation or groups, of equal strides, normalised over its
    channel axis, on one of `STATS_DTYPES` (others run the two layers
    apart on every device). The one rule of `Conv2D.fuses_bn_stats` and
    of the graph's rewrite, which passes no `dtype` when it plans and
    tests it against `STATS_DTYPES` when it runs."""
    return ((dtype is None or dtype in STATS_DTYPES)
            and tuple(kernel) == (1, 1) and layout == "NHWC"
            and tuple(pad) == (0, 0) and tuple(dilate) == (1, 1)
            and groups == 1 and stride[0] == stride[1]
            and bn_axis % 4 == 3)


def conv1x1_bn_nhwc(x, weight, bias=None, stride=1):
    """A 1x1 convolution of NHWC x with weight (Cout, Cin, 1, 1) (and
    bias), and the batch statistics of its output, through
    `Conv1x1BNStats`. Stride 2 subsamples x first, which is a copy. The
    bias joins after the kernel, in y's dtype: y + b, mean + b, var as
    is. Returns (y (N, H', W', Cout), mean, var)."""
    if stride != 1:
        x = x[:, ::stride, ::stride, :]
    n, h, w_, cin = x.shape
    cout = weight.shape[0]
    w2 = weight.reshape(cout, cin).t()   # a view: the kernel reads it as is
    y, mean, var = Conv1x1BNStats.apply(
        x.contiguous().view(n * h * w_, cin), w2)
    y = y.view(n, h, w_, cout)
    if bias is not None:
        y = y + bias.to(y.dtype)
        mean = mean + bias.float()
    return y, mean, var
