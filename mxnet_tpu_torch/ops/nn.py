"""Neural-network operators on tensors (counterpart of mxnet_tpu/ops/nn.py):
Activation, FullyConnected, Convolution, Pooling and BatchNorm, in the
JAX package's layouts and numerics.

Layouts: "NCHW" (the default) or a channels-last "NHWC". Convolution
weights are in PyTorch's (O, I/groups, kh, kw) in both layouts; the JAX
package keeps an NHWC weight as (O, kh, kw, I), and
`convert.resnet_params_from_jax` permutes it. An NHWC input runs as a
channels_last view of NCHW, so no data moves around a convolution.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import MXNetError

__all__ = ["activation", "batch_norm", "bn_axis", "convolution",
           "fully_connected", "is_channels_last", "pooling"]


def is_channels_last(layout):
    """True for NWC/NHWC/NDHWC-family layout strings (ops/nn.py:266)."""
    return layout is not None and layout[1] != "C"


def bn_axis(layout):
    """The channel axis of a layout string: 1 for NCHW, 3 for NHWC."""
    return len(layout) - 1 if is_channels_last(layout) else 1


def activation(x, act_type="relu"):
    """ops/nn.py:34 `Activation`."""
    if act_type == "relu":
        return torch.relu(x)
    if act_type == "sigmoid":
        return torch.sigmoid(x)
    if act_type == "tanh":
        return torch.tanh(x)
    if act_type == "softrelu":
        return F.softplus(x)
    if act_type == "softsign":
        return F.softsign(x)
    if act_type == "gelu":
        return F.gelu(x, approximate="tanh")    # jax.nn.gelu's default
    if act_type in ("silu", "swish"):
        return F.silu(x)
    raise MXNetError("Activation: unknown act_type %r" % act_type)


def fully_connected(x, weight, bias=None, flatten=True):
    """ops/nn.py:250: y = x @ weight.T (+ bias), weight (num_hidden,
    in_units). The bias joins in y's dtype, so fp32 biases do not promote
    a bf16 activation."""
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    y = F.linear(x, weight)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def _pair(v, default):
    if v is None:
        return default
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def _to_nchw(x, layout):
    return x.permute(0, 3, 1, 2) if is_channels_last(layout) else x


def _from_nchw(y, layout):
    return y.permute(0, 2, 3, 1) if is_channels_last(layout) else y


def convolution(x, weight, bias=None, stride=1, pad=0, dilate=1, groups=1,
                layout="NCHW"):
    """ops/nn.py:300: 2-D convolution; the bias joins after, in y's
    dtype."""
    if x.dim() != 4:
        raise MXNetError("Convolution: the port takes 2-D convolutions, "
                         "got input of shape %s" % (tuple(x.shape),))
    y = F.conv2d(_to_nchw(x, layout), weight, None, _pair(stride, (1, 1)),
                 _pair(pad, (0, 0)), _pair(dilate, (1, 1)), groups)
    y = _from_nchw(y, layout)
    if bias is not None:
        shape = [1] * 4
        shape[bn_axis(layout)] = bias.numel()
        y = y + bias.reshape(shape).to(y.dtype)
    return y


def pooling(x, kernel=(), pool_type="max", stride=None, pad=None,
            global_pool=False, pooling_convention="valid",
            count_include_pad=True, layout="NCHW"):
    """ops/nn.py:371: 2-D max/avg pooling and global pooling. Max pooling
    pads with -inf, as `lax.reduce_window` with a -inf init does."""
    axes = (1, 2) if is_channels_last(layout) else (2, 3)
    if global_pool:
        if pool_type == "max":
            return x.amax(dim=axes, keepdim=True)
        if pool_type in ("avg", "sum"):
            r = x.sum(dim=axes, keepdim=True)
            if pool_type == "avg":
                r = r / (x.shape[axes[0]] * x.shape[axes[1]])
            return r
        raise MXNetError("Pooling: unknown pool_type %r" % pool_type)
    if pooling_convention != "valid":
        raise MXNetError("Pooling: the port takes pooling_convention "
                         "'valid' only, got %r" % pooling_convention)
    kernel = _pair(kernel, None)
    stride = _pair(stride, (1, 1))
    pad = _pair(pad, (0, 0))
    xc = _to_nchw(x, layout)
    if pool_type == "max":
        y = F.max_pool2d(xc, kernel, stride, pad)
    elif pool_type == "avg":
        y = F.avg_pool2d(xc, kernel, stride, pad,
                         count_include_pad=count_include_pad)
    else:
        raise MXNetError("Pooling: unknown pool_type %r" % pool_type)
    return _from_nchw(y, layout)


def batch_norm(x, gamma, beta, moving_mean, moving_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False, axis=1,
               training=False, stats=None):
    """ops/nn.py:466 `BatchNorm`. Returns (y, new_moving_mean,
    new_moving_var); the new moving statistics carry no gradient.

    Training (and not `use_global_stats`): single-pass fp32 statistics,
    var = max(E[x^2] - E[x]^2, 0), unless `stats` = (mean, var) hands in
    ones already computed (by `ops.conv1x1_bn_stats` in the producer's
    epilogue). The moving statistics become momentum * old +
    (1 - momentum) * batch (MXNet's momentum: not PyTorch's complement,
    and the biased variance). The scale and shift fold into one
    per-channel pair, computed in fp32 and applied in x's dtype."""
    ax = axis % x.dim()
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if training and not use_global_stats:
        if stats is None:
            red = tuple(i for i in range(x.dim()) if i != ax)
            xf = x.float()
            mean = xf.mean(dim=red)
            var = torch.clamp((xf * xf).mean(dim=red) - mean * mean,
                              min=0.0)
        else:
            mean, var = stats
        with torch.no_grad():
            new_mm = momentum * moving_mean + (1 - momentum) * mean
            new_mv = momentum * moving_var + (1 - momentum) * var
    else:
        mean, var = moving_mean, moving_var
        new_mm, new_mv = moving_mean, moving_var
    shape = [1] * x.dim()
    shape[ax] = x.shape[ax]
    a = g * torch.rsqrt(var + eps)
    b = beta - mean * a
    y = x * a.reshape(shape).to(x.dtype) + b.reshape(shape).to(x.dtype)
    return y, new_mm, new_mv
