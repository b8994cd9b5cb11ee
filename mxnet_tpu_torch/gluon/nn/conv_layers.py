"""Convolution and pooling layers (counterpart of
mxnet_tpu/gluon/nn/conv_layers.py): Conv2D, MaxPool2D, GlobalAvgPool2D,
in NCHW and NHWC."""
from __future__ import annotations

import torch
from torch import nn

from ...base import MXNetError
from ...context import resolve_device
from ...ops import conv1x1_bn_nhwc
from ...ops import nn as _ops
from ..block import HybridBlock

__all__ = ["Conv2D", "GlobalAvgPool2D", "MaxPool2D"]


def _pair(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


class Conv2D(HybridBlock):
    """conv_layers.py:135. The weight is (channels, in_channels / groups,
    kh, kw) in both layouts (see ops/nn.py)."""

    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1, layout="NCHW",
                 use_bias=True, in_channels=0, device=None, prefix=None):
        super().__init__(prefix=prefix)
        if layout not in ("NCHW", "NHWC"):
            raise MXNetError("Conv2D: layout must be NCHW or NHWC, got %r"
                             % (layout,))
        if not in_channels:
            raise MXNetError("Conv2D: the port needs in_channels (no "
                             "deferred shape inference)")
        dev = resolve_device(device)
        self._kernel = _pair(kernel_size)
        self._kwargs = {"stride": _pair(strides), "pad": _pair(padding),
                        "dilate": _pair(dilation), "groups": groups,
                        "layout": layout}
        self.weight = nn.Parameter(torch.zeros(
            (channels, in_channels // groups) + self._kernel, device=dev))
        self.bias = nn.Parameter(torch.zeros(channels, device=dev)) \
            if use_bias else None

    def _alias(self):
        return "conv"

    def _param_spec(self, attr, is_buffer):
        """The weight's fans are those of the JAX layout's shape: an NHWC
        weight is (O, kh, kw, I) there (conv_layers.py), (O, I, kh, kw)
        here."""
        spec = super()._param_spec(attr, is_buffer)
        if attr == "weight" and self._kwargs["layout"] == "NHWC":
            o, i, kh, kw = self.weight.shape
            spec["fan_shape"] = (o, kh, kw, i)
        return spec

    def forward(self, x):
        return _ops.convolution(x, self.weight, self.bias, **self._kwargs)

    def fuses_bn_stats(self, bn):
        """Whether this convolution and the BatchNorm `bn` after it run as
        `forward_with_stats`: a 1x1 NHWC convolution without padding,
        dilation or groups, of equal strides, normalised over its channel
        axis."""
        kw = self._kwargs
        return (self._kernel == (1, 1) and kw["layout"] == "NHWC"
                and kw["pad"] == (0, 0) and kw["dilate"] == (1, 1)
                and kw["groups"] == 1 and kw["stride"][0] == kw["stride"][1]
                and bn._axis % 4 == 3)

    def forward_with_stats(self, x):
        """(y, mean, var): the convolution and its output's batch
        statistics, from `ops.conv1x1_bn_nhwc`."""
        return conv1x1_bn_nhwc(x, self.weight, self.bias,
                               self._kwargs["stride"][0])


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, global_pool, pool_type,
                 layout, prefix=None):
        super().__init__(prefix=prefix)
        if layout not in ("NCHW", "NHWC"):
            raise MXNetError("pooling: layout must be NCHW or NHWC, got %r"
                             % (layout,))
        self._kwargs = {"kernel": pool_size,
                        "stride": pool_size if strides is None else strides,
                        "pad": padding, "global_pool": global_pool,
                        "pool_type": pool_type, "layout": layout}

    def _alias(self):
        return "pool"

    def forward(self, x):
        return _ops.pooling(x, **self._kwargs)


class MaxPool2D(_Pooling):
    """conv_layers.py:272 (ceil_mode=False only)."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", prefix=None):
        super().__init__(pool_size, strides, padding, False, "max", layout,
                         prefix)


class GlobalAvgPool2D(_Pooling):
    """conv_layers.py:369: the mean over H and W, kept as size-1 axes."""

    def __init__(self, layout="NCHW", prefix=None):
        super().__init__((1, 1), None, 0, True, "avg", layout, prefix)
