"""Convolution and pooling layers (counterpart of
mxnet_tpu/gluon/nn/conv_layers.py): Conv1D-3D, Conv1DTranspose-3DTranspose,
MaxPool/AvgPool 1-3D, GlobalMaxPool/GlobalAvgPool 1-3D and
ReflectionPad2D, in the layouts the JAX classes take.

Convolutions are cuDNN's through the registry's `Convolution` and
`Deconvolution` operators (the JAX package wrote no kernel of its own
for them), except the 1x1 NHWC convolution that a BatchNorm follows in
training, which `nn.HybridSequential` runs on the `conv1x1_bn_stats`
kernel (`Conv2D.forward_with_stats`).

Weights: Conv1D, Conv3D and the transposes keep the JAX package's
layouts ((O, I/g, *k) channels-first, (O, *k, I/g) channels-last,
(I, O/g, *k) transposed). Conv2D keeps PyTorch's (O, I/g, kh, kw) in
both layouts, which the conv1x1 kernel reads as a transposed view; its
NHWC weight is (O, kh, kw, I/g) in a file and in the initializer's fans.
"""
from __future__ import annotations

import torch

from ...base import MXNetError
from ...ops import conv1x1_bn_nhwc
from ...ops import nn as _ops
from ...ops import registry as _registry
from ..block import HybridBlock
from .activations import Activation

__all__ = ["AvgPool1D", "AvgPool2D", "AvgPool3D", "Conv1D",
           "Conv1DTranspose", "Conv2D", "Conv2DTranspose", "Conv3D",
           "Conv3DTranspose", "GlobalAvgPool1D", "GlobalAvgPool2D",
           "GlobalAvgPool3D", "GlobalMaxPool1D", "GlobalMaxPool2D",
           "GlobalMaxPool3D", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "ReflectionPad2D"]


def _to_tuple(x, n):
    if isinstance(x, (list, tuple)):
        assert len(x) == n
        return tuple(x)
    return (x,) * n


def _check_layout(layout, allowed):
    if layout not in allowed:
        raise MXNetError("layout must be one of %s, got %r"
                         % (", ".join(allowed), layout))


class _Conv(HybridBlock):
    """conv_layers.py:35: the N-D convolution (`op_name` "Convolution")
    or transposed convolution ("Deconvolution"), with an optional
    activation after it."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution", adj=None,
                 device=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        nd = len(kernel_size)
        self._channels = channels
        self._groups = groups
        self._layout = layout
        self._op_name = op_name
        self._kwargs = {
            "kernel": tuple(kernel_size), "stride": _to_tuple(strides, nd),
            "dilate": _to_tuple(dilation, nd), "pad": _to_tuple(padding, nd),
            "num_filter": channels, "num_group": groups,
            "no_bias": not use_bias, "layout": layout}
        if adj is not None:
            self._kwargs["adj"] = adj
        with self.name_scope():
            self._new_param("weight", self._weight_shape(in_channels),
                            init=weight_initializer, device=device)
            self._set_fans()
            if use_bias:
                self._new_param("bias", (channels,), init=bias_initializer,
                                device=device)
            else:
                self.bias = None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def _alias(self):
        return "conv"

    def _channels_last(self):
        return _ops.is_channels_last(self._layout)

    def _weight_shape(self, in_channels):
        k = self._kwargs["kernel"]
        if self._op_name == "Deconvolution":
            return (in_channels, self._channels // self._groups) + k
        cin = in_channels // self._groups
        if self._channels_last():
            return (self._channels,) + k + (cin,)
        return (self._channels, cin) + k

    def _set_fans(self):
        pass

    def _infer_shapes(self, x):
        axis = x.dim() - 1 if self._channels_last() else 1
        return {"weight": self._weight_shape(x.shape[axis])}

    def _conv(self, x):
        op = _registry.get(self._op_name).fn
        if self.bias is None:
            return op(x, self.weight, **self._kwargs)
        return op(x, self.weight, self.bias, **self._kwargs)

    def forward(self, x):
        self._ensure_params(x)
        y = self._conv(x)
        return self.act(y) if self.act is not None else y


class Conv1D(_Conv):
    """conv_layers.py:137 (NCW)."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 dilation=1, groups=1, layout="NCW", activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        _check_layout(layout, ("NCW",))
        super().__init__(channels, _to_tuple(kernel_size, 1), strides,
                         padding, dilation, groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)


class Conv2D(_Conv):
    """conv_layers.py:220, NCHW or NHWC. The weight is (channels,
    in_channels / groups, kh, kw) in both layouts."""

    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), dilation=(1, 1), groups=1, layout="NCHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        _check_layout(layout, ("NCHW", "NHWC"))
        super().__init__(channels, _to_tuple(kernel_size, 2), strides,
                         padding, dilation, groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)
        if self._channels_last():
            self._attr_params["weight"]._file_perm = (0, 2, 3, 1)

    def _weight_shape(self, in_channels):
        return (self._channels, in_channels // self._groups) + \
            self._kwargs["kernel"]

    def _set_fans(self):
        """The fans of an NHWC weight are those of the JAX layout's shape,
        (O, kh, kw, I)."""
        p = self._attr_params["weight"]
        if self._channels_last() and all(p._shape):
            o, i, kh, kw = p._shape
            p._fan_shape = (o, kh, kw, i)

    def _ensure_params(self, *args):
        if not self._params_ready and self.weight is None:
            self._attr_params["weight"].shape = \
                self._infer_shapes(*args)["weight"]
            self._set_fans()
        super()._ensure_params(*args)

    def _conv(self, x):
        kw = self._kwargs
        return _ops.convolution(x, self.weight, self.bias, kw["stride"],
                                kw["pad"], kw["dilate"], self._groups,
                                self._layout)

    def fuses_bn_stats(self, bn, x):
        """Whether this convolution and the BatchNorm `bn` after it run as
        `forward_with_stats` on input `x`: a 1x1 NHWC convolution without
        padding, dilation, groups or activation, of equal strides,
        normalised over its channel axis, on float32 or bfloat16 (the
        kernel's dtypes; others run the two layers apart on every
        device)."""
        kw = self._kwargs
        return (x.dtype in (torch.float32, torch.bfloat16)
                and kw["kernel"] == (1, 1) and self._layout == "NHWC"
                and kw["pad"] == (0, 0) and kw["dilate"] == (1, 1)
                and self._groups == 1 and kw["stride"][0] == kw["stride"][1]
                and self.act is None and bn._axis % 4 == 3)

    def forward_with_stats(self, x):
        """(y, mean, var): the convolution and its output's batch
        statistics, from `ops.conv1x1_bn_nhwc`."""
        self._ensure_params(x)
        return conv1x1_bn_nhwc(x, self.weight, self.bias,
                               self._kwargs["stride"][0])


class Conv3D(_Conv):
    """conv_layers.py:306, NCDHW or NDHWC."""

    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), dilation=(1, 1, 1), groups=1,
                 layout="NCDHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        _check_layout(layout, ("NCDHW", "NDHWC"))
        super().__init__(channels, _to_tuple(kernel_size, 3), strides,
                         padding, dilation, groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, **kwargs)


class _ConvTranspose(_Conv):
    def __init__(self, nd, layout, channels, kernel_size, strides, padding,
                 output_padding, dilation, groups, activation, use_bias,
                 weight_initializer, bias_initializer, in_channels,
                 **kwargs):
        _check_layout(layout, ({1: "NCW", 2: "NCHW", 3: "NCDHW"}[nd],))
        self.outpad = _to_tuple(output_padding, nd)
        super().__init__(channels, _to_tuple(kernel_size, nd), strides,
                         padding, dilation, groups, layout, in_channels,
                         activation, use_bias, weight_initializer,
                         bias_initializer, op_name="Deconvolution",
                         adj=self.outpad, **kwargs)


class Conv1DTranspose(_ConvTranspose):
    """conv_layers.py:394 (NCW)."""

    def __init__(self, channels, kernel_size, strides=1, padding=0,
                 output_padding=0, dilation=1, groups=1, layout="NCW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(1, layout, channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, activation,
                         use_bias, weight_initializer, bias_initializer,
                         in_channels, **kwargs)


class Conv2DTranspose(_ConvTranspose):
    """conv_layers.py:482 (NCHW)."""

    def __init__(self, channels, kernel_size, strides=(1, 1),
                 padding=(0, 0), output_padding=(0, 0), dilation=(1, 1),
                 groups=1, layout="NCHW", activation=None, use_bias=True,
                 weight_initializer=None, bias_initializer="zeros",
                 in_channels=0, **kwargs):
        super().__init__(2, layout, channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, activation,
                         use_bias, weight_initializer, bias_initializer,
                         in_channels, **kwargs)


class Conv3DTranspose(_ConvTranspose):
    """conv_layers.py:575 (NCDHW)."""

    def __init__(self, channels, kernel_size, strides=(1, 1, 1),
                 padding=(0, 0, 0), output_padding=(0, 0, 0),
                 dilation=(1, 1, 1), groups=1, layout="NCDHW",
                 activation=None, use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", in_channels=0, **kwargs):
        super().__init__(3, layout, channels, kernel_size, strides, padding,
                         output_padding, dilation, groups, activation,
                         use_bias, weight_initializer, bias_initializer,
                         in_channels, **kwargs)


class _Pooling(HybridBlock):
    """conv_layers.py:669: the registry's `Pooling` operator; 2-D
    pooling without ceil mode takes `ops.nn.pooling` (PyTorch's pooling
    with its own padding)."""

    def __init__(self, pool_size, strides, padding, ceil_mode=False,
                 global_pool=False, pool_type="max", count_include_pad=None,
                 layout=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        nd = len(pool_size)
        if strides is None:
            strides = pool_size
        self._kwargs = {
            "kernel": tuple(pool_size), "stride": _to_tuple(strides, nd),
            "pad": _to_tuple(padding, nd), "global_pool": global_pool,
            "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid",
            "layout": layout}
        if count_include_pad is not None:
            self._kwargs["count_include_pad"] = count_include_pad
        self._fast = nd == 2 and not ceil_mode

    def _alias(self):
        return "pool"

    def forward(self, x):
        if self._fast:
            return _ops.pooling(x, **self._kwargs)
        return _registry.get("Pooling").fn(x, **self._kwargs)


class MaxPool1D(_Pooling):
    """conv_layers.py:703 (NCW)."""

    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, **kwargs):
        _check_layout(layout, ("NCW",))
        super().__init__(_to_tuple(pool_size, 1), strides, padding,
                         ceil_mode, False, "max", layout=layout, **kwargs)


class MaxPool2D(_Pooling):
    """conv_layers.py:746 (NCHW or NHWC)."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 layout="NCHW", ceil_mode=False, **kwargs):
        _check_layout(layout, ("NCHW", "NHWC"))
        super().__init__(_to_tuple(pool_size, 2), strides, padding,
                         ceil_mode, False, "max", layout=layout, **kwargs)


class MaxPool3D(_Pooling):
    """conv_layers.py:793 (NCDHW or NDHWC)."""

    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 ceil_mode=False, layout="NCDHW", **kwargs):
        _check_layout(layout, ("NCDHW", "NDHWC"))
        super().__init__(_to_tuple(pool_size, 3), strides, padding,
                         ceil_mode, False, "max", layout=layout, **kwargs)


class AvgPool1D(_Pooling):
    """conv_layers.py:842 (NCW)."""

    def __init__(self, pool_size=2, strides=None, padding=0, layout="NCW",
                 ceil_mode=False, count_include_pad=True, **kwargs):
        _check_layout(layout, ("NCW",))
        super().__init__(_to_tuple(pool_size, 1), strides, padding,
                         ceil_mode, False, "avg", count_include_pad,
                         layout=layout, **kwargs)


class AvgPool2D(_Pooling):
    """conv_layers.py:887 (NCHW or NHWC)."""

    def __init__(self, pool_size=(2, 2), strides=None, padding=0,
                 ceil_mode=False, layout="NCHW", count_include_pad=True,
                 **kwargs):
        _check_layout(layout, ("NCHW", "NHWC"))
        super().__init__(_to_tuple(pool_size, 2), strides, padding,
                         ceil_mode, False, "avg", count_include_pad,
                         layout=layout, **kwargs)


class AvgPool3D(_Pooling):
    """conv_layers.py:937 (NCDHW or NDHWC)."""

    def __init__(self, pool_size=(2, 2, 2), strides=None, padding=0,
                 ceil_mode=False, layout="NCDHW", count_include_pad=True,
                 **kwargs):
        _check_layout(layout, ("NCDHW", "NDHWC"))
        super().__init__(_to_tuple(pool_size, 3), strides, padding,
                         ceil_mode, False, "avg", count_include_pad,
                         layout=layout, **kwargs)


class _GlobalPooling(_Pooling):
    """The max or mean over every spatial axis, kept as size-1 axes."""

    _nd = 2
    _type = "max"
    _layouts = ()

    def __init__(self, layout=None, **kwargs):
        layout = layout or self._layouts[0]
        _check_layout(layout, self._layouts)
        super().__init__((1,) * self._nd, None, 0, True, True, self._type,
                         layout=layout, **kwargs)


class GlobalMaxPool1D(_GlobalPooling):
    """conv_layers.py:990 (NCW)."""
    _nd, _type, _layouts = 1, "max", ("NCW",)


class GlobalMaxPool2D(_GlobalPooling):
    """conv_layers.py:1009 (NCHW or NHWC)."""
    _nd, _type, _layouts = 2, "max", ("NCHW", "NHWC")


class GlobalMaxPool3D(_GlobalPooling):
    """conv_layers.py:1029 (NCDHW or NDHWC)."""
    _nd, _type, _layouts = 3, "max", ("NCDHW", "NDHWC")


class GlobalAvgPool1D(_GlobalPooling):
    """conv_layers.py:1049 (NCW)."""
    _nd, _type, _layouts = 1, "avg", ("NCW",)


class GlobalAvgPool2D(_GlobalPooling):
    """conv_layers.py:1065 (NCHW or NHWC)."""
    _nd, _type, _layouts = 2, "avg", ("NCHW", "NHWC")


class GlobalAvgPool3D(_GlobalPooling):
    """conv_layers.py:1082 (NCDHW or NDHWC)."""
    _nd, _type, _layouts = 3, "avg", ("NCDHW", "NDHWC")


class ReflectionPad2D(HybridBlock):
    """conv_layers.py:1098: pads H and W of an NCHW input with their
    reflection; `padding` an int or the `Pad` operator's 8-tuple."""

    def __init__(self, padding=0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0, padding, padding, padding, padding)
        assert len(padding) == 8
        self._padding = tuple(padding)

    def forward(self, x):
        return _registry.get("Pad").fn(x, mode="reflect",
                                       pad_width=self._padding)
