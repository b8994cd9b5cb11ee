"""MobileNet V1 and V2 (counterpart of
mxnet_tpu/gluon/model_zoo/vision/mobilenet.py): MobileNet, MobileNetV2,
mobilenet1_0 ... mobilenet0_25, mobilenet_v2_1_0 ... mobilenet_v2_0_25.

Every layer takes its input channels from the first forward (deferred
initialization), as in the JAX package. Pass ``layout="NHWC"`` for the
channels-last net and feed (N, H, W, C) data: in training mode (under
`autograd.record()`) each 1x1 convolution that a BatchNorm follows runs
through the `conv1x1_bn_stats` kernel (see `nn.HybridSequential`), the
13 pointwise convolutions of a MobileNet V1 forward and the 1x1
expansions and projections of V2; depthwise convolutions are cuDNN's
grouped convolutions.
"""
from __future__ import annotations

import torch

from ....ops import nn as _ops
from ... import nn
from ...block import HybridBlock
from ..model_store import load_pretrained

__all__ = ["MobileNet", "MobileNetV2", "get_mobilenet", "get_mobilenet_v2",
           "mobilenet0_25", "mobilenet0_5", "mobilenet0_75", "mobilenet1_0",
           "mobilenet_v2_0_25", "mobilenet_v2_0_5", "mobilenet_v2_0_75",
           "mobilenet_v2_1_0"]


class RELU6(HybridBlock):
    """mobilenet.py:37: clip(x, 0, 6)."""

    def forward(self, x):
        return torch.clamp(x, 0.0, 6.0)


def _add_conv(out, channels=1, kernel=1, stride=1, pad=0, num_group=1,
              active=True, relu6=False, layout="NCHW"):
    out.add(nn.Conv2D(channels, kernel, stride, pad, groups=num_group,
                      use_bias=False, layout=layout))
    out.add(nn.BatchNorm(scale=True, axis=_ops.bn_axis(layout)))
    if active:
        out.add(RELU6() if relu6 else nn.Activation("relu"))


def _add_conv_dw(out, dw_channels, channels, stride, relu6=False,
                 layout="NCHW"):
    _add_conv(out, channels=dw_channels, kernel=3, stride=stride, pad=1,
              num_group=dw_channels, relu6=relu6, layout=layout)
    _add_conv(out, channels=channels, relu6=relu6, layout=layout)


class LinearBottleneck(HybridBlock):
    """mobilenet.py:82: MobileNetV2's inverted residual block."""

    def __init__(self, in_channels, channels, t, stride, layout="NCHW",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.use_shortcut = stride == 1 and in_channels == channels
        with self.name_scope():
            self.out = nn.HybridSequential()
            _add_conv(self.out, in_channels * t, relu6=True, layout=layout)
            _add_conv(self.out, in_channels * t, kernel=3, stride=stride,
                      pad=1, num_group=in_channels * t, relu6=True,
                      layout=layout)
            _add_conv(self.out, channels, active=False, relu6=True,
                      layout=layout)

    def forward(self, x):
        out = self.out(x)
        return out + x if self.use_shortcut else out


class MobileNet(HybridBlock):
    """mobilenet.py:126: MobileNet V1 with width `multiplier`."""

    def __init__(self, multiplier=1.0, classes=1000, layout="NCHW",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            with self.features.name_scope():
                _add_conv(self.features, channels=int(32 * multiplier),
                          kernel=3, pad=1, stride=2, layout=layout)
                dw_channels = [int(x * multiplier) for x in
                               [32, 64] + [128] * 2 + [256] * 2
                               + [512] * 6 + [1024]]
                channels = [int(x * multiplier) for x in
                            [64] + [128] * 2 + [256] * 2 + [512] * 6
                            + [1024] * 2]
                strides = [1, 2] * 3 + [1] * 5 + [2, 1]
                for dwc, c, s in zip(dw_channels, channels, strides):
                    _add_conv_dw(self.features, dw_channels=dwc, channels=c,
                                 stride=s, layout=layout)
                self.features.add(nn.GlobalAvgPool2D(layout=layout))
                self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


class MobileNetV2(HybridBlock):
    """mobilenet.py:171: MobileNet V2 with width `multiplier`."""

    def __init__(self, multiplier=1.0, classes=1000, layout="NCHW",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="features_")
            with self.features.name_scope():
                _add_conv(self.features, int(32 * multiplier), kernel=3,
                          stride=2, pad=1, relu6=True, layout=layout)
                in_channels_group = [int(x * multiplier) for x in
                                     [32] + [16] + [24] * 2 + [32] * 3
                                     + [64] * 4 + [96] * 3 + [160] * 3]
                channels_group = [int(x * multiplier) for x in
                                  [16] + [24] * 2 + [32] * 3 + [64] * 4
                                  + [96] * 3 + [160] * 3 + [320]]
                ts = [1] + [6] * 16
                strides = [1, 2] * 2 + [1, 1, 2] + [1] * 6 + [2] + [1] * 3
                for in_c, c, t, s in zip(in_channels_group, channels_group,
                                         ts, strides):
                    self.features.add(LinearBottleneck(
                        in_channels=in_c, channels=c, t=t, stride=s,
                        layout=layout))
                last_channels = int(1280 * multiplier) \
                    if multiplier > 1.0 else 1280
                _add_conv(self.features, last_channels, relu6=True,
                          layout=layout)
                self.features.add(nn.GlobalAvgPool2D(layout=layout))
            self.output = nn.HybridSequential(prefix="output_")
            with self.output.name_scope():
                self.output.add(
                    nn.Conv2D(classes, 1, use_bias=False, prefix="pred_",
                              layout=layout),
                    nn.Flatten())

    def forward(self, x):
        return self.output(self.features(x))


def _suffix(multiplier):
    suffix = "{0:.2f}".format(multiplier)
    return suffix[:-1] if suffix in ("1.00", "0.50") else suffix


def get_mobilenet(multiplier, pretrained=False, ctx=None, root=None,
                  **kwargs):
    """mobilenet.py: MobileNet V1; `pretrained` loads
    ``mobilenet<multiplier>`` from `root`."""
    net = MobileNet(multiplier, **kwargs)
    if pretrained:
        load_pretrained(net, "mobilenet%s" % _suffix(multiplier), root, ctx)
    return net


def get_mobilenet_v2(multiplier, pretrained=False, ctx=None, root=None,
                     **kwargs):
    """mobilenet.py: MobileNet V2; `pretrained` loads
    ``mobilenetv2_<multiplier>`` from `root`."""
    net = MobileNetV2(multiplier, **kwargs)
    if pretrained:
        load_pretrained(net, "mobilenetv2_%s" % _suffix(multiplier), root,
                        ctx)
    return net


def mobilenet1_0(**kwargs):
    return get_mobilenet(1.0, **kwargs)


def mobilenet0_75(**kwargs):
    return get_mobilenet(0.75, **kwargs)


def mobilenet0_5(**kwargs):
    return get_mobilenet(0.5, **kwargs)


def mobilenet0_25(**kwargs):
    return get_mobilenet(0.25, **kwargs)


def mobilenet_v2_1_0(**kwargs):
    return get_mobilenet_v2(1.0, **kwargs)


def mobilenet_v2_0_75(**kwargs):
    return get_mobilenet_v2(0.75, **kwargs)


def mobilenet_v2_0_5(**kwargs):
    return get_mobilenet_v2(0.5, **kwargs)


def mobilenet_v2_0_25(**kwargs):
    return get_mobilenet_v2(0.25, **kwargs)
