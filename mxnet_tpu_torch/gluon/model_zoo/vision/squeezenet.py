"""SqueezeNet 1.0 and 1.1 (counterpart of
mxnet_tpu/gluon/model_zoo/vision/squeezenet.py)."""
from __future__ import annotations

import torch

from ....ops import nn as _ops
from ... import nn
from ...block import HybridBlock
from ..model_store import load_pretrained

__all__ = ["SqueezeNet", "get_squeezenet", "squeezenet1_0",
           "squeezenet1_1"]


def _make_fire(squeeze_channels, expand1x1_channels, expand3x3_channels,
               layout="NCHW"):
    out = nn.HybridSequential(prefix="")
    out.add(_make_fire_conv(squeeze_channels, 1, layout=layout))
    out.add(_FireConcat(expand1x1_channels, expand3x3_channels,
                        layout=layout))
    return out


def _make_fire_conv(channels, kernel_size, padding=0, layout="NCHW"):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(channels, kernel_size, padding=padding, layout=layout))
    out.add(nn.Activation("relu"))
    return out


class _FireConcat(HybridBlock):
    """The fire module's two expand paths, concatenated on channels."""

    def __init__(self, c1, c3, layout="NCHW", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = _ops.bn_axis(layout)
        self.p1 = _make_fire_conv(c1, 1, layout=layout)
        self.p3 = _make_fire_conv(c3, 3, 1, layout=layout)

    def forward(self, x):
        return torch.cat([self.p1(x), self.p3(x)], dim=self._axis)

    def _sym_forward(self, F, x):
        return F.concat(self.p1(x), self.p3(x), dim=self._axis)


class SqueezeNet(HybridBlock):
    """squeezenet.py:60."""

    def __init__(self, version, classes=1000, layout="NCHW", prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        assert version in ("1.0", "1.1"), \
            "Unsupported SqueezeNet version {version}: 1.0 or 1.1 " \
            "expected".format(version=version)
        lo = layout
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            f = self.features
            if version == "1.0":
                f.add(nn.Conv2D(96, kernel_size=7, strides=2, layout=lo))
                f.add(nn.Activation("relu"))
                f.add(nn.MaxPool2D(3, 2, ceil_mode=True, layout=lo))
                f.add(_make_fire(16, 64, 64, layout=lo))
                f.add(_make_fire(16, 64, 64, layout=lo))
                f.add(_make_fire(32, 128, 128, layout=lo))
                f.add(nn.MaxPool2D(3, 2, ceil_mode=True, layout=lo))
                f.add(_make_fire(32, 128, 128, layout=lo))
                f.add(_make_fire(48, 192, 192, layout=lo))
                f.add(_make_fire(48, 192, 192, layout=lo))
                f.add(_make_fire(64, 256, 256, layout=lo))
                f.add(nn.MaxPool2D(3, 2, ceil_mode=True, layout=lo))
                f.add(_make_fire(64, 256, 256, layout=lo))
            else:
                f.add(nn.Conv2D(64, kernel_size=3, strides=2, layout=lo))
                f.add(nn.Activation("relu"))
                f.add(nn.MaxPool2D(3, 2, ceil_mode=True, layout=lo))
                f.add(_make_fire(16, 64, 64, layout=lo))
                f.add(_make_fire(16, 64, 64, layout=lo))
                f.add(nn.MaxPool2D(3, 2, ceil_mode=True, layout=lo))
                f.add(_make_fire(32, 128, 128, layout=lo))
                f.add(_make_fire(32, 128, 128, layout=lo))
                f.add(nn.MaxPool2D(3, 2, ceil_mode=True, layout=lo))
                f.add(_make_fire(48, 192, 192, layout=lo))
                f.add(_make_fire(48, 192, 192, layout=lo))
                f.add(_make_fire(64, 256, 256, layout=lo))
                f.add(_make_fire(64, 256, 256, layout=lo))
            f.add(nn.Dropout(0.5))
            self.output = nn.HybridSequential(prefix="")
            self.output.add(nn.Conv2D(classes, kernel_size=1, layout=lo))
            self.output.add(nn.Activation("relu"))
            self.output.add(nn.GlobalAvgPool2D(layout=lo))
            self.output.add(nn.Flatten())

    def forward(self, x):
        return self.output(self.features(x))


def get_squeezenet(version, pretrained=False, ctx=None, root=None,
                   **kwargs):
    """squeezenet.py: SqueezeNet `version` ("1.0" or "1.1")."""
    net = SqueezeNet(version, **kwargs)
    if pretrained:
        load_pretrained(net, "squeezenet%s" % version, root, ctx)
    return net


def squeezenet1_0(**kwargs):
    return get_squeezenet("1.0", **kwargs)


def squeezenet1_1(**kwargs):
    return get_squeezenet("1.1", **kwargs)
