"""ResNet V1 (counterpart of mxnet_tpu/gluon/model_zoo/vision/resnet.py):
BasicBlockV1, BottleneckV1, ResNetV1 and resnet18_v1 ... resnet152_v1.

The blocks and their Gluon names are those of the JAX package, so weights
carry over by name (`convert.resnet_params_from_jax`). Pass
``layout="NHWC"`` for the channels-last net and feed (N, H, W, C) data.

In training mode (``net.train()``, the default) every 1x1 convolution
that a BatchNorm follows, in an NHWC net, runs through the hand-written
`conv1x1_bn_stats` kernel, whose epilogue gives the BatchNorm its batch
statistics (see `nn.HybridSequential`): in ResNet-50 the first and last
convolution of each of the 16 bottlenecks and the 4 downsample
convolutions, 36 launches per forward. In eval mode BatchNorm uses its
running statistics and every convolution is plain `F.conv2d`.

V2 (pre-activation) is not ported yet.
"""
from __future__ import annotations

from ....context import resolve_device
from ....ops import nn as _ops
from ... import nn
from ...block import HybridBlock

__all__ = ["BasicBlockV1", "BottleneckV1", "ResNetV1", "get_resnet",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1", "resnet_spec"]


def _conv3x3(channels, stride, in_channels, layout, device):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels, layout=layout,
                     device=device)


class BasicBlockV1(HybridBlock):
    """resnet.py:35 (resnet 18/34)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", device=None, prefix=None):
        super().__init__(prefix=prefix)
        ax = _ops.bn_axis(layout)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(_conv3x3(channels, stride, in_channels, layout,
                               device))
        self.body.add(nn.BatchNorm(axis=ax, in_channels=channels,
                                   device=device))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(channels, 1, channels, layout, device))
        self.body.add(nn.BatchNorm(axis=ax, in_channels=channels,
                                   device=device))
        self.downsample = None
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(
                channels, kernel_size=1, strides=stride, use_bias=False,
                in_channels=in_channels, layout=layout, device=device))
            self.downsample.add(nn.BatchNorm(axis=ax, in_channels=channels,
                                             device=device))

    def forward(self, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return _ops.activation(residual + x, "relu")


class BottleneckV1(HybridBlock):
    """resnet.py:66 (resnet 50/101/152). The body's 1x1 convolutions keep
    Gluon's default bias, as in the JAX package."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", device=None, prefix=None):
        super().__init__(prefix=prefix)
        ax = _ops.bn_axis(layout)
        mid = channels // 4
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.Conv2D(mid, kernel_size=1, strides=stride,
                                in_channels=in_channels, layout=layout,
                                device=device))
        self.body.add(nn.BatchNorm(axis=ax, in_channels=mid, device=device))
        self.body.add(nn.Activation("relu"))
        self.body.add(_conv3x3(mid, 1, mid, layout, device))
        self.body.add(nn.BatchNorm(axis=ax, in_channels=mid, device=device))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(channels, kernel_size=1, strides=1,
                                in_channels=mid, layout=layout,
                                device=device))
        self.body.add(nn.BatchNorm(axis=ax, in_channels=channels,
                                   device=device))
        self.downsample = None
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(
                channels, kernel_size=1, strides=stride, use_bias=False,
                in_channels=in_channels, layout=layout, device=device))
            self.downsample.add(nn.BatchNorm(axis=ax, in_channels=channels,
                                             device=device))

    def forward(self, x):
        residual = x
        x = self.body(x)
        if self.downsample is not None:
            residual = self.downsample(residual)
        return _ops.activation(x + residual, "relu")


class ResNetV1(HybridBlock):
    """resnet.py:173. Input images have 3 channels. Parameters are made on
    `device` (CUDA unless "cpu" is asked for) and are zero until
    `convert.init_resnet_params` or `load_parameters` sets them."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout="NCHW", device=None, prefix=None):
        super().__init__(prefix=prefix)
        assert len(layers) == len(channels) - 1
        dev = resolve_device(device)
        ax = _ops.bn_axis(layout)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 3, layout, dev))
            else:
                self.features.add(nn.Conv2D(
                    channels[0], 7, 2, 3, use_bias=False, in_channels=3,
                    layout=layout, device=dev))
                self.features.add(nn.BatchNorm(axis=ax,
                                               in_channels=channels[0],
                                               device=dev))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1, layout=layout))
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    channels[i], layout, dev))
            self.features.add(nn.GlobalAvgPool2D(layout=layout))
            self.output = nn.Dense(classes, in_units=channels[-1],
                                   device=dev)

    def _make_layer(self, block, layers, channels, stride, stage_index,
                    in_channels, layout, device):
        layer = nn.HybridSequential(prefix="stage%d_" % stage_index)
        with layer.name_scope():
            layer.add(block(channels, stride, channels != in_channels,
                            in_channels=in_channels, layout=layout,
                            device=device, prefix=""))
            for _ in range(layers - 1):
                layer.add(block(channels, 1, False, in_channels=channels,
                                layout=layout, device=device, prefix=""))
        return layer

    def forward(self, x):
        return self.output(self.features(x))


# resnet.py:269
resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048])}

_blocks = {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1}


def get_resnet(version, num_layers, **kwargs):
    """resnet.py:282, V1 only. kwargs go to `ResNetV1` (classes,
    thumbnail, layout, device)."""
    if num_layers not in resnet_spec:
        raise ValueError("Invalid number of layers: %d. Options are %s"
                         % (num_layers, sorted(resnet_spec)))
    if version != 1:
        raise ValueError("the port has ResNet V1 only, got version %r"
                         % (version,))
    block_type, layers, channels = resnet_spec[num_layers]
    return ResNetV1(_blocks[block_type], layers, channels, **kwargs)


def resnet18_v1(**kwargs):
    return get_resnet(1, 18, **kwargs)


def resnet34_v1(**kwargs):
    return get_resnet(1, 34, **kwargs)


def resnet50_v1(**kwargs):
    return get_resnet(1, 50, **kwargs)


def resnet101_v1(**kwargs):
    return get_resnet(1, 101, **kwargs)


def resnet152_v1(**kwargs):
    return get_resnet(1, 152, **kwargs)
