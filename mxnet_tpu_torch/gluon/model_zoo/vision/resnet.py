"""ResNet V1 and V2 (counterpart of
mxnet_tpu/gluon/model_zoo/vision/resnet.py): BasicBlockV1, BottleneckV1,
BasicBlockV2, BottleneckV2, ResNetV1, ResNetV2 and resnet18_v1 ...
resnet152_v2.

The blocks and their Gluon names are those of the JAX package, so weights
carry over by name (`convert.resnet_params_from_jax`). Pass
``layout="NHWC"`` for the channels-last net and feed (N, H, W, C) data.

In training mode (under `autograd.record()`, as in Gluon) every 1x1
convolution that a BatchNorm follows, in an NHWC net, runs through the
hand-written `conv1x1_bn_stats` kernel, whose epilogue gives the
BatchNorm its batch statistics (see `nn.HybridSequential`): in ResNet-50
the first and last convolution of each of the 16 bottlenecks and the 4
downsample convolutions, 36 launches per forward. Outside it BatchNorm
uses its running statistics and every convolution is plain `F.conv2d`.

V1's layers are given their input channels, so its parameters exist
from construction on `device` (the current context's device unless
given); V2's, as in the JAX package, take most of theirs from the first
forward (deferred initialization).
"""
from __future__ import annotations

from ....context import resolve_device
from ....ops import nn as _ops
from ... import nn
from ...block import HybridBlock
from ..model_store import load_pretrained

__all__ = ["BasicBlockV1", "BasicBlockV2", "BottleneckV1", "BottleneckV2",
           "ResNetV1", "ResNetV2", "get_resnet", "resnet18_v1",
           "resnet18_v2", "resnet34_v1", "resnet34_v2", "resnet50_v1",
           "resnet50_v2", "resnet101_v1", "resnet101_v2", "resnet152_v1",
           "resnet152_v2", "resnet_spec"]


def _conv3x3(channels, stride, in_channels, layout, device):
    return nn.Conv2D(channels, kernel_size=3, strides=stride, padding=1,
                     use_bias=False, in_channels=in_channels, layout=layout,
                     device=device)


class BasicBlockV1(HybridBlock):
    """resnet.py:35 (resnet 18/34)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", device=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
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
                 layout="NCHW", device=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
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
    `initialize`, `convert.init_resnet_params` or `load_parameters` sets
    them."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout="NCHW", device=None, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
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


class BasicBlockV2(HybridBlock):
    """resnet.py:137: the pre-activation basic block (resnet 18/34)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        ax = _ops.bn_axis(layout)
        self.bn1 = nn.BatchNorm(axis=ax)
        self.conv1 = _conv3x3(channels, stride, in_channels, layout, None)
        self.bn2 = nn.BatchNorm(axis=ax)
        self.conv2 = _conv3x3(channels, 1, channels, layout, None)
        self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                    in_channels=in_channels, layout=layout) \
            if downsample else None

    def forward(self, x):
        residual = x
        x = _ops.activation(self.bn1(x), "relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = _ops.activation(self.bn2(x), "relu")
        x = self.conv2(x)
        return x + residual


class BottleneckV2(HybridBlock):
    """resnet.py:191: the pre-activation bottleneck (resnet 50/101/152)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 layout="NCHW", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        ax = _ops.bn_axis(layout)
        self.bn1 = nn.BatchNorm(axis=ax)
        self.conv1 = nn.Conv2D(channels // 4, kernel_size=1, strides=1,
                               use_bias=False, layout=layout)
        self.bn2 = nn.BatchNorm(axis=ax)
        self.conv2 = _conv3x3(channels // 4, stride, channels // 4, layout,
                              None)
        self.bn3 = nn.BatchNorm(axis=ax)
        self.conv3 = nn.Conv2D(channels, kernel_size=1, strides=1,
                               use_bias=False, layout=layout)
        self.downsample = nn.Conv2D(channels, 1, stride, use_bias=False,
                                    in_channels=in_channels, layout=layout) \
            if downsample else None

    def forward(self, x):
        residual = x
        x = _ops.activation(self.bn1(x), "relu")
        if self.downsample is not None:
            residual = self.downsample(x)
        x = self.conv1(x)
        x = _ops.activation(self.bn2(x), "relu")
        x = self.conv2(x)
        x = _ops.activation(self.bn3(x), "relu")
        x = self.conv3(x)
        return x + residual


class ResNetV2(HybridBlock):
    """resnet.py:302: the pre-activation ResNet."""

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, layout="NCHW", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        assert len(layers) == len(channels) - 1
        ax = _ops.bn_axis(layout)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.BatchNorm(axis=ax, scale=False,
                                           center=False))
            if thumbnail:
                self.features.add(_conv3x3(channels[0], 1, 0, layout, None))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False, layout=layout))
                self.features.add(nn.BatchNorm(axis=ax))
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1, layout=layout))
            in_channels = channels[0]
            for i, num_layer in enumerate(layers):
                stride = 1 if i == 0 else 2
                self.features.add(self._make_layer(
                    block, num_layer, channels[i + 1], stride, i + 1,
                    in_channels, layout))
                in_channels = channels[i + 1]
            self.features.add(nn.BatchNorm(axis=ax))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.GlobalAvgPool2D(layout=layout))
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes, in_units=in_channels)

    def _make_layer(self, block, layers, channels, stride, stage_index,
                    in_channels, layout):
        layer = nn.HybridSequential(prefix="stage%d_" % stage_index)
        with layer.name_scope():
            layer.add(block(channels, stride, channels != in_channels,
                            in_channels=in_channels, layout=layout,
                            prefix=""))
            for _ in range(layers - 1):
                layer.add(block(channels, 1, False, in_channels=channels,
                                layout=layout, prefix=""))
        return layer

    def forward(self, x):
        return self.output(self.features(x))


# resnet.py:355
resnet_spec = {
    18: ("basic_block", [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: ("basic_block", [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: ("bottle_neck", [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: ("bottle_neck", [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: ("bottle_neck", [3, 8, 36, 3], [64, 256, 512, 1024, 2048])}

resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2}]


def get_resnet(version, num_layers, pretrained=False, ctx=None, root=None,
               **kwargs):
    """resnet.py:369. kwargs go to the net (classes, thumbnail, layout;
    V1 also device). `pretrained` loads ``resnet<n>_v<version>`` from
    `root` through `load_parameters` (on `ctx`, default the current
    context)."""
    if num_layers not in resnet_spec:
        raise ValueError("Invalid number of layers: %d. Options are %s"
                         % (num_layers, sorted(resnet_spec)))
    if version not in (1, 2):
        raise ValueError("Invalid resnet version: %d. Options are 1 and 2."
                         % version)
    block_type, layers, channels = resnet_spec[num_layers]
    net = resnet_net_versions[version - 1](
        resnet_block_versions[version - 1][block_type], layers, channels,
        **kwargs)
    if pretrained:
        load_pretrained(net, "resnet%d_v%d" % (num_layers, version), root,
                        ctx)
    return net


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


def resnet18_v2(**kwargs):
    return get_resnet(2, 18, **kwargs)


def resnet34_v2(**kwargs):
    return get_resnet(2, 34, **kwargs)


def resnet50_v2(**kwargs):
    return get_resnet(2, 50, **kwargs)


def resnet101_v2(**kwargs):
    return get_resnet(2, 101, **kwargs)


def resnet152_v2(**kwargs):
    return get_resnet(2, 152, **kwargs)
