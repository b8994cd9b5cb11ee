"""VGG (counterpart of mxnet_tpu/gluon/model_zoo/vision/vgg.py): VGG,
vgg11 ... vgg19 and their batch-normalised variants."""
from __future__ import annotations

from ....initializer import Xavier
from ....ops import nn as _ops
from ... import nn
from ...block import HybridBlock
from ..model_store import load_pretrained

__all__ = ["VGG", "get_vgg", "vgg11", "vgg11_bn", "vgg13", "vgg13_bn",
           "vgg16", "vgg16_bn", "vgg19", "vgg19_bn"]


class VGG(HybridBlock):
    """vgg.py:36."""

    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 layout="NCHW", prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        assert len(layers) == len(filters)
        self._layout = layout
        with self.name_scope():
            self.features = self._make_features(layers, filters, batch_norm)
            self.features.add(nn.Dense(4096, activation="relu",
                                       weight_initializer="normal",
                                       bias_initializer="zeros"))
            self.features.add(nn.Dropout(rate=0.5))
            self.features.add(nn.Dense(4096, activation="relu",
                                       weight_initializer="normal",
                                       bias_initializer="zeros"))
            self.features.add(nn.Dropout(rate=0.5))
            self.output = nn.Dense(classes, weight_initializer="normal",
                                   bias_initializer="zeros")

    def _make_features(self, layers, filters, batch_norm):
        lo = self._layout
        featurizer = nn.HybridSequential(prefix="")
        for i, num in enumerate(layers):
            for _ in range(num):
                featurizer.add(nn.Conv2D(
                    filters[i], kernel_size=3, padding=1, layout=lo,
                    weight_initializer=Xavier(rnd_type="gaussian",
                                              factor_type="out",
                                              magnitude=2),
                    bias_initializer="zeros"))
                if batch_norm:
                    featurizer.add(nn.BatchNorm(axis=_ops.bn_axis(lo)))
                featurizer.add(nn.Activation("relu"))
            featurizer.add(nn.MaxPool2D(strides=2, layout=lo))
        return featurizer

    def forward(self, x):
        return self.output(self.features(x))


vgg_spec = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
            13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
            16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
            19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}


def get_vgg(num_layers, pretrained=False, ctx=None, root=None, **kwargs):
    """vgg.py:85."""
    layers, filters = vgg_spec[num_layers]
    net = VGG(layers, filters, **kwargs)
    if pretrained:
        load_pretrained(net, "vgg%d%s" % (
            num_layers, "_bn" if kwargs.get("batch_norm") else ""), root,
            ctx)
    return net


def vgg11(**kwargs):
    return get_vgg(11, **kwargs)


def vgg13(**kwargs):
    return get_vgg(13, **kwargs)


def vgg16(**kwargs):
    return get_vgg(16, **kwargs)


def vgg19(**kwargs):
    return get_vgg(19, **kwargs)


def vgg11_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(11, **kwargs)


def vgg13_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(13, **kwargs)


def vgg16_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(16, **kwargs)


def vgg19_bn(**kwargs):
    kwargs["batch_norm"] = True
    return get_vgg(19, **kwargs)
