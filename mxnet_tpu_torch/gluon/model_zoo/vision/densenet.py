"""DenseNet (counterpart of mxnet_tpu/gluon/model_zoo/vision/densenet.py):
densenet121, 161, 169, 201."""
from __future__ import annotations

import torch

from ....ops import nn as _ops
from ... import nn
from ...block import HybridBlock
from ..model_store import load_pretrained

__all__ = ["DenseNet", "densenet121", "densenet161", "densenet169",
           "densenet201", "get_densenet"]


class _DenseLayer(HybridBlock):
    def __init__(self, growth_rate, bn_size, dropout, layout="NCHW",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._cax = _ops.bn_axis(layout)
        self.body = nn.HybridSequential(prefix="")
        self.body.add(nn.BatchNorm(axis=self._cax))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(bn_size * growth_rate, kernel_size=1,
                                use_bias=False, layout=layout))
        self.body.add(nn.BatchNorm(axis=self._cax))
        self.body.add(nn.Activation("relu"))
        self.body.add(nn.Conv2D(growth_rate, kernel_size=3, padding=1,
                                use_bias=False, layout=layout))
        if dropout:
            self.body.add(nn.Dropout(dropout))

    def forward(self, x):
        return torch.cat([x, self.body(x)], dim=self._cax)

    def _sym_forward(self, F, x):
        out = self.body(x)
        return F.concat(x, out, dim=self._cax)


def _make_dense_block(num_layers, bn_size, growth_rate, dropout,
                      stage_index, layout="NCHW"):
    out = nn.HybridSequential(prefix="stage%d_" % stage_index)
    with out.name_scope():
        for _ in range(num_layers):
            out.add(_DenseLayer(growth_rate, bn_size, dropout,
                                layout=layout))
    return out


def _make_transition(num_output_features, layout="NCHW"):
    out = nn.HybridSequential(prefix="")
    out.add(nn.BatchNorm(axis=_ops.bn_axis(layout)))
    out.add(nn.Activation("relu"))
    out.add(nn.Conv2D(num_output_features, kernel_size=1, use_bias=False,
                      layout=layout))
    out.add(nn.AvgPool2D(pool_size=2, strides=2, layout=layout))
    return out


class DenseNet(HybridBlock):
    """densenet.py:65."""

    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, layout="NCHW",
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        lo = layout
        cax = _ops.bn_axis(lo)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(num_init_features, kernel_size=7,
                                        strides=2, padding=3,
                                        use_bias=False, layout=lo))
            self.features.add(nn.BatchNorm(axis=cax))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                           padding=1, layout=lo))
            num_features = num_init_features
            for i, num_layers in enumerate(block_config):
                self.features.add(_make_dense_block(
                    num_layers, bn_size, growth_rate, dropout, i + 1,
                    layout=lo))
                num_features = num_features + num_layers * growth_rate
                if i != len(block_config) - 1:
                    self.features.add(_make_transition(num_features // 2,
                                                       layout=lo))
                    num_features = num_features // 2
            self.features.add(nn.BatchNorm(axis=cax))
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.AvgPool2D(pool_size=7, layout=lo))
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


# num_init_features, growth_rate, block_config (densenet.py:120)
densenet_spec = {121: (64, 32, [6, 12, 24, 16]),
                 161: (96, 48, [6, 12, 36, 24]),
                 169: (64, 32, [6, 12, 32, 32]),
                 201: (64, 32, [6, 12, 48, 32])}


def get_densenet(num_layers, pretrained=False, ctx=None, root=None,
                 **kwargs):
    """densenet.py: DenseNet-`num_layers`."""
    num_init_features, growth_rate, block_config = densenet_spec[num_layers]
    net = DenseNet(num_init_features, growth_rate, block_config, **kwargs)
    if pretrained:
        load_pretrained(net, "densenet%d" % num_layers, root, ctx)
    return net


def densenet121(**kwargs):
    return get_densenet(121, **kwargs)


def densenet161(**kwargs):
    return get_densenet(161, **kwargs)


def densenet169(**kwargs):
    return get_densenet(169, **kwargs)


def densenet201(**kwargs):
    return get_densenet(201, **kwargs)
