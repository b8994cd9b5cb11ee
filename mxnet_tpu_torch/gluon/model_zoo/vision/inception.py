"""Inception V3 (counterpart of
mxnet_tpu/gluon/model_zoo/vision/inception.py). It takes 299x299
images."""
from __future__ import annotations

from ....ops import nn as _ops
from ... import nn
from ...block import HybridBlock
from ...contrib.nn import HybridConcurrent as _Concurrent
from ..model_store import load_pretrained

__all__ = ["Inception3", "inception_v3"]


def _make_basic_conv(layout="NCHW", **kwargs):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(use_bias=False, layout=layout, **kwargs))
    out.add(nn.BatchNorm(epsilon=0.001, axis=_ops.bn_axis(layout)))
    out.add(nn.Activation("relu"))
    return out


def _make_branch(use_pool, layout, *conv_settings):
    out = nn.HybridSequential(prefix="")
    if use_pool == "avg":
        out.add(nn.AvgPool2D(pool_size=3, strides=1, padding=1,
                             layout=layout))
    elif use_pool == "max":
        out.add(nn.MaxPool2D(pool_size=3, strides=2, layout=layout))
    setting_names = ["channels", "kernel_size", "strides", "padding"]
    for setting in conv_settings:
        kwargs = {setting_names[i]: v for i, v in enumerate(setting)
                  if v is not None}
        out.add(_make_basic_conv(layout=layout, **kwargs))
    return out


def _make_A(pool_features, prefix, layout):
    out = _Concurrent(axis=_ops.bn_axis(layout), prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, layout, (64, 1, None, None)))
        out.add(_make_branch(None, layout, (48, 1, None, None),
                             (64, 5, None, 2)))
        out.add(_make_branch(None, layout, (64, 1, None, None),
                             (96, 3, None, 1), (96, 3, None, 1)))
        out.add(_make_branch("avg", layout, (pool_features, 1, None, None)))
    return out


def _make_B(prefix, layout):
    out = _Concurrent(axis=_ops.bn_axis(layout), prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, layout, (384, 3, 2, None)))
        out.add(_make_branch(None, layout, (64, 1, None, None),
                             (96, 3, None, 1), (96, 3, 2, None)))
        out.add(_make_branch("max", layout))
    return out


def _make_C(channels_7x7, prefix, layout):
    out = _Concurrent(axis=_ops.bn_axis(layout), prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, layout, (192, 1, None, None)))
        out.add(_make_branch(None, layout, (channels_7x7, 1, None, None),
                             (channels_7x7, (1, 7), None, (0, 3)),
                             (192, (7, 1), None, (3, 0))))
        out.add(_make_branch(None, layout, (channels_7x7, 1, None, None),
                             (channels_7x7, (7, 1), None, (3, 0)),
                             (channels_7x7, (1, 7), None, (0, 3)),
                             (channels_7x7, (7, 1), None, (3, 0)),
                             (192, (1, 7), None, (0, 3))))
        out.add(_make_branch("avg", layout, (192, 1, None, None)))
    return out


def _make_D(prefix, layout):
    out = _Concurrent(axis=_ops.bn_axis(layout), prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, layout, (192, 1, None, None),
                             (320, 3, 2, None)))
        out.add(_make_branch(None, layout, (192, 1, None, None),
                             (192, (1, 7), None, (0, 3)),
                             (192, (7, 1), None, (3, 0)),
                             (192, 3, 2, None)))
        out.add(_make_branch("max", layout))
    return out


class _BranchSplit(HybridBlock):
    """Two parallel convolutions, concatenated (inside the E blocks)."""

    def __init__(self, settings, layout="NCHW", prefix=None):
        super().__init__(prefix=prefix)
        self.paths = _Concurrent(axis=_ops.bn_axis(layout), prefix="")
        for s in settings:
            self.paths.add(_make_basic_conv(
                channels=s[0], kernel_size=s[1], padding=s[2],
                layout=layout))

    def forward(self, x):
        return self.paths(x)


class _EBranch(HybridBlock):
    def __init__(self, head_settings, split_settings, layout="NCHW",
                 prefix=None):
        super().__init__(prefix=prefix)
        self.head = nn.HybridSequential(prefix="")
        for s in head_settings:
            kwargs = {"channels": s[0], "kernel_size": s[1]}
            if s[2] is not None:
                kwargs["padding"] = s[2]
            self.head.add(_make_basic_conv(layout=layout, **kwargs))
        self.split = _BranchSplit(split_settings, layout=layout, prefix="")

    def forward(self, x):
        return self.split(self.head(x))


def _make_E(prefix, layout):
    out = _Concurrent(axis=_ops.bn_axis(layout), prefix=prefix)
    with out.name_scope():
        out.add(_make_branch(None, layout, (320, 1, None, None)))
        out.add(_EBranch([(384, 1, None)],
                         [(384, (1, 3), (0, 1)), (384, (3, 1), (1, 0))],
                         layout=layout))
        out.add(_EBranch([(448, 1, None), (384, 3, 1)],
                         [(384, (1, 3), (0, 1)), (384, (3, 1), (1, 0))],
                         layout=layout))
        out.add(_make_branch("avg", layout, (192, 1, None, None)))
    return out


class Inception3(HybridBlock):
    """inception.py:141."""

    def __init__(self, classes=1000, layout="NCHW", prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        lo = layout
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            f = self.features
            f.add(_make_basic_conv(channels=32, kernel_size=3, strides=2,
                                   layout=lo))
            f.add(_make_basic_conv(channels=32, kernel_size=3, layout=lo))
            f.add(_make_basic_conv(channels=64, kernel_size=3, padding=1,
                                   layout=lo))
            f.add(nn.MaxPool2D(pool_size=3, strides=2, layout=lo))
            f.add(_make_basic_conv(channels=80, kernel_size=1, layout=lo))
            f.add(_make_basic_conv(channels=192, kernel_size=3, layout=lo))
            f.add(nn.MaxPool2D(pool_size=3, strides=2, layout=lo))
            f.add(_make_A(32, "A1_", lo))
            f.add(_make_A(64, "A2_", lo))
            f.add(_make_A(64, "A3_", lo))
            f.add(_make_B("B_", lo))
            f.add(_make_C(128, "C1_", lo))
            f.add(_make_C(160, "C2_", lo))
            f.add(_make_C(160, "C3_", lo))
            f.add(_make_C(192, "C4_", lo))
            f.add(_make_D("D_", lo))
            f.add(_make_E("E1_", lo))
            f.add(_make_E("E2_", lo))
            f.add(nn.AvgPool2D(pool_size=8, layout=lo))
            f.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, ctx=None, root=None, **kwargs):
    """inception.py:192."""
    net = Inception3(**kwargs)
    if pretrained:
        load_pretrained(net, "inceptionv3", root, ctx)
    return net
