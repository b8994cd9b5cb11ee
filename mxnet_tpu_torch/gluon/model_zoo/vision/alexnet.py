"""AlexNet (counterpart of mxnet_tpu/gluon/model_zoo/vision/alexnet.py)."""
from __future__ import annotations

from ... import nn
from ...block import HybridBlock
from ..model_store import load_pretrained

__all__ = ["AlexNet", "alexnet"]


class AlexNet(HybridBlock):
    """alexnet.py:31."""

    def __init__(self, classes=1000, layout="NCHW", prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        lo = layout
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            with self.features.name_scope():
                self.features.add(nn.Conv2D(64, kernel_size=11, strides=4,
                                            layout=lo, padding=2,
                                            activation="relu"))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               layout=lo))
                self.features.add(nn.Conv2D(192, kernel_size=5, padding=2,
                                            layout=lo, activation="relu"))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               layout=lo))
                self.features.add(nn.Conv2D(384, kernel_size=3, padding=1,
                                            layout=lo, activation="relu"))
                self.features.add(nn.Conv2D(256, kernel_size=3, padding=1,
                                            layout=lo, activation="relu"))
                self.features.add(nn.Conv2D(256, kernel_size=3, padding=1,
                                            layout=lo, activation="relu"))
                self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                               layout=lo))
                self.features.add(nn.Flatten())
                self.features.add(nn.Dense(4096, activation="relu"))
                self.features.add(nn.Dropout(0.5))
                self.features.add(nn.Dense(4096, activation="relu"))
                self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def forward(self, x):
        return self.output(self.features(x))


def alexnet(pretrained=False, ctx=None, root=None, **kwargs):
    """alexnet.py:80."""
    net = AlexNet(**kwargs)
    if pretrained:
        load_pretrained(net, "alexnet", root, ctx)
    return net
