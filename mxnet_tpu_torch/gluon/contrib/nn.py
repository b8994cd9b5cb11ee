"""Contrib layers (counterpart of mxnet_tpu/gluon/contrib/nn.py):
Concurrent, HybridConcurrent, Identity."""
from __future__ import annotations

import torch

from ..block import HybridBlock
from ..nn import HybridSequential, Sequential

__all__ = ["Concurrent", "HybridConcurrent", "Identity"]


class Concurrent(Sequential):
    """nn.py:16: feeds the input to every child and concatenates their
    outputs along `axis`."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        return torch.cat([child(x) for child in self._modules.values()],
                         dim=self.axis)


class HybridConcurrent(HybridSequential):
    """nn.py:31: Concurrent of HybridBlocks."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def forward(self, x):
        return torch.cat([child(x) for child in self._modules.values()],
                         dim=self.axis)


class Identity(HybridBlock):
    """nn.py:43: passes its input through."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, x):
        return x
