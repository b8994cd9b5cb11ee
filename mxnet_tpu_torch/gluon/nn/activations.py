"""Activation layer (counterpart of mxnet_tpu/gluon/nn/activations.py)."""
from __future__ import annotations

from ...ops import nn as _ops
from ..block import HybridBlock

__all__ = ["Activation"]


class Activation(HybridBlock):
    """activations.py:16: applies `ops.nn.activation`."""

    def __init__(self, activation, prefix=None):
        self._act_type = activation
        super().__init__(prefix=prefix)

    def _alias(self):
        return self._act_type

    def forward(self, x):
        return _ops.activation(x, self._act_type)
