"""Activation layers (counterpart of mxnet_tpu/gluon/nn/activations.py):
Activation, LeakyReLU, PReLU, ELU, SELU, Swish, GELU."""
from __future__ import annotations

import torch

from ... import initializer
from ...ops import nn as _ops
from ...ops import registry as _registry
from ..block import HybridBlock

__all__ = ["Activation", "ELU", "GELU", "LeakyReLU", "PReLU", "SELU",
           "Swish"]


def _leaky(x, act_type, *rest, **kw):
    """The `LeakyReLU` operator's deterministic forms (no generator)."""
    return _registry.get("LeakyReLU").fn(None, x, *rest, act_type=act_type,
                                         **kw)


class Activation(HybridBlock):
    """activations.py:16: applies `ops.nn.activation`."""

    def __init__(self, activation, prefix=None, params=None):
        self._act_type = activation
        super().__init__(prefix=prefix, params=params)

    def _alias(self):
        return self._act_type

    def forward(self, x):
        return _ops.activation(x, self._act_type)


class LeakyReLU(HybridBlock):
    """activations.py:59: max(x, alpha * x)."""

    def __init__(self, alpha, prefix=None, params=None):
        assert alpha >= 0, "Slope coefficient for LeakyReLU must be >= 0."
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def forward(self, x):
        return _leaky(x, "leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """activations.py:91: a leaky ReLU with a learned slope `alpha`
    (shape (1,), Constant(0.25) by default)."""

    def __init__(self, alpha_initializer=None, device=None, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        if alpha_initializer is None:
            alpha_initializer = initializer.Constant(0.25)
        with self.name_scope():
            self._new_param("alpha", (1,), init=alpha_initializer,
                            device=device)

    def forward(self, x):
        return _leaky(x, "prelu", self.alpha)


class ELU(HybridBlock):
    """activations.py:118: x for x >= 0, alpha * (exp(x) - 1) below."""

    def __init__(self, alpha=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def forward(self, x):
        return _leaky(x, "elu", slope=self._alpha)


class SELU(HybridBlock):
    """activations.py:145: the scaled ELU."""

    def forward(self, x):
        return _leaky(x, "selu")


class Swish(HybridBlock):
    """activations.py:163: x * sigmoid(beta * x)."""

    def __init__(self, beta=1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._beta = beta

    def forward(self, x):
        return x * torch.sigmoid(x * self._beta)


class GELU(HybridBlock):
    """activations.py: the `gelu` activation (tanh form, as the JAX
    package's jax.nn.gelu default)."""

    def forward(self, x):
        return _ops.activation(x, "gelu")
