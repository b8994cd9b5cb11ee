"""Basic Gluon layers (counterpart of mxnet_tpu/gluon/nn/basic_layers.py):
HybridSequential, Dense, BatchNorm, Flatten.

Parameters are made on a device (`resolve_device`: CUDA unless the caller
says "cpu") with Gluon's constant defaults; weights start at zero until
`initialize`, `convert.init_resnet_params` or
`HybridBlock.load_parameters` sets them.

The mode follows `autograd`, as in Gluon: BatchNorm uses batch
statistics, and moves its running statistics, only under
`autograd.record()` / `train_mode()` (`autograd.is_training()`), never
by `nn.Module.training`.
"""
from __future__ import annotations

import torch
from torch import nn

from ... import autograd
from ...base import MXNetError
from ...context import resolve_device
from ...ops import nn as _ops
from ..block import HybridBlock
from .conv_layers import Conv2D

__all__ = ["BatchNorm", "Dense", "Flatten", "HybridSequential"]


class HybridSequential(HybridBlock):
    """basic_layers.py:76: runs its children in order.

    A 1x1 convolution followed by a BatchNorm that uses batch statistics
    (in training mode, `autograd.is_training()`) runs as one step: the
    convolution's `forward_with_stats` (the `conv1x1_bn_stats` kernel,
    whose epilogue computes the statistics) feeds the BatchNorm, which
    then does not read its input again for them. Any other child runs
    alone."""

    def add(self, *blocks):
        for block in blocks:
            self.add_module(str(len(self._modules)), block)

    def __getitem__(self, i):
        return list(self._modules.values())[i]

    def forward(self, x):
        blocks = list(self._modules.values())
        i = 0
        while i < len(blocks):
            nxt = blocks[i + 1] if i + 1 < len(blocks) else None
            if isinstance(blocks[i], Conv2D) and isinstance(nxt, BatchNorm) \
                    and nxt.uses_batch_stats and blocks[i].fuses_bn_stats(nxt):
                y, mean, var = blocks[i].forward_with_stats(x)
                x = nxt(y, stats=(mean, var))
                i += 2
            else:
                x = blocks[i](x)
                i += 1
        return x


class Dense(HybridBlock):
    """basic_layers.py:115: out = x @ weight.T + bias, weight
    (units, in_units)."""

    def __init__(self, units, use_bias=True, flatten=True, in_units=0,
                 device=None, prefix=None):
        super().__init__(prefix=prefix)
        if not in_units:
            raise MXNetError("Dense: the port needs in_units (no deferred "
                             "shape inference)")
        dev = resolve_device(device)
        self._flatten = flatten
        self.weight = nn.Parameter(torch.zeros(units, in_units, device=dev))
        self.bias = nn.Parameter(torch.zeros(units, device=dev)) \
            if use_bias else None

    def forward(self, x):
        return _ops.fully_connected(x, self.weight, self.bias, self._flatten)


class BatchNorm(HybridBlock):
    """basic_layers.py:179, with Gluon's defaults: momentum 0.9, epsilon
    1e-5, ``fix_gamma = not scale``. In training mode
    (`autograd.is_training()`: under `autograd.record()`) it normalises
    with batch statistics and moves the running statistics in place,
    without gradient; otherwise it uses the running statistics and
    writes nothing."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, in_channels=0,
                 device=None, prefix=None):
        super().__init__(prefix=prefix)
        if not in_channels:
            raise MXNetError("BatchNorm: the port needs in_channels (no "
                             "deferred shape inference)")
        dev = resolve_device(device)
        self._center, self._scale = center, scale
        self._axis = axis
        self._kwargs = {"eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        self.gamma = nn.Parameter(torch.ones(in_channels, device=dev))
        self.beta = nn.Parameter(torch.zeros(in_channels, device=dev))
        self.register_buffer("running_mean",
                             torch.zeros(in_channels, device=dev))
        self.register_buffer("running_var",
                             torch.ones(in_channels, device=dev))

    def _param_spec(self, attr, is_buffer):
        """basic_layers.py:195-212: gamma (ones) and beta (zeros) take a
        gradient when `scale` / `center`; the running statistics start at
        zeros and ones and take none."""
        if attr == "gamma":
            return {"grad_req": "write" if self._scale else "null",
                    "init": "ones", "differentiable": self._scale}
        if attr == "beta":
            return {"grad_req": "write" if self._center else "null",
                    "init": "zeros", "differentiable": self._center}
        return {"grad_req": "null", "differentiable": False,
                "init": "zeros" if attr == "running_mean" else "ones"}

    def cast(self, dtype):
        """float16 keeps float32 parameters (basic_layers.py:211-214);
        bfloat16 casts them."""
        if str(dtype).replace("torch.", "") == "float16":
            dtype = "float32"
        super().cast(dtype)

    @property
    def uses_batch_stats(self):
        return autograd.is_training() and \
            not self._kwargs["use_global_stats"]

    def forward(self, x, stats=None):
        """`stats` = (mean, var) of x already computed, in training."""
        y, new_mm, new_mv = _ops.batch_norm(
            x, self.gamma, self.beta, self.running_mean, self.running_var,
            axis=self._axis, training=autograd.is_training(), stats=stats,
            **self._kwargs)
        if self.uses_batch_stats:
            with torch.no_grad():
                self.running_mean.copy_(new_mm)
                self.running_var.copy_(new_mv)
        return y


class Flatten(HybridBlock):
    """basic_layers.py:255: (N, ...) -> (N, -1)."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)
