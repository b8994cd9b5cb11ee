"""Basic Gluon layers (counterpart of mxnet_tpu/gluon/nn/basic_layers.py):
Sequential, HybridSequential, Dense, Dropout, BatchNorm, Embedding,
Flatten, InstanceNorm, LayerNorm, Lambda, HybridLambda.

Parameters whose shapes are known are made at construction, as zeros on
`device` (the current context's device unless given), until
`initialize` or `load_parameters` sets them; a shape that depends on the
input (``in_units=0``, ``in_channels=0``) waits for the first forward
(deferred initialization).

The mode follows `autograd`, as in Gluon: BatchNorm uses batch
statistics, and moves its running statistics, and Dropout drops, only
under `autograd.record()` / `train_mode()` (`autograd.is_training()`),
never by `nn.Module.training`.
"""
from __future__ import annotations

import math

import torch

from ... import autograd
from ... import ndarray as _nd
from ... import random as _random
from ...ops import nn as _ops
from ...ops import registry as _registry
from ..block import Block, HybridBlock
from .activations import Activation
from .conv_layers import Conv2D

__all__ = ["BatchNorm", "Dense", "Dropout", "Embedding", "Flatten",
           "HybridLambda", "HybridSequential", "InstanceNorm", "Lambda",
           "LayerNorm", "Sequential"]


class _Stack:
    """What Sequential and HybridSequential share (basic_layers.py:35,
    :103)."""

    def add(self, *blocks):
        """Add block(s) on top of the stack."""
        for block in blocks:
            self.register_child(block)

    def __getitem__(self, key):
        layers = list(self._modules.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            with net.name_scope():
                net.add(*layers)
            return net
        return layers

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class Sequential(_Stack, Block):
    """basic_layers.py:35: runs its children in order."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, x):
        for block in self._modules.values():
            x = block(x)
        return x


class HybridSequential(_Stack, HybridBlock):
    """basic_layers.py:103: runs its children in order.

    A 1x1 convolution followed by a BatchNorm that uses batch statistics
    (in training mode, `autograd.is_training()`) runs as one step: the
    convolution's `forward_with_stats` (the `conv1x1_bn_stats` kernel,
    whose epilogue computes the statistics) feeds the BatchNorm, which
    then does not read its input again for them. Any other child runs
    alone."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, x):
        blocks = list(self._modules.values())
        i = 0
        while i < len(blocks):
            nxt = blocks[i + 1] if i + 1 < len(blocks) else None
            if isinstance(blocks[i], Conv2D) and isinstance(nxt, BatchNorm) \
                    and nxt.uses_batch_stats and blocks[i].fuses_bn_stats(nxt, x):
                y, mean, var = blocks[i].forward_with_stats(x)
                x = nxt(y, stats=(mean, var))
                i += 2
            else:
                x = blocks[i](x)
                i += 1
        return x

    def _sym_forward(self, F, x):
        for block in self._modules.values():
            x = block(x)
        return x


class Dense(HybridBlock):
    """basic_layers.py:115: out = act(x @ weight.T + bias), weight
    (units, in_units); `in_units=0` takes it from the first input."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, device=None,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._flatten = flatten
        self._units = units
        with self.name_scope():
            self._new_param("weight", (units, in_units), dtype=dtype,
                            init=weight_initializer, device=device)
            if use_bias:
                self._new_param("bias", (units,), dtype=dtype,
                                init=bias_initializer, device=device)
            else:
                self.bias = None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def _infer_shapes(self, x):
        n = math.prod(x.shape[1:]) if self._flatten else x.shape[-1]
        return {"weight": (self._units, n)}

    def forward(self, x):
        self._ensure_params(x)
        y = _ops.fully_connected(x, self.weight, self.bias, self._flatten)
        return self.act(y) if self.act is not None else y

    def _sym_forward(self, F, x, weight, bias=None):
        if bias is None:
            act = F.FullyConnected(x, weight, no_bias=True,
                                   num_hidden=self._units,
                                   flatten=self._flatten, name="fwd")
        else:
            act = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                                   flatten=self._flatten, name="fwd")
        return self.act(act) if self.act is not None else act


class Dropout(HybridBlock):
    """basic_layers.py:163: in training mode, x * mask / (1 - rate) with
    a Bernoulli mask drawn from the package's generator for x's device
    (`random.generator`), shared along `axes`; the identity otherwise."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._rate = rate
        self._axes = tuple(axes)

    def forward(self, x):
        return _registry.get("Dropout").fn(
            _random.generator(x.device), x, p=self._rate, axes=self._axes,
            _mode="train" if autograd.is_training() else "predict")

    def _sym_forward(self, F, x):
        return F.Dropout(x, p=self._rate, axes=self._axes, name="fwd")


class BatchNorm(HybridBlock):
    """basic_layers.py:179, with Gluon's defaults: momentum 0.9, epsilon
    1e-5, ``fix_gamma = not scale``. In training mode
    (`autograd.is_training()`: under `autograd.record()`) it normalises
    with batch statistics and moves the running statistics in place,
    without gradient; otherwise it uses the running statistics and
    writes nothing. `in_channels=0` takes the channels from the first
    input."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 device=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._kwargs = {"eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        c = (in_channels,)
        self._new_param("gamma", c, grad_req="write" if scale else "null",
                        init=gamma_initializer, differentiable=scale,
                        device=device)
        self._new_param("beta", c, grad_req="write" if center else "null",
                        init=beta_initializer, differentiable=center,
                        device=device)
        self._new_param("running_mean", c, buffer=True, grad_req="null",
                        init=running_mean_initializer, differentiable=False,
                        device=device)
        self._new_param("running_var", c, buffer=True, grad_req="null",
                        init=running_variance_initializer,
                        differentiable=False, device=device)

    def _infer_shapes(self, x):
        c = (x.shape[self._axis],)
        return dict.fromkeys(("gamma", "beta", "running_mean",
                              "running_var"), c)

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
        self._ensure_params(x)
        y, new_mm, new_mv = _ops.batch_norm(
            x, self.gamma, self.beta, self.running_mean, self.running_var,
            axis=self._axis, training=autograd.is_training(), stats=stats,
            **self._kwargs)
        if self.uses_batch_stats:
            with torch.no_grad():
                self.running_mean.copy_(new_mm)
                self.running_var.copy_(new_mv)
        return y

    def _sym_forward(self, F, x, gamma, beta, running_mean, running_var):
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           name="fwd", axis=self._axis, **self._kwargs)


class Embedding(HybridBlock):
    """basic_layers.py:232: rows of weight (input_dim, output_dim) at the
    integer indices x. `sparse_grad` is accepted; the gradient is dense
    (sparse storage is not ported yet)."""

    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, sparse_grad=False, device=None,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._input_dim = input_dim
        self._sym_kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                            "dtype": dtype, "sparse_grad": sparse_grad}
        self._new_param("weight", (input_dim, output_dim), dtype=dtype,
                        init=weight_initializer, device=device)

    def forward(self, x):
        self._ensure_params(x)
        return _registry.get("Embedding").fn(
            x, self.weight, input_dim=self._input_dim,
            output_dim=self.weight.shape[1])

    def _sym_forward(self, F, x, weight):
        return F.Embedding(x, weight, name="fwd", **self._sym_kwargs)


class Flatten(HybridBlock):
    """basic_layers.py:255: (N, ...) -> (N, -1)."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)

    def _sym_forward(self, F, x):
        return F.Flatten(x)


class InstanceNorm(HybridBlock):
    """basic_layers.py:265: normalises each sample and channel over the
    spatial axes; `axis` is the channel axis."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, device=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._epsilon = epsilon
        c = (in_channels,)
        self._new_param("gamma", c, grad_req="write" if scale else "null",
                        init=gamma_initializer, device=device)
        self._new_param("beta", c, grad_req="write" if center else "null",
                        init=beta_initializer, device=device)

    def _infer_shapes(self, x):
        c = (x.shape[self._axis],)
        return {"gamma": c, "beta": c}

    def forward(self, x):
        self._ensure_params(x)
        fn = _registry.get("InstanceNorm").fn
        if self._axis == 1:
            return fn(x, self.gamma, self.beta, eps=self._epsilon)
        y = fn(x.transpose(1, self._axis), self.gamma, self.beta,
               eps=self._epsilon)
        return y.transpose(1, self._axis)

    def _sym_forward(self, F, x, gamma, beta):
        if self._axis == 1:
            return F.InstanceNorm(x, gamma, beta, name="fwd",
                                  eps=self._epsilon)
        x = F.swapaxes(x, dim1=1, dim2=self._axis)
        out = F.InstanceNorm(x, gamma, beta, name="fwd", eps=self._epsilon)
        return F.swapaxes(out, dim1=1, dim2=self._axis)


class LayerNorm(HybridBlock):
    """basic_layers.py:304: normalises over `axis`; the `LayerNorm`
    operator, whose forward is the `layer_norm` kernel on the card (its
    backward is plain PyTorch)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, device=None, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._axis = axis
        self._epsilon = epsilon
        c = (in_channels,)
        self._new_param("gamma", c, grad_req="write" if scale else "null",
                        init=gamma_initializer, device=device)
        self._new_param("beta", c, grad_req="write" if center else "null",
                        init=beta_initializer, device=device)

    def _infer_shapes(self, x):
        c = (x.shape[self._axis],)
        return {"gamma": c, "beta": c}

    def forward(self, x):
        self._ensure_params(x)
        return _registry.get("LayerNorm").fn(
            x, self.gamma, self.beta, axis=self._axis, eps=self._epsilon)

    def _sym_forward(self, F, data, gamma, beta):
        return F.LayerNorm(data, gamma=gamma, beta=beta, axis=self._axis,
                           eps=self._epsilon)


def _function(function, where):
    if isinstance(function, str):
        if not hasattr(_nd, function):
            raise AssertionError("Function name %s is not found in %s."
                                 % (function, where))
        return getattr(_nd, function)
    if callable(function):
        return function
    raise ValueError("Unrecognized function in lambda: {} of type {}"
                     .format(function, type(function)))


class Lambda(Block):
    """basic_layers.py:628: a function (or the name of an ``nd``
    function) as a block; it runs on NDArrays."""

    _ndarray_forward = True

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func_impl = _function(function, "ndarray")
        self._func_name = getattr(self._func_impl, "__name__", "custom")

    def forward(self, *args):
        return self._func_impl(*args)


class HybridLambda(HybridBlock):
    """basic_layers.py:670: ``function(F, x, *args)`` (or the name of an
    ``nd`` function) as a block; it runs on NDArrays with F =
    `mxnet_tpu_torch.ndarray`."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        if isinstance(function, str):
            _function(function, "symbol/ndarray")
            self._func = lambda F, *args: getattr(F, function)(*args)
            self._func_name = function
        else:
            fn = _function(function, "symbol/ndarray")
            self._func = fn
            self._func_name = getattr(fn, "__name__", "custom")

    def hybrid_forward(self, F, x, *args):
        return self._func(F, x, *args)
