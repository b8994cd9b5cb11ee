"""Weight initializers (counterpart of mxnet_tpu/initializer.py): the
registry and `create` (:26-38), `Initializer` (:54) with its dispatch by
name suffix, `Zero`/`One`/`Constant` (:194-210), `Uniform` (:222),
`Normal` (:234), `Xavier` (:266) and `MSRAPrelu` (:307).

An initializer fills a tensor in place (under no_grad): the values are
drawn in float32 on the CPU from `random.generator()` (or the generator
given to the initializer) and copied into the tensor, cast to its dtype.
Draws are PyTorch's, so the JAX package's initializers agree with these
in distribution (bounds, mean, std, and the fan-in/fan-out each computes
from the JAX layout's shape), not in bits.
"""
from __future__ import annotations

import json
import math
import re

import numpy as np
import torch

from . import random as _random
from .base import MXNetError

__all__ = ["Bilinear", "Constant", "FusedRNN", "InitDesc", "Initializer",
           "LSTMBias", "Load", "MSRAPrelu", "Mixed", "Normal", "One",
           "Orthogonal", "Uniform", "Xavier", "Zero", "create", "register"]

_REGISTRY = {}


def register(klass):
    _REGISTRY[klass.__name__.lower()] = klass
    return klass


def register_alias(klass, name):
    _REGISTRY[name.lower()] = klass
    return klass


def create(name, **kwargs):
    """An initializer from its registered name, or `name` itself when it
    already is one."""
    if isinstance(name, Initializer):
        return name
    if name.lower() not in _REGISTRY:
        raise MXNetError("unknown initializer %r" % (name,))
    return _REGISTRY[name.lower()](**kwargs)


class InitDesc(str):
    """A parameter's name, with the shape its fans are computed from
    (`fan_shape`: the JAX package's layout of the tensor, which for an
    NHWC convolution weight is (O, kh, kw, I) where the port keeps
    (O, I, kh, kw))."""

    def __new__(cls, name, attrs=None, fan_shape=None):
        ret = super().__new__(cls, name)
        ret.attrs = attrs or {}
        ret.fan_shape = None if fan_shape is None else tuple(fan_shape)
        return ret


def _fill(arr, values):
    with torch.no_grad():
        arr.copy_(values)


class Initializer:
    """Base initializer: callable on (name, tensor), dispatching on the
    name's suffix as initializer.py:84-104 does."""

    def __init__(self, generator=None, **kwargs):
        self._kwargs = kwargs
        self._generator = generator
        self._verbose = False

    def set_verbosity(self, verbose=False, print_func=None):
        self._verbose = verbose
        return self

    def _gen(self):
        return self._generator if self._generator is not None \
            else _random.generator("cpu")

    def __call__(self, desc, arr):
        if not isinstance(desc, str):
            raise TypeError("desc must be an initializer name string")
        if not isinstance(desc, InitDesc):
            desc = InitDesc(desc)
        name = str(desc)
        if name.endswith("weight"):
            self._init_weight(desc, arr)
        elif name.endswith("bias"):
            self._init_bias(desc, arr)
        elif name.endswith("gamma"):
            self._init_gamma(desc, arr)
        elif name.endswith("beta"):
            self._init_beta(desc, arr)
        elif name.endswith("min") or name.endswith("moving_mean"):
            self._init_zero(desc, arr)
        elif name.endswith("max"):
            self._init_one(desc, arr)
        elif name.endswith("moving_var") or name.endswith("moving_inv_var"):
            self._init_one(desc, arr)
        elif name.endswith("moving_avg"):
            self._init_zero(desc, arr)
        else:
            self._init_default(desc, arr)

    def _init_zero(self, _, arr):
        _fill(arr, torch.zeros(()))

    def _init_one(self, _, arr):
        _fill(arr, torch.ones(()))

    _init_bias = _init_zero
    _init_beta = _init_zero
    _init_gamma = _init_one

    def _init_bilinear(self, _, arr):
        """The bilinear upsampling filter (initializer.py:112)."""
        shape = arr.shape
        n = int(np.prod(shape))
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = np.arange(n)
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        weight = (1 - np.abs(x / f - c)) * (1 - np.abs(y / f - c))
        _fill(arr, torch.from_numpy(weight.reshape(shape).astype(
            np.float32)))

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def _init_weight(self, desc, arr):
        raise NotImplementedError

    def _init_default(self, desc, arr):
        raise MXNetError(
            "Unknown parameter name pattern %r; name your params with "
            "weight/bias/gamma/beta suffixes" % str(desc))

    def __repr__(self):
        return "%s(%s)" % (self.__class__.__name__, self._kwargs)


@register
class Zero(Initializer):
    def _init_weight(self, _, arr):
        _fill(arr, torch.zeros(()))

    _init_default = _init_weight


@register
class One(Initializer):
    def _init_weight(self, _, arr):
        _fill(arr, torch.ones(()))

    _init_default = _init_weight


@register
class Constant(Initializer):
    def __init__(self, value=0.0, generator=None):
        super().__init__(generator, value=value)
        self.value = value

    def _init_weight(self, _, arr):
        _fill(arr, torch.full((), float(self.value)))

    _init_default = _init_weight


@register
class Uniform(Initializer):
    """U(-scale, scale)."""

    def __init__(self, scale=0.07, generator=None):
        super().__init__(generator, scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        u = torch.rand(arr.shape, generator=self._gen())
        _fill(arr, u * (2 * self.scale) - self.scale)


@register
class Normal(Initializer):
    """N(0, sigma^2)."""

    def __init__(self, sigma=0.01, generator=None):
        super().__init__(generator, sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        _fill(arr, torch.randn(arr.shape, generator=self._gen())
              * self.sigma)


@register
class Xavier(Initializer):
    """Xavier/Glorot: scale = sqrt(magnitude / factor), the factor from
    the fans of the JAX layout's shape (initializer.py:279-291)."""

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3,
                 generator=None):
        super().__init__(generator, rnd_type=rnd_type,
                         factor_type=factor_type, magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _scale(self, desc, arr):
        shape = desc.fan_shape or tuple(arr.shape)
        if len(shape) < 2:
            raise MXNetError("Xavier requires ndim >= 2: %r %r"
                             % (str(desc), shape))
        hw_scale = float(np.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in, fan_out = shape[1] * hw_scale, shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise MXNetError("Incorrect factor type")
        return math.sqrt(self.magnitude / factor)

    def _init_weight(self, desc, arr):
        scale = self._scale(desc, arr)
        if self.rnd_type == "uniform":
            u = torch.rand(arr.shape, generator=self._gen())
            _fill(arr, u * (2 * scale) - scale)
        elif self.rnd_type == "gaussian":
            _fill(arr, torch.randn(arr.shape, generator=self._gen())
                  * scale)
        else:
            raise MXNetError("Unknown random type")


@register
class MSRAPrelu(Xavier):
    """Kaiming-He: Gaussian Xavier with magnitude 2 / (1 + slope^2)."""

    def __init__(self, factor_type="avg", slope=0.25, generator=None):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2),
                         generator)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Orthogonal(Initializer):
    """initializer.py:246: `scale` times an orthonormal basis (from the
    SVD of a uniform or normal draw of numpy's generator) shaped as the
    weight (out, prod(in))."""

    def __init__(self, scale=1.414, rand_type="uniform", generator=None):
        super().__init__(generator, scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        if self.rand_type == "uniform":
            tmp = np.random.uniform(-1.0, 1.0, (nout, nin))
        else:
            tmp = np.random.normal(0.0, 1.0, (nout, nin))
        u, _, v = np.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        _fill(arr, torch.from_numpy((self.scale * q.reshape(arr.shape))
                                    .astype(np.float32)))


@register
class Bilinear(Initializer):
    """initializer.py:316: the bilinear upsampling kernel, for a
    transposed convolution's weight."""

    def _init_weight(self, desc, arr):
        self._init_bilinear(desc, arr)


@register
class LSTMBias(Initializer):
    """initializer.py:322: zeros, with the forget gate's quarter of an
    LSTM bias at `forget_bias`."""

    def __init__(self, forget_bias=1.0, generator=None):
        super().__init__(generator, forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, _, arr):
        b = np.zeros(arr.shape, dtype=np.float32)
        num_hidden = int(b.shape[0] / 4)
        b[num_hidden:2 * num_hidden] = self.forget_bias
        _fill(arr, torch.from_numpy(b))

    _init_default = _init_weight
    _init_bias = _init_weight


@register
class FusedRNN(Initializer):
    """initializer.py:340: the flat parameter vector of a fused RNN
    layer, drawn as U(-1/sqrt(num_hidden), 1/sqrt(num_hidden)), as the
    JAX package draws it."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0, generator=None):
        if isinstance(init, str):
            klass, kwargs = json.loads(init)
            init = _REGISTRY[klass.lower()](**kwargs)
        super().__init__(generator, init=init.dumps() if init else None,
                         num_hidden=num_hidden, num_layers=num_layers,
                         mode=mode, bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._init = init
        self._num_hidden = num_hidden

    def _init_weight(self, desc, arr):
        self._init_default(desc, arr)

    def _init_default(self, _, arr):
        scale = math.sqrt(1.0 / self._num_hidden)
        u = torch.rand(arr.shape, generator=self._gen())
        _fill(arr, u * (2 * scale) - scale)


@register
class Load(Initializer):
    """initializer.py:153: the values of a dict {name: array} (names
    may carry the "arg:"/"aux:" prefixes of a saved file), else
    `default_init`."""

    def __init__(self, param, default_init=None, verbose=False):
        super().__init__()
        self.param = {
            (k[4:] if k.startswith(("arg:", "aux:")) else k): v
            for k, v in param.items()}
        self.default_init = default_init

    def __call__(self, name, arr):
        name = str(name)
        if name in self.param:
            src = self.param[name]
            src = src._data if hasattr(src, "_data") else \
                torch.as_tensor(np.asarray(src))
            if tuple(src.shape) != tuple(arr.shape):
                raise MXNetError("Load: shape mismatch for %s" % name)
            _fill(arr, src)
        else:
            if self.default_init is None:
                raise MXNetError("Load: no init for %r" % name)
            self.default_init(name, arr)


@register
class Mixed(Initializer):
    """initializer.py:177: the initializer of the first regex pattern
    that matches the parameter's name."""

    def __init__(self, patterns, initializers):
        super().__init__()
        if len(patterns) != len(initializers):
            raise MXNetError("patterns and initializers must pair up")
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def __call__(self, name, arr):
        for prog, init in self.map:
            if prog.match(str(name)):
                init(name, arr)
                return
        raise MXNetError("Mixed: no pattern matches %r; add '.*' last"
                         % str(name))


register_alias(Zero, "zeros")
register_alias(One, "ones")
