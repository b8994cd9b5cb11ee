"""Elementwise, scalar, broadcast and reduction operators (counterpart of
mxnet_tpu/ops/math.py), on torch tensors with the JAX package's formulas:
comparisons and logical ops return 0/1 in x's dtype, `logical_not` is
``(x == 0)`` in x's dtype, `argmax`/`argmin` return float32, integer
sums and products stay in the input's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import dtype_from_name
from .registry import alias, register


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


_UNARY = {
    "abs": torch.abs, "sign": torch.sign, "ceil": torch.ceil,
    "floor": torch.floor, "rint": torch.round, "round": torch.round,
    "trunc": torch.trunc, "fix": torch.trunc,
    "exp": torch.exp, "log": torch.log, "log2": torch.log2,
    "log10": torch.log10, "log1p": torch.log1p, "expm1": torch.expm1,
    "sqrt": torch.sqrt, "cbrt": _cbrt, "square": torch.square,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "arcsinh": torch.asinh, "arccosh": torch.acosh, "arctanh": torch.atanh,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
    "erf": torch.erf, "erfinv": torch.erfinv, "gammaln": torch.lgamma,
    "logical_not": lambda x: (x == 0).to(x.dtype),
    "negative": torch.neg,
    "reciprocal": lambda x: 1.0 / x,
    "rsqrt": torch.rsqrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "softsign": F.softsign,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
}


def _make_unary(fn):
    def op(x):
        return fn(x)
    return op


for _name, _fn in _UNARY.items():
    register(_name)(_make_unary(_fn))

alias("negative", "_np_negative")
alias("reciprocal", "_rdiv_int")


@register("clip")
def _clip(x, *, a_min, a_max):
    return torch.clamp(x, a_min, a_max)


@register("BlockGrad", aliases=("stop_gradient",))
def _block_grad(x):
    return x.detach()


@register("identity", aliases=("_copy",))
def _identity(x):
    return x


@register("Cast", aliases=("cast",))
def _cast(x, *, dtype):
    return x.to(dtype_from_name(dtype))


@register("zeros_like")
def _zeros_like(x):
    return torch.zeros_like(x)


@register("ones_like")
def _ones_like(x):
    return torch.ones_like(x)


@register("shape_array")
def _shape_array(x):
    return torch.tensor(x.shape, dtype=torch.int32, device=x.device)


@register("size_array")
def _size_array(x):
    return torch.tensor([x.numel()], dtype=torch.int32, device=x.device)


# ---------------------------------------------------------------------------
# binary elementwise (same-shape) and broadcast variants
# ---------------------------------------------------------------------------

def _logical(fn):
    def wrapped(a, b):
        return fn(a != 0, b != 0).to(a.dtype)
    return wrapped


_BINARY = {
    "add": torch.add, "sub": torch.sub, "mul": torch.mul,
    "div": torch.true_divide, "mod": torch.remainder, "power": torch.pow,
    "maximum": torch.maximum, "minimum": torch.minimum,
    "hypot": torch.hypot,
    "equal": lambda a, b: (a == b).to(a.dtype),
    "not_equal": lambda a, b: (a != b).to(a.dtype),
    "greater": lambda a, b: (a > b).to(a.dtype),
    "greater_equal": lambda a, b: (a >= b).to(a.dtype),
    "lesser": lambda a, b: (a < b).to(a.dtype),
    "lesser_equal": lambda a, b: (a <= b).to(a.dtype),
    "logical_and": _logical(torch.logical_and),
    "logical_or": _logical(torch.logical_or),
    "logical_xor": _logical(torch.logical_xor),
}


def _make_binary(fn):
    def op(a, b):
        return fn(a, b)
    return op


for _name, _fn in _BINARY.items():
    register("broadcast_%s" % _name)(_make_binary(_fn))

alias("broadcast_add", "elemwise_add", "_plus", "_add")
alias("broadcast_sub", "elemwise_sub", "_minus", "_sub")
alias("broadcast_mul", "elemwise_mul", "_mul")
alias("broadcast_div", "elemwise_div", "_div")
alias("broadcast_mod", "_mod")
alias("broadcast_power", "_power", "_Power")
alias("broadcast_maximum", "_maximum", "_Maximum")
alias("broadcast_minimum", "_minimum", "_Minimum")
alias("broadcast_hypot", "_hypot")
alias("broadcast_equal", "_equal")
alias("broadcast_not_equal", "_not_equal")
alias("broadcast_greater", "_greater")
alias("broadcast_greater_equal", "_greater_equal")
alias("broadcast_lesser", "_lesser")
alias("broadcast_lesser_equal", "_lesser_equal")


# scalar forms (reference: elemwise_binary_scalar_op_basic.cc): the scalar
# is a param. A float scalar promotes an integer x to float32, as JAX's
# weakly typed Python scalar does.

def _make_scalar(fn):
    def op(x, *, scalar):
        return fn(x, scalar)
    return op


def _full(x, s):
    """The scalar as a tensor of x's result dtype (for the functions that
    take no Python number in the first slot)."""
    return torch.full_like(x, s, dtype=torch.result_type(x, s))


def _reg_scalar(name, fn, rfn=None):
    register("_%s_scalar" % name)(_make_scalar(fn))
    if rfn is not None:
        register("_r%s_scalar" % name)(_make_scalar(rfn))


_reg_scalar("plus", torch.add)
_reg_scalar("minus", torch.sub, lambda x, s: s - x)
_reg_scalar("mul", torch.mul)
_reg_scalar("div", torch.true_divide, lambda x, s: s / x)
_reg_scalar("mod", torch.remainder,
            lambda x, s: torch.remainder(_full(x, s), x))
_reg_scalar("power", torch.pow, lambda x, s: torch.pow(s, x))
_reg_scalar("maximum", lambda x, s: torch.maximum(x, _full(x, s)))
_reg_scalar("minimum", lambda x, s: torch.minimum(x, _full(x, s)))
_reg_scalar("hypot", lambda x, s: torch.hypot(x, _full(x, s)))
_reg_scalar("equal", lambda x, s: (x == s).to(x.dtype))
_reg_scalar("not_equal", lambda x, s: (x != s).to(x.dtype))
_reg_scalar("greater", lambda x, s: (x > s).to(x.dtype))
_reg_scalar("greater_equal", lambda x, s: (x >= s).to(x.dtype))
_reg_scalar("lesser", lambda x, s: (x < s).to(x.dtype))
_reg_scalar("lesser_equal", lambda x, s: (x <= s).to(x.dtype))
alias("_plus_scalar", "_PlusScalar")
alias("_minus_scalar", "_MinusScalar")
alias("_mul_scalar", "_MulScalar")
alias("_div_scalar", "_DivScalar")


@register("smooth_l1")
def _smooth_l1(x, *, scalar=1.0):
    s2 = scalar * scalar
    ax = torch.abs(x)
    return torch.where(ax < 1.0 / s2, 0.5 * s2 * x * x, ax - 0.5 / s2)


# ---------------------------------------------------------------------------
# reductions (reference: broadcast_reduce_op_value.cc)
# ---------------------------------------------------------------------------

def _norm_axis(axis):
    if axis is None or axis == ():
        return None
    if isinstance(axis, int):
        return (axis,)
    return tuple(axis)


def _dims(x, ax):
    return tuple(range(x.dim())) if ax is None else \
        tuple(a % x.dim() for a in ax)


def _int_keep(fn):
    """An integer reduction keeps x's dtype (torch widens to int64)."""
    def op(x, ax, keepdims):
        out = fn(x, ax, keepdims)
        if not x.is_floating_point() and x.dtype != torch.bool:
            out = out.to(x.dtype)
        return out
    return op


def _prod(x, ax, keepdims):
    out = x
    for d in sorted(_dims(x, ax), reverse=True):
        out = torch.prod(out, dim=d, keepdim=keepdims)
    return out


def _mean(x, ax, keepdims):
    if not x.is_floating_point():
        x = x.float()
    return torch.mean(x, dim=_dims(x, ax), keepdim=keepdims)


_REDUCE = {
    "sum": _int_keep(lambda x, ax, k: torch.sum(x, dim=_dims(x, ax),
                                                keepdim=k)),
    "mean": _mean,
    "prod": _int_keep(_prod),
    "nansum": _int_keep(lambda x, ax, k: torch.nansum(x, dim=_dims(x, ax),
                                                      keepdim=k)),
    "nanprod": _int_keep(lambda x, ax, k: _prod(
        torch.where(torch.isnan(x), torch.ones_like(x), x)
        if x.is_floating_point() else x, ax, k)),
    "max": lambda x, ax, k: torch.amax(x, dim=_dims(x, ax), keepdim=k),
    "min": lambda x, ax, k: torch.amin(x, dim=_dims(x, ax), keepdim=k),
}


def _reg_reduce(name, fn):
    def op(x, *, axis=None, keepdims=False, exclude=False):
        ax = _norm_axis(axis)
        if exclude and ax is not None:
            ax = tuple(i for i in range(x.dim()) if i not in
                       tuple(a % x.dim() for a in ax))
        return fn(x, ax, keepdims)
    register(name)(op)


for _name, _fn in _REDUCE.items():
    _reg_reduce(_name, _fn)
alias("sum", "sum_axis")
alias("max", "max_axis")
alias("min", "min_axis")


@register("norm")
def _norm(x, *, ord=2, axis=None, keepdims=False):
    dims = _dims(x, _norm_axis(axis))
    if ord == 1:
        return torch.sum(torch.abs(x), dim=dims, keepdim=keepdims)
    return torch.sqrt(torch.sum(torch.square(x), dim=dims,
                                keepdim=keepdims))


def _arg(fn, x, axis, keepdims):
    if axis is None:
        out = fn(x.reshape(-1))
        if keepdims:
            out = out.reshape((1,) * x.dim())
    else:
        out = fn(x, dim=axis, keepdim=keepdims)
    return out.to(torch.float32)


@register("argmax")
def _argmax(x, *, axis=None, keepdims=False):
    return _arg(torch.argmax, x, axis, keepdims)


@register("argmin")
def _argmin(x, *, axis=None, keepdims=False):
    return _arg(torch.argmin, x, axis, keepdims)


@register("argmax_channel")
def _argmax_channel(x):
    return torch.argmax(x, dim=1).to(torch.float32)


@register("broadcast_to")
def _broadcast_to(x, *, shape):
    # MXNet: 0 in the target shape keeps the source dim
    shape = tuple(int(s) if int(s) != 0 else int(x.shape[i])
                  for i, s in enumerate(shape))
    return torch.broadcast_to(x, shape)


@register("broadcast_axis", aliases=("broadcast_axes",))
def _broadcast_axis(x, *, axis, size):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    shape = list(x.shape)
    for a, s in zip(axes, sizes):
        shape[a] = s
    return torch.broadcast_to(x, tuple(shape))


@register("broadcast_like")
def _broadcast_like(x, y):
    return torch.broadcast_to(x, y.shape)


@register("khatri_rao")
def _khatri_rao(*mats):
    out = mats[0]
    for m in mats[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, out.shape[-1])
    return out


@register("cumsum")
def _cumsum(x, *, axis=None, dtype=None):
    out = torch.cumsum(x.reshape(-1) if axis is None else x,
                       dim=0 if axis is None else axis)
    if not x.is_floating_point() and x.dtype != torch.bool:
        out = out.to(x.dtype)
    return out


@register("logsumexp")
def _logsumexp(x, *, axis=None, keepdims=False):
    return torch.logsumexp(x, dim=_dims(x, _norm_axis(axis)),
                           keepdim=keepdims)
