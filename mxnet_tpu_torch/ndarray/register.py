"""Frontend codegen: one `nd.<name>` function per registered operator
(counterpart of mxnet_tpu/ndarray/register.py).

The calling convention is MXNet's: NDArray inputs positionally, or by
the op's input names as keywords; everything else a keyword param;
``out=`` receives the result in place; an op with several visible
outputs returns a list.
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError
from ..ops import registry as _reg
from .ndarray import NDArray, invoke

__all__ = ["populate"]


def _make_op_func(op):
    names = set(op.input_names)

    def fn(*args, **kwargs):
        inputs = []
        for a in args:
            if isinstance(a, (NDArray, torch.Tensor, np.ndarray, list)):
                inputs.append(a)
            else:
                raise MXNetError(
                    "op %s: positional arguments must be NDArrays, got %r "
                    "(pass params as keywords)" % (op.name, type(a)))
        out = kwargs.pop("out", None)
        kwargs.pop("name", None)
        named, params = {}, {}
        for k, v in kwargs.items():
            if isinstance(v, (NDArray, torch.Tensor)) or (
                    k in names and v is not None and
                    not isinstance(v, (int, float, str, bool, tuple))):
                named[k] = v
            else:
                params[k] = v
        if named:
            # keyword inputs at their slots after the positional ones;
            # names the op does not list (variadic inputs) after those
            order = [n for n in op.input_names if n in named]
            order += [n for n in named if n not in names]
            inputs += [named[n] for n in order]
        outs = invoke(op, inputs, params, out=out)
        if out is not None:
            return out
        return outs[0] if len(outs) == 1 else outs

    fn.__name__ = op.name
    fn.__doc__ = op.doc
    return fn


def populate(namespace_dict):
    """Install one function per registered op into a module namespace
    (names it already has are kept)."""
    done = set()
    for name in _reg.list_ops():
        namespace_dict.setdefault(name, _make_op_func(_reg.get(name)))
        done.add(name)
    return done
