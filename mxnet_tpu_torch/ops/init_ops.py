"""Source/init operators (counterpart of mxnet_tpu/ops/init_ops.py;
reference: src/operator/tensor/init_op.cc). They take no array input:
`ndarray.invoke` passes the device to create on as ``ctx``."""
from __future__ import annotations

import torch

from ..base import dtype_from_name
from .registry import register


def _dt(dtype):
    return dtype_from_name(dtype or "float32")


@register("_zeros", aliases=("zeros_op",))
def _zeros(*, shape=(), dtype="float32", ctx=None):
    return torch.zeros(tuple(shape), dtype=_dt(dtype), device=ctx)


@register("_ones", aliases=("ones_op",))
def _ones(*, shape=(), dtype="float32", ctx=None):
    return torch.ones(tuple(shape), dtype=_dt(dtype), device=ctx)


@register("_full")
def _full(*, shape=(), value=0.0, dtype="float32", ctx=None):
    return torch.full(tuple(shape), value, dtype=_dt(dtype), device=ctx)


@register("_arange")
def _arange(*, start=0.0, stop=None, step=1.0, repeat=1, infer_range=False,
            dtype="float32", ctx=None):
    if stop is None:
        start, stop = 0.0, start
    # computed in float64 and cast, as numpy's arange computes it
    arr = torch.arange(start, stop, step, dtype=torch.float64,
                       device=ctx).to(_dt(dtype))
    if repeat != 1:
        arr = torch.repeat_interleave(arr, repeat)
    return arr


@register("_eye", aliases=("eye",))
def _eye(*, N, M=0, k=0, dtype="float32", ctx=None):
    M = M or N
    return torch.ones(N, M, dtype=_dt(dtype), device=ctx).tril(k).triu(k)
