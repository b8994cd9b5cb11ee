"""Core shared definitions: the framework error and the env-var config
plane (counterpart of mxnet_tpu/base.py, copied so this package never
imports the JAX one)."""
from __future__ import annotations

import os

import numpy as np
import torch

__version__ = "0.1.0"


class MXNetError(RuntimeError):
    """Framework error (name kept for API parity with the reference's
    python/mxnet/base.py:MXNetError)."""


def getenv(name, default):
    """Env-var config plane (reference: dmlc::GetEnv, docs/faq/env_var.md).

    All knobs are spelled MXTPU_* ; the reference's MXNET_* names are
    accepted as a fallback for familiarity.
    """
    val = os.environ.get(name)
    if val is None and name.startswith("MXTPU_"):
        val = os.environ.get("MXNET_" + name[len("MXTPU_"):])
    if val is None:
        return default
    if isinstance(default, bool):
        return val not in ("0", "false", "False", "")
    if isinstance(default, int):
        return int(val)
    if isinstance(default, float):
        return float(val)
    return val


# dtypes by MXNet name (mxnet_tpu/base.py:26), as torch dtypes
_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "uint8": torch.uint8, "int32": torch.int32, "int8": torch.int8,
    "int64": torch.int64, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def dtype_from_name(dtype):
    """A torch dtype from an MXNet dtype name, a numpy dtype or type, or
    a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    if not isinstance(dtype, str):
        dtype = getattr(dtype, "name", None) or np.dtype(dtype).name
    try:
        return _DTYPES[dtype]
    except KeyError:
        raise MXNetError("unknown dtype %r" % (dtype,)) from None


def dtype_name(dtype):
    """The MXNet name of a dtype."""
    return _NAMES[dtype_from_name(dtype)]


def np_dtype(dtype):
    """The numpy dtype of a torch dtype; bfloat16, which numpy lacks,
    as ml_dtypes' bfloat16 where that package is installed, else as the
    name 'bfloat16'."""
    if dtype == torch.bfloat16:
        try:
            import ml_dtypes
            return np.dtype(ml_dtypes.bfloat16)
        except ImportError:
            return "bfloat16"
    return np.dtype(_NAMES[dtype])


def tuple_param(value, length=None, name="param"):
    """Normalize an int-or-tuple op parameter (kernel, stride, pad...),
    as mxnet_tpu/base.py:101 does."""
    if value is None:
        return None
    if isinstance(value, (int, np.integer)):
        value = (int(value),) * (length or 1)
    value = tuple(int(v) for v in value)
    if length is not None and len(value) == 1:
        value = value * length
    if length is not None and len(value) != length:
        raise MXNetError("%s must have length %d, got %r"
                         % (name, length, value))
    return value
