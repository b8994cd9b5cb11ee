"""Core shared definitions: the framework error and the env-var config
plane (counterpart of mxnet_tpu/base.py, copied so this package never
imports the JAX one)."""
from __future__ import annotations

import os

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
