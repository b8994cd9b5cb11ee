"""Serving dtype and padding buckets (counterpart of
mxnet_tpu/serving/engine.py:53 and :78). `InferenceEngine` itself is not
ported yet."""
from __future__ import annotations

from ..base import MXNetError, getenv

__all__ = ["bucket_sizes", "resolve_serve_dtype"]


def resolve_serve_dtype(dtype):
    """Normalize a serving dtype spec ('bf16'/'fp32'/None + env
    ``MXTPU_SERVE_DTYPE``) to 'bf16' or 'fp32'."""
    if dtype is None:
        dtype = getenv("MXTPU_SERVE_DTYPE", "fp32")
    dtype = str(dtype).lower()
    if dtype in ("bf16", "bfloat16"):
        return "bf16"
    if dtype in ("fp32", "float32", "f32"):
        return "fp32"
    raise MXNetError("serve dtype must be 'fp32' or 'bf16', got %r"
                     % (dtype,))


def bucket_sizes(max_batch_size):
    """The padding-bucket ladder: powers of two below `max_batch_size`,
    plus `max_batch_size` itself (so a full batch never pads)."""
    max_batch_size = int(max_batch_size)
    if max_batch_size < 1:
        raise MXNetError("max_batch_size must be >= 1, got %d"
                         % max_batch_size)
    sizes = []
    b = 1
    while b < max_batch_size:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch_size)
    return tuple(sizes)
