"""NDArray (counterpart of mxnet_tpu/ndarray/): so far only the head type
that a loss returns under `autograd.record()`."""
from .ndarray import NDArray

__all__ = ["NDArray"]
