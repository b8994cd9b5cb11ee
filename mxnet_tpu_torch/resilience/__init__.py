"""Resilience toolkit (counterpart of mxnet_tpu/resilience/): deadlines and
the training numerics guard."""
from . import numerics
from .retry import Deadline, DeadlineExceeded

__all__ = ["Deadline", "DeadlineExceeded", "numerics"]
