"""Resilience toolkit (counterpart of mxnet_tpu/resilience/): deadlines."""
from .retry import Deadline, DeadlineExceeded

__all__ = ["Deadline", "DeadlineExceeded"]
