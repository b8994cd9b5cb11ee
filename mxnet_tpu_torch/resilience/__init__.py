"""Resilience toolkit (counterpart of mxnet_tpu/resilience/): retry with
backoff, deadlines and the training numerics guard."""
from . import numerics
from .retry import (Deadline, DeadlineExceeded, RetryPolicy, TransientError,
                    retry_call)

__all__ = ["Deadline", "DeadlineExceeded", "RetryPolicy", "TransientError",
           "numerics", "retry_call"]
