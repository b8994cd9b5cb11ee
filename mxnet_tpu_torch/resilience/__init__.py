"""Resilience toolkit (counterpart of mxnet_tpu/resilience/): retry with
backoff and deadlines, fault injection, the device lease, the health
watchdog and the training numerics guard."""
from . import numerics
from .atomic import atomic_write, exclusive_create
from .chaos import (InjectedFailure, InjectedFault, chaos_point, configure,
                    parse_spec, reset, trip_count)
from .lease import DeviceLease, LeaseHeld
from .retry import (Deadline, DeadlineExceeded, RetryPolicy, TransientError,
                    retry_call, run_with_deadline)
from .watchdog import DeviceUnreachable, HealthWatchdog

__all__ = ["Deadline", "DeadlineExceeded", "DeviceLease",
           "DeviceUnreachable", "HealthWatchdog", "InjectedFailure",
           "InjectedFault", "LeaseHeld", "RetryPolicy", "TransientError",
           "atomic_write", "chaos_point", "configure", "exclusive_create",
           "numerics", "parse_spec", "reset", "retry_call",
           "run_with_deadline", "trip_count"]
