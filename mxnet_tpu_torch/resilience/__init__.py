"""Resilience toolkit (counterpart of mxnet_tpu/resilience/): retry with
backoff and deadlines, fault injection (`chaos_point`, `corrupt_point`),
the device lease, the health watchdog, the training numerics guard (loss
scaling, divergence rollback, SDC replay), preemption at a step boundary
and the gang supervisor with its exit-code contract."""
from . import numerics
from .atomic import atomic_write, exclusive_create
from .chaos import (InjectedFailure, InjectedFault, chaos_point, configure,
                    corrupt_point, parse_spec, reset, trip_count)
from .lease import DeviceLease, LeaseHeld
from .numerics import (DivergenceWatchdog, GradScaler, NumericsGuard,
                       TrainingDiverged)
from .preempt import (PreemptionGuard, TrainingPreempted, at_step_boundary,
                      preemption_requested)
from .retry import (Deadline, DeadlineExceeded, RetryPolicy, TransientError,
                    retry_call, run_with_deadline)
from .supervisor import (GangSupervisor, PeerLost, RankHeartbeat,
                         exit_status, run_supervised)
from .watchdog import DeviceUnreachable, HealthWatchdog

__all__ = ["Deadline", "DeadlineExceeded", "DeviceLease",
           "DeviceUnreachable", "DivergenceWatchdog", "GangSupervisor",
           "GradScaler", "HealthWatchdog", "InjectedFailure",
           "InjectedFault", "LeaseHeld", "NumericsGuard", "PeerLost",
           "PreemptionGuard", "RankHeartbeat", "RetryPolicy",
           "TrainingDiverged", "TrainingPreempted", "TransientError",
           "at_step_boundary", "atomic_write", "chaos_point", "configure",
           "corrupt_point", "exclusive_create", "exit_status", "numerics",
           "parse_spec", "preemption_requested", "reset", "retry_call",
           "run_supervised", "run_with_deadline", "trip_count"]
