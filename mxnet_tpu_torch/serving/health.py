"""Typed serving failures (counterpart of mxnet_tpu/serving/health.py).

Only the error types are ported so far; the watchdog-bounded dispatch,
replica quarantine and canary probes of the JAX package come with a
later slice.
"""
from __future__ import annotations

from ..context import DeviceUnreachable
from .batcher import ServerClosed

__all__ = ["DeviceUnreachable", "SchedulerCrashed"]


class SchedulerCrashed(ServerClosed):
    """A decode scheduler loop died on a non-request-scoped error; its
    queued and in-flight requests were rejected with this (never left
    to hang), and new submits are refused. `server` names the
    scheduler."""
