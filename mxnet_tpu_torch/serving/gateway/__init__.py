"""Serving front door & model multiplexing (counterpart of
mxnet_tpu/serving/gateway/, docs/serving.md).

A threaded stdlib HTTP server with priority-class, deadline-aware
admission (`frontdoor.Gateway`) fronting a device-byte-budgeted,
LRU-evicting model registry (`registry.ModelRegistry`). One process
multiplexes N models under one measured device-memory budget; evicted
models reload transparently by calling their builders again.

Env knobs: ``MXTPU_GATEWAY_PORT``, ``MXTPU_GATEWAY_HBM_BUDGET_MB``,
``MXTPU_GATEWAY_MAX_MODELS``, ``MXTPU_GATEWAY_CONCURRENCY``,
``MXTPU_GATEWAY_QUEUE_DEPTH``. Chaos site: ``gateway.admit``.
"""
from .registry import ModelRegistry
from .frontdoor import Gateway, PRIORITY_CLASSES

__all__ = ["ModelRegistry", "Gateway", "PRIORITY_CLASSES"]
