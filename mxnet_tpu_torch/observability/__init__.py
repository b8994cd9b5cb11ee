"""Observability (counterpart of mxnet_tpu/observability/): the metrics
registry, the telemetry stream, spans and distributed traces, the device
memory ledger, goodput, and the ``/metricsz`` + ``/debugz`` endpoint
(`httpz`)."""
from . import registry
from .registry import REGISTRY, counter, gauge, histogram

__all__ = ["registry", "REGISTRY", "counter", "gauge", "histogram"]
