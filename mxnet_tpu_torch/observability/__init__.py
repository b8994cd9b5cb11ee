"""Observability (counterpart of mxnet_tpu/observability/): the metrics
registry."""
from . import registry
from .registry import REGISTRY, counter, gauge, histogram

__all__ = ["registry", "REGISTRY", "counter", "gauge", "histogram"]
