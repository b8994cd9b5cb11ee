"""Process-wide resilience counters (counterpart of
mxnet_tpu/resilience/metrics.py): `bump`, `get` and `reset_counters` over
one labelled counter of the metrics registry, ``resilience.events``
(label ``event=<name>``).

The record reader counts corrupt and torn records here as
``io.bad_records``, the record iterator its skipped records too, so they
show in the same export as every other runtime metric.
"""
from __future__ import annotations

from ..observability.registry import counter as _counter

__all__ = ["bump", "get", "reset_counters"]

_events = _counter("resilience.events",
                   "Resilience events: chaos injections, retry attempts, "
                   "skipped corrupt records")


def bump(name, n=1):
    _events.inc(n, event=name)


def get(name):
    return _events.get(event=name)


def reset_counters():
    _events.reset()
