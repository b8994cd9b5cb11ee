"""Thread-safe metrics registry: Counter / Gauge / Histogram with labels.

Copied from mxnet_tpu/observability/registry.py, reduced to what the
decode engine and scheduler record: labelled samples and their read-back
(histogram counts, sums and percentiles). Names follow the JAX package's
scheme (dotted lowercase with a unit suffix, e.g.
`serving.decode.ttft`), so the two packages report under the same
names. Snapshots, Prometheus
and JSONL export, exemplars and the label-cardinality bound are not
ported yet.
"""
from __future__ import annotations

import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "counter", "gauge", "histogram", "DEFAULT_BUCKETS"]

_INF = float("inf")

# latency-oriented default: 0.5ms .. 60s, roughly x2.5 per step
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, _INF)


def _label_key(labels):
    """Canonical hashable key for a label kwargs dict."""
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class _Metric:
    """Common labeled-sample storage; subclasses define the sample type."""

    kind = "untyped"

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._values = {}

    def reset(self):
        with self._lock:
            self._values.clear()


class Counter(_Metric):
    """Monotonically increasing value."""

    kind = "counter"

    def inc(self, n=1, **labels):
        if n < 0:
            raise ValueError("Counter %r cannot decrease (got %r)"
                             % (self.name, n))
        with self._lock:
            key = _label_key(labels)
            self._values[key] = self._values.get(key, 0) + n

    def get(self, **labels):
        with self._lock:
            return self._values.get(_label_key(labels), 0)


class Gauge(_Metric):
    """Point-in-time value that can move both ways (queue depths)."""

    kind = "gauge"

    def set(self, value, **labels):
        with self._lock:
            self._values[_label_key(labels)] = value

    def get(self, **labels):
        with self._lock:
            return self._values.get(_label_key(labels), 0)


class Histogram(_Metric):
    """Cumulative-bucket histogram (Prometheus semantics: each bucket
    counts observations <= its upper bound; +Inf bucket == count)."""

    kind = "histogram"

    def __init__(self, name, help="", buckets=DEFAULT_BUCKETS):
        super().__init__(name, help)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds or bounds[-1] != _INF:
            bounds = bounds + (_INF,)
        self.buckets = bounds

    def observe(self, value, **labels):
        value = float(value)
        with self._lock:
            key = _label_key(labels)
            cell = self._values.get(key)
            if cell is None:
                cell = self._values[key] = {
                    "counts": [0] * len(self.buckets), "sum": 0.0,
                    "count": 0}
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    cell["counts"][i] += 1
                    break
            cell["sum"] += value
            cell["count"] += 1

    def sum(self, **labels):
        with self._lock:
            cell = self._values.get(_label_key(labels))
            return cell["sum"] if cell else 0.0

    def count(self, **labels):
        with self._lock:
            cell = self._values.get(_label_key(labels))
            return cell["count"] if cell else 0

    def percentile(self, q, **labels):
        """Bucket-interpolated quantile estimate, q in [0, 1]."""
        with self._lock:
            cell = self._values.get(_label_key(labels))
            if not cell or not cell["count"]:
                return 0.0
            counts = list(cell["counts"])
            total = cell["count"]
        rank = q * total
        cum = 0
        lo = 0.0
        for i, n in enumerate(counts):
            hi = self.buckets[i]
            if cum + n >= rank:
                if hi == _INF:
                    return lo
                if n == 0:
                    return hi
                return lo + (hi - lo) * (rank - cum) / n
            cum += n
            if hi != _INF:
                lo = hi
        return lo


class MetricsRegistry:
    """Name -> metric table. `counter`/`gauge`/`histogram` are
    get-or-create (idempotent at module import sites); re-registering a
    name as a different kind is an error."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}

    def _get_or_create(self, cls, name, help, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help=help, **kwargs)
            elif not isinstance(m, cls):
                raise ValueError(
                    "metric %r already registered as %s, requested %s"
                    % (name, m.kind, cls.kind))
            return m

    def counter(self, name, help=""):
        return self._get_or_create(Counter, name, help)

    def gauge(self, name, help=""):
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name, help="", buckets=DEFAULT_BUCKETS):
        return self._get_or_create(Histogram, name, help, buckets=buckets)

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def metrics(self):
        with self._lock:
            return [self._metrics[k] for k in sorted(self._metrics)]

    def reset(self):
        """Zero every metric's samples (registrations survive)."""
        for m in self.metrics():
            m.reset()


#: Process-wide default registry; module-level helpers bind to it.
REGISTRY = MetricsRegistry()


def counter(name, help=""):
    return REGISTRY.counter(name, help)


def gauge(name, help=""):
    return REGISTRY.gauge(name, help)


def histogram(name, help="", buckets=DEFAULT_BUCKETS):
    return REGISTRY.histogram(name, help, buckets=buckets)
