"""Thread-safe metrics registry: Counter / Gauge / Histogram with labels
(a copy of mxnet_tpu/observability/registry.py without its snapshot and
JSONL export, so this package never imports the JAX one).

The single sink for every runtime counter of the package: the decode
engine and scheduler, the serving batcher, servers and gateway, the
health plane, the memory ledger and goodput all land here, in one
namespace, exportable in Prometheus text format (`to_prometheus`, what
``/metricsz`` serves).

Naming scheme: dotted lowercase components with a unit suffix —
`serving.decode.ttft`, `io.batch_wait.seconds`. Prometheus export maps
dots to underscores and prefixes `mxtpu_` (counters additionally get
`_total`), the JAX package's names, so the backend-neutral tools read
either package's output. A metric holds at most
``MXTPU_METRIC_MAX_LABELS`` labelsets; later ones collapse into an
``overflow="true"`` series. Histograms keep the worst
``MXTPU_TRACE_EXEMPLARS`` trace ids per labelset.
"""
from __future__ import annotations

import os
import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "REGISTRY",
           "counter", "gauge", "histogram", "DEFAULT_BUCKETS",
           "OVERFLOW_KEY"]

_INF = float("inf")

#: the collapsed labelset unbounded-cardinality writes land in once a
#: metric holds MXTPU_METRIC_MAX_LABELS distinct labelsets — tracing
#: adds per-model/per-class/per-trace labels, and a label leak must
#: cost one extra series + a counter bump, never unbounded registry
#: memory
OVERFLOW_KEY = (("overflow", "true"),)

#: name of the drop counter; exempt from its own collapse (bounded by
#: the number of registered metrics, and collapsing it would recurse)
_DROPPED_NAME = "observability.labels.dropped"


def _max_labels():
    """MXTPU_METRIC_MAX_LABELS, re-read per new labelset (a dict
    lookup; only paid when a label combination is seen first)."""
    try:
        return int(os.environ.get("MXTPU_METRIC_MAX_LABELS") or 256)
    except ValueError:
        return 256


def _exemplar_k():
    """Worst-K exemplars retained per histogram labelset."""
    try:
        return int(os.environ.get("MXTPU_TRACE_EXEMPLARS") or 4)
    except ValueError:
        return 4

# latency-oriented default: 0.5ms .. 60s, roughly x2.5 per step
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, _INF)


def _label_key(labels):
    """Canonical hashable key for a label kwargs dict."""
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _prom_name(name):
    san = name.replace(".", "_").replace("-", "_").replace("/", "_")
    return san if san.startswith("mxtpu_") else "mxtpu_" + san


def _prom_label_value(v):
    """Prometheus exposition escaping: backslash, quote, newline. An
    unescaped user-supplied label (e.g. a symbol name feeding
    cachedop.jit.builds{op=...}) would otherwise corrupt the whole
    scrape payload."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _prom_labels(key):
    if not key:
        return ""
    return "{%s}" % ",".join('%s="%s"' % (k, _prom_label_value(v))
                             for k, v in key)


class _Metric:
    """Common labeled-sample storage; subclasses define the sample type."""

    kind = "untyped"

    def __init__(self, name, help=""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._values = {}

    def _key(self, labels):
        """Canonical key for a WRITE, cardinality-bounded: a labelset
        past `MXTPU_METRIC_MAX_LABELS` distinct combinations collapses
        into the shared ``overflow="true"`` series and bumps
        `observability.labels.dropped` (label ``metric``). Caller
        holds self._lock. Reads keep the exact `_label_key` — a
        collapsed series is still readable via
        ``get(overflow="true")``."""
        key = _label_key(labels)
        if not key or key in self._values or key == OVERFLOW_KEY \
                or self.name == _DROPPED_NAME:
            return key
        if len(self._values) >= _max_labels():
            # bump outside our lock discipline concern: the dropped
            # counter is a DIFFERENT metric object (never collapses,
            # never calls back into another metric), so metric-lock →
            # dropped-lock is the only ordering that occurs
            _labels_dropped().inc(metric=self.name)
            return OVERFLOW_KEY
        return key

    def labelsets(self):
        with self._lock:
            return list(self._values.keys())

    def reset(self):
        with self._lock:
            self._values.clear()


class Counter(_Metric):
    """Monotonically increasing value (float-valued: compile *seconds*
    accumulate here too, not just event counts)."""

    kind = "counter"

    def inc(self, n=1, **labels):
        if n < 0:
            raise ValueError("Counter %r cannot decrease (got %r)"
                             % (self.name, n))
        with self._lock:
            key = self._key(labels)
            self._values[key] = self._values.get(key, 0) + n

    def get(self, **labels):
        with self._lock:
            return self._values.get(_label_key(labels), 0)

    def total(self):
        """Sum across every labelset."""
        with self._lock:
            return sum(self._values.values())


class Gauge(_Metric):
    """Point-in-time value that can move both ways (queue depths,
    samples/sec)."""

    kind = "gauge"

    def set(self, value, **labels):
        with self._lock:
            key = self._key(labels)
            self._values[key] = value

    def inc(self, n=1, **labels):
        with self._lock:
            key = self._key(labels)
            self._values[key] = self._values.get(key, 0) + n

    def dec(self, n=1, **labels):
        self.inc(-n, **labels)

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

    def _cell(self, key):
        cell = self._values.get(key)
        if cell is None:
            cell = self._values[key] = {
                "counts": [0] * len(self.buckets), "sum": 0.0,
                "count": 0, "exemplars": []}
        return cell

    def observe(self, value, exemplar=None, **labels):
        """Record one observation. `exemplar` (a trace id, typically)
        tags the sample: each labelset retains the worst
        `MXTPU_TRACE_EXEMPLARS` (value, exemplar) pairs, so a p99
        breach can name a concrete traceable request instead of a bare
        percentile (docs/observability.md "Exemplars")."""
        value = float(value)
        with self._lock:
            key = self._key(labels)
            cell = self._cell(key)
            for i, bound in enumerate(self.buckets):
                if value <= bound:
                    cell["counts"][i] += 1
                    break
            cell["sum"] += value
            cell["count"] += 1
            if exemplar is not None:
                worst = cell.get("exemplars")
                if worst is None:
                    worst = cell["exemplars"] = []
                worst.append((value, str(exemplar)))
                worst.sort(key=lambda p: -p[0])
                del worst[_exemplar_k():]

    def exemplars(self, **labels):
        """Worst-K retained (value, exemplar) pairs, largest first."""
        with self._lock:
            cell = self._values.get(_label_key(labels))
            return list(cell.get("exemplars", ())) if cell else []

    def sum(self, **labels):
        with self._lock:
            cell = self._values.get(_label_key(labels))
            return cell["sum"] if cell else 0.0

    def count(self, **labels):
        with self._lock:
            cell = self._values.get(_label_key(labels))
            return cell["count"] if cell else 0

    def total_sum(self):
        with self._lock:
            return sum(c["sum"] for c in self._values.values())

    def total_count(self):
        with self._lock:
            return sum(c["count"] for c in self._values.values())

    def percentile(self, q, **labels):
        """Bucket-interpolated quantile estimate in [0, 1] (exact
        quantiles of raw step records come from tools/telemetry_report.py
        over the JSONL stream; this is the scrape-time approximation)."""
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
                frac = (rank - cum) / n
                return lo + (hi - lo) * frac
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

    # -- export ---------------------------------------------------------
    def to_prometheus(self):
        """Prometheus text exposition format, ready for a scrape
        endpoint or a textfile-collector drop."""
        out = []
        for m in self.metrics():
            pname = _prom_name(m.name)
            if m.kind == "counter":
                pname += "_total"
            if m.help:
                out.append("# HELP %s %s" % (pname, m.help))
            out.append("# TYPE %s %s" % (pname, m.kind))
            for key in sorted(m.labelsets()):
                labels = dict(key)
                if m.kind == "histogram":
                    with m._lock:
                        cell = m._values.get(key)
                        if cell is None:  # reset() raced the snapshot
                            continue
                        counts = list(cell["counts"])
                        hsum, hcount = cell["sum"], cell["count"]
                    cum = 0
                    for i, bound in enumerate(m.buckets):
                        cum += counts[i]
                        le = "+Inf" if bound == _INF else repr(bound)
                        lk = key + (("le", le),)
                        out.append("%s_bucket%s %d"
                                   % (pname, _prom_labels(lk), cum))
                    out.append("%s_sum%s %g"
                               % (pname, _prom_labels(key), hsum))
                    out.append("%s_count%s %d"
                               % (pname, _prom_labels(key), hcount))
                else:
                    out.append("%s%s %g" % (pname, _prom_labels(key),
                                            m.get(**labels)))
        return "\n".join(out) + ("\n" if out else "")


#: Process-wide default registry; module-level helpers bind to it.
REGISTRY = MetricsRegistry()


def _labels_dropped():
    # literal name (== _DROPPED_NAME): tools/docs_drift.py audits
    # literal registrations against docs/observability.md
    return REGISTRY.counter(
        "observability.labels.dropped",
        "labelsets collapsed into the overflow series past "
        "MXTPU_METRIC_MAX_LABELS (label metric)")


def counter(name, help=""):
    return REGISTRY.counter(name, help)


def gauge(name, help=""):
    return REGISTRY.gauge(name, help)


def histogram(name, help="", buckets=DEFAULT_BUCKETS):
    return REGISTRY.histogram(name, help, buckets=buckets)
