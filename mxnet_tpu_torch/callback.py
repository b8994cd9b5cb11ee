"""Training callbacks: epoch checkpointing, metric logging, throughput
(counterpart of mxnet_tpu/callback.py, copied: that module imports no
jax).

API parity with the reference's callback module
(python/mxnet/callback.py: module_checkpoint, do_checkpoint,
log_train_metric, Speedometer, ProgressBar,
LogValidationMetricsCallback); the internals are organized around two
small helpers — `_every` for periodic gating and `_RateMeter` for
throughput windows — rather than the reference's open-coded state.
"""
from __future__ import annotations

import logging
import sys
import time

from .observability import registry as _obs

# scrapeable throughput (docs/observability.md): Speedometer's log lines
# were the only place samples/sec existed; now every report also lands
# in these metrics, labeled by the callback's metric window
_SPEED_GAUGE = _obs.gauge("train.samples_per_sec",
                          "Most recent Speedometer throughput reading")
_BATCH_SECONDS = _obs.histogram(
    "train.batch.seconds",
    "Per-batch latency averaged over each Speedometer window")


def _every(period):
    """True on epochs/batches 1·p, 2·p, ... (1-based)."""
    p = int(max(1, period))
    return lambda i: (i + 1) % p == 0


def _metric_pairs(param):
    """(name, value) pairs of the callback param's metric, or []."""
    metric = getattr(param, "eval_metric", None)
    return metric.get_name_value() if metric else []


class _RateMeter:
    """Samples/sec across reporting windows of batch callbacks.

    Call observe(count) once per batch: it arms on the first call,
    re-arms (without reporting) when the batch counter goes backwards
    — a new epoch — and returns a samples/sec figure exactly when a
    window boundary is crossed while armed."""

    def __init__(self, batch_size, window):
        self.batch_size = batch_size
        self.window = window
        self._t0 = None
        self._last = 0

    def observe(self, count):
        if count < self._last:
            self._t0 = None  # epoch rollover
        self._last = count
        if self._t0 is None:
            self._t0 = time.time()
            return None
        if count % self.window:
            return None
        dt = time.time() - self._t0
        self._t0 = time.time()
        return self.window * self.batch_size / max(dt, 1e-12)


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Epoch-end callback saving module state (reference: callback.py:27)."""
    due = _every(period)

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if due(iter_no):
            mod.save_checkpoint(prefix, iter_no + 1, save_optimizer_states)
    return _callback


def do_checkpoint(prefix, period=1):
    """Epoch-end callback saving symbol+params (reference: callback.py:55)."""
    due = _every(period)

    def _callback(iter_no, sym, arg, aux):
        if due(iter_no):
            from .model import save_checkpoint
            save_checkpoint(prefix, iter_no + 1, sym, arg, aux)
    return _callback


def log_train_metric(period, auto_reset=False):
    """Batch-end callback logging the training metric every `period`
    batches (reference: callback.py log_train_metric)."""
    p = int(max(1, period))

    def _callback(param):
        if param.nbatch % p:
            return
        for name, value in _metric_pairs(param):
            logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                         param.epoch, param.nbatch, name, value)
        if auto_reset and param.eval_metric is not None:
            param.eval_metric.reset()
    return _callback


class Speedometer:
    """Batch-end callback logging samples/sec (+ metrics) every
    `frequent` batches (reference: callback.py Speedometer)."""

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self._meter = _RateMeter(batch_size, frequent)

    def __call__(self, param):
        count = param.nbatch
        speed = self._meter.observe(count)
        if speed is None:
            return
        _SPEED_GAUGE.set(speed)
        if speed > 0:
            _BATCH_SECONDS.observe(self.batch_size / speed)
        pairs = _metric_pairs(param)
        if pairs:
            if self.auto_reset:
                param.eval_metric.reset()
            tail = "".join("\t%s=%f" % kv for kv in pairs)
            logging.info("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec%s",
                         param.epoch, count, speed, tail)
        else:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, count, speed)


class ProgressBar:
    """Batch-end ASCII progress bar (reference: callback.py ProgressBar)."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        frac = param.nbatch / float(self.total)
        filled = int(round(self.bar_len * frac))
        bar = ("=" * filled).ljust(self.bar_len, "-")
        sys.stdout.write("[%s] %d%%\r" % (bar, -(-100.0 * frac // 1)))


class LogValidationMetricsCallback:
    """Epoch-end callback logging validation metrics (reference:
    callback.py LogValidationMetricsCallback)."""

    def __call__(self, param):
        for name, value in _metric_pairs(param):
            logging.info("Epoch[%d] Validation-%s=%f",
                         param.epoch, name, value)
