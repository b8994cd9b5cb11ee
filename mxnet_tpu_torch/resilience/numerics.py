"""Training numerics guard, its gate and its flag collector (counterpart of
mxnet_tpu/resilience/numerics.py; the loss scaler, divergence watchdog and
SDC replay are not ported yet).

`ShardedTrainer.step` skips an update whose gradients are not all finite,
leaving parameters, momentum and BatchNorm statistics as they were, and
records its verdict here as where="step", as does the fused exchange +
update step (`parallel.fused_step`, under `gluon.Trainer` and `Module`);
`parallel.FusedUpdater` (the staged path) skips each such group of its
update the same way and records one verdict per update as
where="update". The distributed store's bucketed exchange records one
verdict per bucket as where="exchange" (an anomaly, not a skip).
`step_many` runs its steps unguarded and records one verdict for the
window (where="window"): detection only, since a bad window's weights
were written. A verdict is a bool or a 0-d device tensor, appended
without a host read; the host reads each once, when `drain_flags`
resolves them all.

``MXTPU_NUMERICS=0`` turns the guard off (re-read per call).
"""
from __future__ import annotations

import threading

import torch

from ..base import getenv
from ..observability import registry as _obs

__all__ = ["drain_flags", "enabled", "record_flag"]

SKIPPED = _obs.counter(
    "numerics.skipped_steps",
    "Training steps skipped because their gradients were not finite")
ANOMALIES = _obs.counter(
    "numerics.anomalies",
    "Numeric anomalies observed (skipped steps and bad step_many windows)")

_lock = threading.Lock()
_flags = []          # [(verdict, where)]
_FLAG_CAP = 4096     # loops that never drain stay bounded
_carry = {"bad": 0, "total": 0, "skipped_steps": 0, "anomalies": 0}


def enabled():
    """MXTPU_NUMERICS gate, re-read per call (default on)."""
    return getenv("MXTPU_NUMERICS", True)


def _count(flag, where, acc):
    ok = bool(flag.item()) if isinstance(flag, torch.Tensor) else bool(flag)
    acc["total"] += 1
    if not ok:
        acc["bad"] += 1
        acc["anomalies"] += 1
        if where in ("step", "update"):
            acc["skipped_steps"] += 1


def record_flag(flag, where="step"):
    """Record one verdict (True = finite). Never reads the device."""
    with _lock:
        _flags.append((flag, where))
        if len(_flags) > _FLAG_CAP:
            _count(*_flags.pop(0), _carry)
    return flag


def drain_flags():
    """Resolve and clear every pending verdict. Returns ``bad`` /
    ``total`` (verdicts), ``skipped_steps`` (bad where="step" or
    "update": updates skipped with state preserved) and ``anomalies``
    (every bad verdict, windows included), and counts the last two in the
    registry."""
    with _lock:
        pending, _flags[:] = list(_flags), []
        acc = dict(_carry)
        _carry.update(bad=0, total=0, skipped_steps=0, anomalies=0)
    for flag, where in pending:
        _count(flag, where, acc)
    if acc["skipped_steps"]:
        SKIPPED.inc(acc["skipped_steps"])
    if acc["anomalies"]:
        ANOMALIES.inc(acc["anomalies"])
    return acc
