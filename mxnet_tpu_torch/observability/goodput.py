"""Goodput accounting: per-program FLOP costs (counterpart of
mxnet_tpu/observability/goodput.py).

Per-program costs are registered once — `record_cost(name, flops=...)`
or, where the port can run the program, `count_flops(fn, *args)`, which
counts what one call computes with `torch.utils.flop_counter.
FlopCounterMode` — and every dispatch bumps the process
``goodput.flops`` counter by its program's cost (`note_dispatch`). The
per-step MFU is derived from that counter by `StepTimer.end_step`
(`mfu_value`, also the ``goodput.mfu`` gauge); ``/debugz`` shows the costs and the
peak it will divide by: ``MXTPU_PEAK_FLOPS`` when the operator knows the
card, else the H100 SXM's dense bf16 rate on a card, or a deliberately
modest CPU figure. Gated by the same ``MXTPU_MEMLEDGER`` switch as the
memory ledger (one observability plane, one A/B knob).
"""
from __future__ import annotations

import os
import threading

import torch

from .registry import counter, gauge

__all__ = ["enabled", "peak_flops", "record_cost", "cost", "count_flops",
           "note_dispatch", "costs_snapshot", "mfu_value"]

FLOPS = counter("goodput.flops",
                "model FLOPs dispatched (per-program costs counted by "
                "FlopCounterMode, analytic where a call cannot run)")
MFU = gauge("goodput.mfu",
            "model FLOPs utilization of the last step (label source)")
DISPATCHES = counter("goodput.dispatches",
                     "dispatches that charged the goodput FLOP counter")

#: fallback peak-FLOPs table when MXTPU_PEAK_FLOPS is unset: the H100
#: SXM's dense bf16 tensor-core rate, and a deliberately modest CPU
#: figure (≈ a few AVX cores)
_PLATFORM_PEAK = {"gpu": 9.89e14, "cpu": 5.0e10}

_lock = threading.Lock()
_costs = {}   # program name -> {"flops": f, "bytes": b, "source": s}
_peak_cache = {"key": None, "value": None}


def enabled():
    """Same gate as the HBM ledger (memory.enabled): one knob turns
    the whole memory/goodput plane off for the overhead A/B."""
    return os.environ.get("MXTPU_MEMLEDGER", "1") not in ("0", "false")


def peak_flops():
    """Peak device FLOP/s for the MFU denominator: MXTPU_PEAK_FLOPS
    wins, else the per-platform default. Cached per env value."""
    env = os.environ.get("MXTPU_PEAK_FLOPS")
    if _peak_cache["key"] == env and _peak_cache["value"] is not None:
        return _peak_cache["value"]
    value = None
    if env:
        try:
            value = float(env)
        except ValueError:
            value = None
    if value is None:
        platform = "gpu" if (torch.cuda.is_available()
                             and torch.cuda.is_initialized()) else "cpu"
        value = _PLATFORM_PEAK[platform]
    _peak_cache["key"], _peak_cache["value"] = env, value
    return value


def count_flops(fn, *args, **kwargs):
    """(result, FLOPs) of one call of `fn`, the FLOPs counted by
    `torch.utils.flop_counter.FlopCounterMode` (matmuls, convolutions
    and attention; elementwise work counts zero, as in XLA's
    cost_analysis of the JAX package). The FLOPs are None when the
    counter cannot run."""
    try:
        from torch.utils.flop_counter import FlopCounterMode
    except ImportError:
        return fn(*args, **kwargs), None
    counter_ = FlopCounterMode(display=False)
    with counter_:
        out = fn(*args, **kwargs)
    return out, float(counter_.get_total_flops())


def record_cost(name, flops=None, nbytes=None, measured=False):
    """Register the per-dispatch cost of one program: `flops` counted
    from a run (`measured=True`, `count_flops`) or an analytic estimate.
    Re-registration with an analytic estimate never downgrades a
    measured entry. Returns the stored cost dict or None."""
    if not enabled() or flops is None:
        return None
    name = str(name)
    source = "measured" if measured else "analytic"
    entry = {"flops": float(flops),
             "bytes": float(nbytes) if nbytes is not None else None,
             "source": source}
    with _lock:
        old = _costs.get(name)
        if old is not None and old["source"] == "measured" \
                and source == "analytic":
            return old
        _costs[name] = entry
        if len(_costs) > 256:    # program-churn bound
            _costs.clear()
            _costs[name] = entry
    return entry


def cost(name):
    with _lock:
        return _costs.get(str(name))


def note_dispatch(name, n=1):
    """Charge one (or n) dispatches of a registered program to the
    FLOP counter — the per-step MFU numerator. Unregistered programs
    charge nothing (the gauge stays honest rather than guessing)."""
    if not enabled():
        return 0.0
    c = cost(name)
    if c is None or not c["flops"]:
        return 0.0
    total = c["flops"] * n
    FLOPS.inc(total)
    DISPATCHES.inc(n)
    return total


def mfu_value(step_flops, step_time, source=None):
    """`step_flops` over the step's peak-FLOP envelope, clamped to [0, 1];
    also sets the ``goodput.mfu`` gauge. None on degenerate input."""
    if not step_flops or not step_time or step_time <= 0:
        return None
    peak = peak_flops()
    if not peak or peak <= 0:
        return None
    mfu = min(1.0, float(step_flops) / (float(step_time) * peak))
    if source is not None:
        MFU.set(mfu, source=source)
    else:
        MFU.set(mfu)
    return mfu


def costs_snapshot():
    """{program: cost dict} for /debugz."""
    with _lock:
        return {n: dict(v) for n, v in _costs.items()}


def _reset_for_tests():
    with _lock:
        _costs.clear()
    _peak_cache["key"] = _peak_cache["value"] = None
