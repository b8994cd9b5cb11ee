"""Device memory ledger: live device-byte attribution + OOM forensics
(counterpart of mxnet_tpu/observability/memory.py; the names, cells and
record schema are the JAX package's, "hbm" included, so the backend-
neutral tools read either package).

The observability plane answers *how long* everything takes; this
module answers *where the bytes go*. Every allocation-owning subsystem
registers its live device buffers under a ``(model, subsystem, kind)``
key — serving params/aux, per-replica copies, decode KV caches — as
the tensors' own sizes (`nbytes`), on the card and on the CPU alike.
What the CUDA caching allocator holds beyond them (activations,
workspace, the allocator's cache) is read from
``torch.cuda.memory_stats`` (`device_stats`, the ``device`` section of
``/debugz``); `headroom_bytes` is the card's free memory plus what the
allocator holds unused. The ledger is the single source behind four
surfaces:

- ``memory.hbm.*`` gauges on the process registry (Prometheus);
- the ``memory`` section of ``/debugz`` (httpz.debug_snapshot);
- a ``source="memory"`` JSONL timeline on the MXTPU_TELEMETRY stream
  (one record per resident-set change, excluded from headline
  percentiles like every non-training source);
- OOM forensics: `oom_guard(site)` wraps dispatch/freeze sites, and a
  ``torch.cuda.OutOfMemoryError`` (or any "out of memory" error)
  escaping one dumps the ranked ledger — top consumers, headroom —
  before re-raising typed (`HBMExhausted`). The chaos site
  ``memory.oom`` simulates the condition deterministically.

``MXTPU_MEMLEDGER=0`` turns the whole plane off (ledger writes, the
timeline, the chaos draw): the disabled path is one env read, which is
what an overhead A/B toggles. Accounting
writes happen at allocation/freeze/eviction granularity — never per
step or per request — so the enabled path is a dict write under one
lock at the same rate the buffers themselves change.
"""
from __future__ import annotations

import os
import sys
import threading
import time

import torch

from ..base import MXNetError
from .registry import counter, gauge

__all__ = ["HBMExhausted", "enabled", "nbytes", "set_bytes", "release",
           "total_bytes", "model_bytes", "snapshot", "top_consumers",
           "headroom_bytes", "oom_guard", "debug_section",
           "device_stats", "peak_bytes"]

#: live device bytes per (model, subsystem, kind) — the ledger's export
HBM_BYTES = gauge("memory.hbm.bytes",
                  "live device bytes attributed by the HBM ledger "
                  "(labels model, subsystem, kind)")
HBM_TOTAL = gauge("memory.hbm.total.bytes",
                  "total live device bytes across the ledger")
OOM_EVENTS = counter("memory.oom.events",
                     "RESOURCE_EXHAUSTED dispatches caught by an "
                     "oom_guard, forensics dumped (label site)")


class HBMExhausted(MXNetError):
    """A device allocation failed (CUDA out of memory) — re-raised
    typed after the ledger forensics dump. `.report` carries the same
    ranked dump as a dict (site, model, top consumers, headroom)."""

    def __init__(self, message, report=None):
        super().__init__(message)
        self.report = report or {}


_lock = threading.Lock()
_entries = {}     # (model, subsystem, kind) -> bytes
_peak = {"bytes": 0}

#: substrings that mark a device allocator failure in an error's text
#: (torch.cuda.OutOfMemoryError says "CUDA out of memory")
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "RESOURCE EXHAUSTED",
                "Out of memory", "out of memory")


def enabled():
    """MXTPU_MEMLEDGER gate, default ON; re-read per call so the
    bench A/B (and tests) can toggle without re-importing."""
    return os.environ.get("MXTPU_MEMLEDGER", "1") not in ("0", "false")


def nbytes(tree):
    """Total bytes of a tree (dicts, lists, tuples) of tensors (any leaf
    with an ``nbytes``); other leaves count zero."""
    total = 0
    stack = [tree]
    while stack:
        node = stack.pop()
        if node is None:
            continue
        if isinstance(node, dict):
            stack.extend(node.values())
        elif isinstance(node, (list, tuple)):
            stack.extend(node)
        else:
            n = getattr(node, "nbytes", None)
            if n is not None:
                total += int(n)
    return total


def _emit_timeline(event, model, subsystem, kind, nb, extra=None):
    from . import telemetry as _tel
    if not _tel.stream_enabled():
        return
    rec = {"ts": time.time(), "source": "memory", "event": event,
           "model": model, "subsystem": subsystem, "kind": kind,
           "bytes": int(nb), "total_bytes": total_bytes(),
           "step_time": 0.0}
    if extra:
        rec.update(extra)
    _tel.emit(rec)


def _set_total_locked():
    total = sum(_entries.values())
    HBM_TOTAL.set(total)
    if total > _peak["bytes"]:
        _peak["bytes"] = total
    return total


def set_bytes(model, subsystem, kind, nb):
    """Record the CURRENT live bytes for one (model, subsystem, kind)
    cell — an absolute set, not a delta, so re-freezing or re-measuring
    is idempotent. ``nb <= 0`` drops the cell. No-op when disabled."""
    if not enabled():
        return
    key = (str(model), str(subsystem), str(kind))
    nb = int(nb)
    with _lock:
        old = _entries.get(key)
        if nb <= 0:
            _entries.pop(key, None)
        else:
            _entries[key] = nb
        changed = old != (nb if nb > 0 else None)
        if changed:
            HBM_BYTES.set(max(nb, 0), model=key[0], subsystem=key[1],
                          kind=key[2])
            _set_total_locked()
    if changed:
        _emit_timeline("update" if nb > 0 else "release", *key, nb)


def release(model, subsystem=None, kind=None):
    """Drop every ledger cell matching the filter (an evicted/drained
    model's residency must read zero, not stale)."""
    if not enabled():
        return
    model = str(model)
    with _lock:
        victims = [k for k in _entries
                   if k[0] == model
                   and (subsystem is None or k[1] == subsystem)
                   and (kind is None or k[2] == kind)]
        for k in victims:
            _entries.pop(k, None)
            HBM_BYTES.set(0, model=k[0], subsystem=k[1], kind=k[2])
        if victims:
            _set_total_locked()
    for k in victims:
        _emit_timeline("release", *k, 0)


def total_bytes():
    with _lock:
        return sum(_entries.values())


def peak_bytes():
    """High-water mark of the ledger total since process start (or the
    last reset) — what perf_gate's --max-hbm-mb budgets."""
    with _lock:
        return max(_peak["bytes"], sum(_entries.values()))


def model_bytes(model):
    """Live ledger bytes attributed to one model across subsystems."""
    model = str(model)
    with _lock:
        return sum(v for k, v in _entries.items() if k[0] == model)


def top_consumers(k=3):
    """The k largest ledger cells, ranked: [(model, subsystem, kind,
    bytes)] — what an OOM dump names."""
    with _lock:
        cells = sorted(_entries.items(), key=lambda kv: -kv[1])
    return [(m, s, ki, b) for (m, s, ki), b in cells[:k]]


def snapshot():
    """One JSON-able dict of the whole ledger: totals, per-model
    breakdown, headroom. ``programs`` (JAX's per-program XLA working
    sets) stays empty: nothing compiles programs here."""
    with _lock:
        entries = dict(_entries)
        peak = _peak["bytes"]
    models = {}
    for (model, subsystem, kind), nb in entries.items():
        bucket = models.setdefault(model, {"total_bytes": 0, "by": {}})
        bucket["total_bytes"] += nb
        bucket["by"]["%s/%s" % (subsystem, kind)] = nb
    total = sum(v["total_bytes"] for v in models.values())
    return {"total_bytes": total,
            "peak_bytes": max(peak, total),
            "headroom_bytes": headroom_bytes(),
            "models": models,
            "programs": {}}


# -- the device's own accounting ------------------------------------------
def device_stats(device=None):
    """The CUDA caching allocator's view of one card: bytes allocated
    (live tensors), reserved (held by the allocator), their peaks, and
    the card's free and total bytes. None on the CPU, or before CUDA was
    initialized in this process (reading it must not initialize it)."""
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return None
    try:
        dev = torch.device("cuda") if device is None else torch.device(device)
        if dev.type != "cuda":
            return None
        st = torch.cuda.memory_stats(dev)
        free, total = torch.cuda.mem_get_info(dev)
    except Exception:   # noqa: BLE001 — a lost card must not break stats
        return None
    return {"allocated_bytes": int(st.get("allocated_bytes.all.current", 0)),
            "reserved_bytes": int(st.get("reserved_bytes.all.current", 0)),
            "peak_allocated_bytes": int(
                st.get("allocated_bytes.all.peak", 0)),
            "free_bytes": int(free), "total_bytes": int(total)}


def headroom_bytes():
    """Device memory still available: the card's free bytes plus what
    the caching allocator holds but no tensor uses, when CUDA runs in
    this process; else ``MXTPU_HBM_BYTES`` minus the ledger total; else
    None (the CPU has no device limit worth pretending about)."""
    st = device_stats()
    if st is not None:
        return st["free_bytes"] + st["reserved_bytes"] \
            - st["allocated_bytes"]
    env = os.environ.get("MXTPU_HBM_BYTES")
    if env:
        try:
            return int(float(env)) - total_bytes()
        except ValueError:
            return None
    return None


def debug_section():
    """The /debugz ``memory`` payload (httpz.debug_snapshot)."""
    snap = snapshot()
    snap["top"] = [{"model": m, "subsystem": s, "kind": k, "bytes": b}
                   for m, s, k, b in top_consumers(5)]
    snap["enabled"] = enabled()
    snap["device"] = device_stats()
    return snap


# -- OOM forensics -------------------------------------------------------
def _is_oom(err):
    text = str(err)
    return any(marker in text for marker in _OOM_MARKERS)


def _forensics(site, model, err):
    """Rank the ledger, dump it to stderr + the telemetry stream, and
    return the typed HBMExhausted to raise."""
    OOM_EVENTS.inc(site=site)
    top = top_consumers(3)
    report = {
        "site": site, "model": model, "error": str(err)[:500],
        "total_bytes": total_bytes(),
        "headroom_bytes": headroom_bytes(),
        "top_consumers": [{"model": m, "subsystem": s, "kind": k,
                           "bytes": b} for m, s, k, b in top],
    }
    lines = ["[memory] out of memory at %r (model=%s) — device "
             "ledger at failure:" % (site, model),
             "[memory]   ledger total: %.1f MiB, headroom: %s"
             % (report["total_bytes"] / 2**20,
                "%.1f MiB" % (report["headroom_bytes"] / 2**20)
                if report["headroom_bytes"] is not None else "unknown")]
    for i, (m, s, k, b) in enumerate(top):
        lines.append("[memory]   #%d %s %s/%s: %.1f MiB"
                     % (i + 1, m, s, k, b / 2**20))
    print("\n".join(lines), file=sys.stderr)
    _emit_timeline("oom", model or "", site, "oom", report["total_bytes"],
                   extra={"headroom_bytes": report["headroom_bytes"],
                          "top": report["top_consumers"]})
    return HBMExhausted(
        "device out of memory at %r (model=%s): top consumers %s — "
        "see the [memory] ledger dump above | %s"
        % (site, model,
           ", ".join("%s %s/%s %.1fMiB" % (m, s, k, b / 2**20)
                     for m, s, k, b in top) or "none recorded",
           str(err)[:200]), report=report)


class oom_guard:
    """Context manager for dispatch/freeze sites: an out-of-memory error
    escaping the body is dumped against the ledger and re-raised as
    `HBMExhausted`; everything else passes through untouched. The chaos
    site ``memory.oom`` (kind=raise) fires on entry and takes the same
    forensics path — the deterministic OOM drill."""

    __slots__ = ("site", "model")

    def __init__(self, site, model=None):
        self.site = site
        self.model = model

    def __enter__(self):
        if enabled():
            from ..resilience import chaos as _chaos
            try:
                _chaos.chaos_point("memory.oom")
            except (_chaos.InjectedFault, _chaos.InjectedFailure) as err:
                raise _forensics(
                    self.site, self.model,
                    RuntimeError("out of memory (injected): %s" % err)) \
                    from err
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is None or isinstance(exc, HBMExhausted):
            return False
        if exc_type is not None and issubclass(exc_type, Exception) \
                and _is_oom(exc):
            raise _forensics(self.site, self.model, exc) from exc
        return False


def _reset_for_tests():
    with _lock:
        _entries.clear()
        _peak["bytes"] = 0
    HBM_BYTES.reset()
    HBM_TOTAL.reset()
