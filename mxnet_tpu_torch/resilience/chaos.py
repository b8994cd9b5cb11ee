"""Seeded, env-driven fault injection (counterpart of
mxnet_tpu/resilience/chaos.py: `parse_spec` :116, `_Site` :146,
`_rank_spec` :196, `configure` :213, `reset` :236, `chaos_point` :257,
`corrupt_point` :283, `trip_count` :338).

Spec grammar (``MXTPU_CHAOS``)::

    site:field=value,field=value[;site2:...]

    MXTPU_CHAOS="checkpoint.save:p=0.5,kind=raise"

Fields per site: ``p`` the probability a draw trips the fault (default
1.0); ``kind`` ``raise`` (`InjectedFault`, a `TransientError` that retry
policies absorb), ``fatal`` (`InjectedFailure`, never retried),
``sleep``/``hang`` (sleep ``secs``, default 0.1 and 3600), ``kill``
(SIGKILL this process: no cleanup, what a preempted machine looks like
to the gang), ``nan`` (one seeded element of the array at a
`corrupt_point` set to NaN: the numerics guard's skip proof) or
``bitflip`` (one seeded bit of one seeded element flipped: the silent
data corruption drill); ``n`` stop after n faults; ``after`` skip the
first `after` draws. A site name ending in ``*`` prefix-matches. Draws
are deterministic: each site has its own `random.Random` seeded from
``MXTPU_CHAOS_SEED`` (default 0) and the site name, as in the JAX
package, so one spec and seed trip the same draws, and corrupt the same
element and the same bit, in both packages.

A rank of a gang merges ``MXTPU_CHAOS_RANK_<rank>`` (its rank from
``JAX_PROCESS_ID`` or ``DMLC_WORKER_ID``) into the spec, its entries
winning on a site, so one environment can arm one rank alone; a
`GangSupervisor` strips these from every relaunched generation.

Sites wired in the port: ``checkpoint.save`` (before a checkpoint's data
is written; retried), ``checkpoint.commit`` (after every rank's data,
before the commit barrier and manifest: a rank killed there leaves a torn
step), ``worker.kill`` (every training step boundary,
`resilience.preempt.at_step_boundary`: ``kind=kill`` kills a rank
mid-run), ``dist.init`` (each rendezvous attempt), ``kvstore.push``
(each bucket of the distributed exchange, before its collective), the
array sites ``grad.post`` (each gradient flat entering the fused update)
and ``weight.post`` (the weights it wrote), and serving's
``serving.infer``, ``engine.dispatch``, ``serving.replica<k>.dispatch``,
``serving.decode``, ``gateway.admit``, ``lease.acquire`` and
``memory.oom``, as in the JAX package. Each trip counts in
``chaos.injected{site}``. A site is one dict lookup when nothing is
armed.
"""
from __future__ import annotations

import os
import random
import signal
import threading
import time

import torch

from ..base import MXNetError, getenv
from ..observability import registry as _obs
from .retry import TransientError

__all__ = ["InjectedFailure", "InjectedFault", "chaos_point", "configure",
           "corrupt_point", "corrupt_tensors", "parse_spec", "reset",
           "trip_count"]

INJECTED = _obs.counter("chaos.injected",
                        "Faults injected, by site (label site)")


class InjectedFault(TransientError):
    """A chaos-injected transient fault (kind=raise): retry layers are
    expected to absorb it."""


class InjectedFailure(MXNetError):
    """A chaos-injected fatal fault (kind=fatal): never retried."""


_FIELDS = {"p": float, "secs": float, "n": int, "after": int, "kind": str}
_KINDS = ("raise", "fatal", "sleep", "hang", "kill", "nan", "bitflip")
# kinds that corrupt an array at a corrupt_point instead of raising
_CORRUPT_KINDS = ("nan", "bitflip")
_KILL = object()


def parse_spec(spec):
    """A ``MXTPU_CHAOS`` string as {site: fields}. An unknown field or
    kind raises naming it: a mistyped spec that injects nothing would be
    a failure of its own."""
    out = {}
    for part in filter(None, (p.strip() for p in (spec or "").split(";"))):
        site, _, rest = part.partition(":")
        site = site.strip()
        if not site:
            raise MXNetError("MXTPU_CHAOS entry %r lacks a site name" % part)
        fields = {}
        for field in filter(None, (f.strip() for f in rest.split(","))):
            key, eq, val = field.partition("=")
            key = key.strip()
            if key not in _FIELDS or not eq:
                raise MXNetError(
                    "MXTPU_CHAOS site %r: unknown field %r (valid: %s)"
                    % (site, field, ", ".join(sorted(_FIELDS))))
            fields[key] = _FIELDS[key](val.strip())
        kind = fields.get("kind", "raise")
        if kind not in _KINDS:
            raise MXNetError("MXTPU_CHAOS site %r: unknown kind %r (valid: "
                             "%s)" % (site, kind, ", ".join(_KINDS)))
        out[site] = fields
    return out


class _Site:
    """One armed site: its seeded draws and trips."""

    def __init__(self, name, fields, seed):
        self.name = name
        self.p = float(fields.get("p", 1.0))
        self.kind = fields.get("kind", "raise")
        self.secs = float(fields.get(
            "secs", 3600.0 if self.kind == "hang" else 0.1))
        self.n = fields.get("n")
        self.after = int(fields.get("after", 0))
        self.rng = random.Random("%s:%s" % (seed, name))
        self.draws = 0
        self.trips = 0

    def decide(self, at_site):
        """Advance the draws: None (no fault), seconds to sleep, `_KILL`
        or an exception to raise. The caller acts after the lock."""
        self.draws += 1
        if self.draws <= self.after:
            return None
        if self.n is not None and self.trips >= self.n:
            return None
        if self.rng.random() >= self.p:
            return None
        self.trips += 1
        INJECTED.inc(site=at_site)
        if self.kind in ("sleep", "hang"):
            return self.secs
        if self.kind == "kill":
            return _KILL
        cls = InjectedFailure if self.kind == "fatal" else InjectedFault
        return cls("[chaos] injected %s fault at %r (trip %d, draw %d, spec "
                   "site %r)" % (self.kind, at_site, self.trips, self.draws,
                                 self.name))


_lock = threading.Lock()
# exact None: (re)read MXTPU_CHAOS at the next chaos_point
_state = {"exact": None, "prefix": []}


def _rank_spec():
    """This rank's ``MXTPU_CHAOS_RANK_<r>`` spec, or ""."""
    rank = os.environ.get("JAX_PROCESS_ID") or \
        os.environ.get("DMLC_WORKER_ID")
    try:
        rank = int(rank)
    except (TypeError, ValueError):
        return ""
    return os.environ.get("MXTPU_CHAOS_RANK_%d" % rank, "")


def configure(spec=None, seed=None):
    """Arm the injector: from `spec`, or (None) from ``MXTPU_CHAOS`` and
    this rank's ``MXTPU_CHAOS_RANK_<r>``. An empty spec disarms."""
    if spec is None:
        spec = ";".join(filter(None, [os.environ.get("MXTPU_CHAOS", ""),
                                      _rank_spec()]))
    if seed is None:
        seed = getenv("MXTPU_CHAOS_SEED", 0)
    parsed = parse_spec(spec)
    with _lock:
        _state["exact"] = {}
        _state["prefix"] = []
        for name, fields in parsed.items():
            site = _Site(name, fields, seed)
            if name.endswith("*"):
                _state["prefix"].append((name[:-1], site))
            else:
                _state["exact"][name] = site


def reset():
    """Disarm and forget; the next chaos_point re-reads the env."""
    with _lock:
        _state["exact"] = None
        _state["prefix"] = []


def trip_count(site):
    """How many times `site` has actually tripped."""
    sp = _lookup(site)
    return 0 if sp is None else sp.trips


def _lookup(site):
    exact = _state["exact"]
    if exact is None:
        configure()
        exact = _state["exact"]
    sp = exact.get(site)
    if sp is not None:
        return sp
    for prefix, psite in _state["prefix"]:
        if site.startswith(prefix):
            return psite
    return None


def chaos_point(site):
    """A named injection site: nothing unless a spec arms it; then a
    seeded draw may raise, sleep or kill the process."""
    sp = _lookup(site)
    if sp is None:
        return
    with _lock:
        verdict = sp.decide(site)
    if verdict is None:
        return
    if verdict is _KILL:
        os.kill(os.getpid(), signal.SIGKILL)
        return
    if isinstance(verdict, float):
        time.sleep(verdict)
        return
    raise verdict



def _draw_corruption(site):
    """The armed corrupt site's (kind, pick, bitpick) for this draw, or
    None. The two picks follow the trip decision on the site's own
    generator, under the lock, as in the JAX package."""
    sp = _lookup(site)
    if sp is None:
        return None
    if sp.kind not in _CORRUPT_KINDS:
        chaos_point(site)
        return None
    with _lock:
        verdict = sp.decide(site)
        if verdict is None:
            return None
        return sp.kind, sp.rng.random(), sp.rng.random()


def _corrupt_flat(flat, kind, pick, bitpick):
    """Corrupt one element of the 1-d contiguous tensor `flat` in place:
    the element at ``int(pick * size)``; for a bitflip, bit
    ``int(bitpick * bits)`` of it (little-endian byte order, as numpy's
    view of the same bytes)."""
    size = flat.numel()
    idx = min(int(pick * size), size - 1)
    if kind == "nan":
        if flat.dtype.is_floating_point:
            flat[idx] = float("nan")
        else:
            flat[idx] = torch.iinfo(flat.dtype).max
        return
    item = flat.element_size()
    nbits = 8 * item
    bit = min(int(bitpick * nbits), nbits - 1)
    raw = flat.view(torch.uint8)
    byte = idx * item + bit // 8
    raw[byte] = raw[byte] ^ (1 << (bit % 8))


def corrupt_point(site, array):
    """A named array-corruption site. Returns `array` unchanged (one dict
    lookup) unless the site is armed with a corrupt kind and the seeded
    draw trips; then a corrupted copy: ``kind=nan`` sets one seeded
    element to NaN, ``kind=bitflip`` flips one seeded bit of one seeded
    element. The element and the bit come from the site's generator as
    in the JAX package, so one spec and seed corrupt the same ones.
    `array` is a tensor (on any device) or a numpy array; the copy is of
    the same kind. Other kinds armed here act as `chaos_point`."""
    drawn = _draw_corruption(site)
    if drawn is None:
        return array
    if isinstance(array, torch.Tensor):
        out = array.detach().clone().contiguous()
        if out.numel():
            _corrupt_flat(out.view(-1), *drawn)
        return out
    import numpy as np
    host = np.array(array, copy=True)
    if host.size:
        _corrupt_flat(torch.from_numpy(host.reshape(-1)), *drawn)
    return host


def corrupt_tensors(site, tensors, inplace=True):
    """`corrupt_point` over a list of tensors read as ONE flat, their
    concatenation (the JAX package's packed flat): one draw, one element.
    Returns None when nothing tripped, else ``(i, t)``: the position of
    the tensor holding the element, and that tensor corrupted, in place
    (`inplace`) or as a copy the caller swaps in."""
    live = [(i, t) for i, t in enumerate(tensors) if t.numel()]
    if not live:
        return None
    drawn = _draw_corruption(site)
    if drawn is None:
        return None
    kind, pick, bitpick = drawn
    total = sum(t.numel() for _, t in live)
    idx = min(int(pick * total), total - 1)
    for i, t in live:
        if idx < t.numel():
            break
        idx -= t.numel()
    if not inplace:
        t = t.detach().clone()
    # pick' = (idx + 0.5) / n lands `_corrupt_flat` on element idx of t
    _corrupt_flat(t.detach().view(-1), kind, (idx + 0.5) / t.numel(),
                  bitpick)
    return i, t
