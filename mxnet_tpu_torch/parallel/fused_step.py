"""The fused gradient exchange + update step behind `gluon.Trainer` and
`Module.update` (counterpart of mxnet_tpu/parallel/fused_step.py:
`enabled` :107, `FusedTrainStep` :153, `run` :189, `flush_state` :285,
`drop_state` :306, `_plan_lanes` :317, `_pack` :337, `_unpack` :573,
`_exchange_plan` :611, `eligible` :631, `try_step` :651).

The JAX package compiles exchange and update into one donated program.
The port's analog runs them back to back on persistent buffers, with no
host work between them:

- the gradients are copied into flats laid out by the exchange's own
  `GradBucketer` plan (the distributed store's, ``MXTPU_BUCKET_MB``;
  without one, one flat per dtype), allocated once per layout;
- at ``nproc > 1`` one ``all_reduce`` per flat, all started before the
  first is waited on; none at one process;
- the all-finite verdict over the flats (`finite_all`) is a device flag
  that gates the update in-stream: a step with a non-finite gradient
  leaves weights and states bit-identical. The host never reads it
  here; it goes to `resilience.numerics.record_flag` (where="step");
- the update runs on the flats' views, group by group as the staged
  `FusedUpdater` forms them: an SGD group is one launch of the
  `fused_sgd_momentum` kernel in MXNet's form, an Adam group the
  optimizer's ``_foreach`` function;
- each group's optimizer states are carried in flats between steps (the
  per-key states are views of them) and flushed into compact per-key
  tensors at the `get_states`/`save_states` boundary.

Launches counted in ``train.step.dispatches`` a step: one per flat at
``nproc > 1`` (the collectives) plus one per update group; the copies
into the flats and the verdict's reductions are not counted. The staged
path counts the same (one per bucket collective, one per group).

Bit parity: the flats hold the staged exchange's buckets exactly (same
plan, same sizes, so the same collective sums the same elements in the
same order), and the update runs the staged path's groups through the
same kernel and functions. So the fused step is bit-identical to the
staged path, which ``MXTPU_FUSED_STEP=0`` selects and which stays the
oracle. A compressing store, an optimizer other than SGD and Adam, a
gradient the groups leave over, or ``ignore_stale_grad`` across
processes takes the staged path (the refusal of a key set is latched).
ZeRO-1 (``MXTPU_ZERO1=1``) is not ported and raises.

Env knobs: ``MXTPU_FUSED_STEP`` (default 1), ``MXTPU_ZERO1`` (0).
"""
from __future__ import annotations

import torch

from .. import optimizer as opt
from ..base import MXNetError, getenv
from ..resilience import numerics as _num
from .bucketing import GradBucketer, finite_all
from .fused_update import (FUSED_GROUPS, STEP_DISPATCHES, _SUPPORTED,
                           FusedUpdater)

__all__ = ["FusedTrainStep", "eligible", "enabled", "try_step",
           "zero1_enabled"]

# one flat per dtype when no distributed store plans the layout
_NO_LIMIT = 1 << 62

_STEP_OPTS = (opt.SGD, opt.Adam)


def enabled():
    """MXTPU_FUSED_STEP gate, re-read per call (default on)."""
    return getenv("MXTPU_FUSED_STEP", True)


def zero1_enabled():
    """MXTPU_ZERO1 gate, re-read per call (default off)."""
    return getenv("MXTPU_ZERO1", False)


def _refuse_zero1():
    if zero1_enabled():
        raise MXNetError("MXTPU_ZERO1=1: ZeRO-1 sharding of the optimizer "
                         "state is not ported yet (ROADMAP A6b); unset it")


def _exchange_plan(kvstore):
    """The number of processes the exchange spans, or None when the
    store's semantics cannot be fused (compression, a multi-worker
    store that is not the distributed one)."""
    if kvstore is None:
        return 1
    if getattr(kvstore, "_compression", None) is not None:
        return None
    from .kvstore_dist import DistKVStore
    if isinstance(kvstore, DistKVStore):
        return kvstore.num_workers
    return 1 if kvstore.num_workers <= 1 else None


def _with_leaves(state, mp, leaves):
    """`state` with its state tensors replaced by `leaves`."""
    base = state[1] if mp else state
    new = tuple(leaves) if isinstance(base, (list, tuple)) else leaves[0]
    return (state[0], new) if mp else new


class _GradFlats:
    """One layout's gradient flats, with a view per key."""

    __slots__ = ("flats", "views")

    def __init__(self, buckets, device):
        self.flats = [torch.empty(b.total, dtype=b.dtype, device=device)
                      for b in buckets]
        self.views = {}
        for b, flat in zip(buckets, self.flats):
            self.views.update(zip(b.keys, b.unpack(flat)))


class _StateFlats:
    """One update group's state flats: flat s holds state leaf s of every
    key in group order; `views[s][j]` is key j's."""

    __slots__ = ("flats", "views", "mp")

    def __init__(self, group, n_states):
        like = group[0].pack_w
        self.mp = group[0].master is not None
        sizes = [e.pack_w.numel() for e in group]
        self.flats, self.views = [], []
        for _ in range(n_states):
            flat = torch.empty(sum(sizes), dtype=like.dtype,
                               device=like.device)
            self.flats.append(flat)
            self.views.append([v.view(e.pack_w.shape) for v, e in zip(
                torch.split(flat, sizes), group)])


class FusedTrainStep:
    """The exchange and update of a whole trainable set, on flats. Owns
    the gradient flats of each layout it ran and the state flats of the
    groups it updates; the weights stay the caller's tensors."""

    def __init__(self, updater):
        if not isinstance(updater, FusedUpdater):
            raise TypeError("FusedTrainStep needs a FusedUpdater "
                            "(optimizer.get_updater's default)")
        self._updater = updater
        updater._fused_step_owner = self
        self._one_flat = GradBucketer(target_bytes=_NO_LIMIT)
        self._grad_flats = {}     # (layout, device) -> _GradFlats
        self._state_flats = {}    # group identity -> _StateFlats
        self._refused = set()     # key sets latched to the staged path
        self.last_dispatches = 0

    def run(self, indices, grads, weights, kvstore=None):
        """One fused step over the whole set. True when it ran (the
        gradients are left unreduced: the flats took copies); False
        leaves everything as it was, for the staged path."""
        _refuse_zero1()
        o = self._updater.optimizer
        spec = _SUPPORTED.get(type(o))
        if spec is None or type(o) not in _STEP_OPTS or not indices:
            return False
        probe = (type(o), tuple(indices))
        if probe in self._refused:
            return False
        nproc = _exchange_plan(kvstore)
        if nproc is None:
            return False
        n_states, math = spec
        entries = None
        if len({(g[0] if isinstance(g, (list, tuple)) else g).device
                for g in grads}) == 1:
            entries, _ = self._updater._collect(
                n_states(o), indices, grads, weights, require_all=True)
        if entries is None:
            if len(self._refused) > 64:       # membership churn bound
                self._refused.clear()
            self._refused.add(probe)
            return False
        gf = self._pack(entries, kvstore)
        dispatches = 0
        if nproc > 1:
            pending = [kvstore.allreduce_async(f) for f in gf.flats]
            for p in pending:
                p.result()
            dispatches += len(pending)
        ok = None
        if _num.enabled():
            oks = [finite_all(f) for f in gf.flats]
            ok = oks[0] if len(oks) == 1 else torch.stack(oks).all()
        up = self._updater
        plans, up._plans = up._plans, {}
        with torch.no_grad():
            for group, lr, wd, t in up._groups(entries):
                for e in group:
                    e.grad = gf.views[e.index]
                self._carry_states(group)
                if math is None:
                    up._run_sgd(plans, group, lr, wd, ok)
                else:
                    up._run_foreach(math, group, lr, wd, t, ok)
                FUSED_GROUPS.inc()
                opt._UPDATE_DISPATCHES.inc()
                STEP_DISPATCHES.inc()
                dispatches += 1
        self.last_dispatches = dispatches
        if ok is not None:
            _num.record_flag(ok, where="step")
        return True

    def _pack(self, entries, kvstore):
        """Copy the gradients into the flats of the exchange's layout:
        the distributed store's bucket plan over the same items its staged
        push plans (priority by caller order), else one flat per dtype."""
        bucketer = getattr(kvstore, "_bucketer", None) or self._one_flat
        items = tuple((e.index, tuple(e.grad.shape), e.grad.dtype, -pos,
                       False) for pos, e in enumerate(entries))
        buckets = bucketer.plan(items)
        device = entries[0].grad.device
        key = (tuple(b.signature for b in buckets), bucketer.target_bytes,
               device)
        gf = self._grad_flats.get(key)
        if gf is None:
            if len(self._grad_flats) > 8:     # layouts that keep changing
                self._grad_flats.clear()
            gf = self._grad_flats[key] = _GradFlats(buckets, device)
        torch._foreach_copy_([gf.views[e.index] for e in entries],
                             [e.grad for e in entries])
        return gf

    def _carry_states(self, group):
        """Make the group's per-key states views of its state flats: as
        they are when they still are, else copied in and rebound (the
        first step, or after `set_states` or a flush)."""
        n = len(group[0].leaves)
        if not n:
            return
        gid = (tuple(e.index for e in group), group[0].lane)
        sf = self._state_flats.get(gid)
        if sf is not None and all(
                e.leaves[s] is sf.views[s][j]
                for j, e in enumerate(group) for s in range(n)):
            return
        if sf is None:
            sf = self._state_flats[gid] = _StateFlats(group, n)
        states = self._updater.states
        for j, e in enumerate(group):
            views = [sf.views[s][j] for s in range(n)]
            for v, leaf in zip(views, e.leaves):
                v.copy_(leaf)
            states[e.index] = _with_leaves(states[e.index],
                                           e.master is not None, views)
            e.leaves = views

    def flush_state(self):
        """Write the carried states out as compact per-key tensors (the
        `get_states`/`save_states` boundary) and forget the flats. A key
        whose state is no longer a view of them keeps its state."""
        states = self._updater.states
        for gid, sf in self._state_flats.items():
            for j, index in enumerate(gid[0]):
                st = states.get(index)
                if st is None:
                    continue
                base = st[1] if sf.mp else st
                leaves = list(base) if isinstance(base, (list, tuple)) \
                    else [base]
                if len(leaves) == len(sf.views) and all(
                        leaf is sf.views[s][j]
                        for s, leaf in enumerate(leaves)):
                    states[index] = _with_leaves(
                        st, sf.mp, [leaf.clone() for leaf in leaves])
        self._state_flats.clear()

    def drop_state(self):
        """Forget the state flats (`set_states` replaced the states)."""
        self._state_flats.clear()


def eligible(updater, indices, kvstore=None):
    """The cheap refusals, without side effects: the gate, the updater and
    optimizer, a key set latched to the staged path, the store."""
    if not enabled():
        return False
    _refuse_zero1()
    if not isinstance(updater, FusedUpdater) or \
            type(updater.optimizer) not in _STEP_OPTS:
        return False
    step = updater._fused_step_owner
    if step is not None and \
            (type(updater.optimizer), tuple(indices)) in step._refused:
        return False
    return _exchange_plan(kvstore) is not None


def try_step(updater, indices, grads, weights, kvstore=None):
    """Module/Trainer entry: the fused step when the updater supports it.
    True when it ran."""
    step = getattr(updater, "_fused_step_owner", None)
    if step is None:
        try:
            step = FusedTrainStep(updater)
        except TypeError:
            return False
    return step.run(indices, grads, weights, kvstore=kvstore)
