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
- the ``grad.post`` chaos site (`resilience.chaos.corrupt_tensors`, JAX
  :352) draws once a step over the exchanged flats, in place (they are
  the step's own copies), and ``weight.post`` (JAX :583) once per update
  group over the weights it wrote. Both run on the host's side of the
  launches: the fused step is not a captured graph, so each step draws
  anew; a seeded draw can never be baked into a replay;
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
path counts the same (one per bucket collective, one per group). Under
ZeRO-1: per group its reduce-scatter, update and all-gather, and the
verdict's all-reduce.

Bit parity: the flats hold the staged exchange's buckets exactly (same
plan, same sizes, so the same collective sums the same elements in the
same order), and the update runs the staged path's groups through the
same kernel and functions. So the fused step is bit-identical to the
staged path, which ``MXTPU_FUSED_STEP=0`` selects and which stays the
oracle. A compressing store, an optimizer other than SGD and Adam, a
gradient the groups leave over, or ``ignore_stale_grad`` across
processes takes the staged path (the refusal of a key set is latched).

ZeRO-1 (``MXTPU_ZERO1=1``, arXiv:2004.13336; JAX :21-29, :217-239,
:330-353) at ``nproc > 1`` shards each update group's optimizer state
over the processes: the group's gradients are packed into one flat,
padded to a multiple of nproc, and reduce-scattered, so each rank holds
the sum of its 1/nproc block; the verdict sums the ranks' counts of
non-finite blocks (one small all-reduce); the rank updates its block of
the group's packed weights (the fp32 masters in multi-precision) with
its block of the state, through the same kernel (SGD, one launch over a
plan of that block) or ``_foreach`` function (Adam), and the updated
blocks are all-gathered and unpacked into the weights (a bf16 weight
takes its master's rounding, as the kernel writes it). The state blocks
are carried between steps and all-gathered into the per-key states only
at `flush_state` (the `get_states`/`save_states` boundary, and before
a staged update or a fused step without ZeRO-1; a collective: every
rank calls it; ``zero1.allgather.seconds``); ``zero1.shard_params``
counts the sharded parameters. At one process ``MXTPU_ZERO1`` changes
nothing, as in JAX.

Env knobs: ``MXTPU_FUSED_STEP`` (default 1), ``MXTPU_ZERO1`` (0).
"""
from __future__ import annotations

import time

import torch

from .. import optimizer as opt
from ..base import getenv
from ..observability import registry as _obs
from ..resilience import numerics as _num
from ..resilience.chaos import corrupt_tensors
from .bucketing import GradBucketer, finite_all
from .fused_update import (FUSED_GROUPS, STEP_DISPATCHES, _SUPPORTED,
                           FusedUpdater, _Entry, corrupt_written)

__all__ = ["FusedTrainStep", "ZERO1_ALLGATHER_SECONDS", "ZERO1_SHARD_PARAMS",
           "eligible", "enabled", "try_step", "zero1_enabled"]

ZERO1_SHARD_PARAMS = _obs.gauge(
    "zero1.shard_params",
    "Parameters whose optimizer state/update is ZeRO-1-sharded over "
    "the data-parallel axis (0 = replicated state)")
ZERO1_ALLGATHER_SECONDS = _obs.histogram(
    "zero1.allgather.seconds",
    "Wall time all-gathering ZeRO-1-sharded optimizer state into a "
    "full copy (get_states / checkpoint / staged-fallback boundaries)")

# one flat per dtype when no distributed store plans the layout
_NO_LIMIT = 1 << 62

_STEP_OPTS = (opt.SGD, opt.Adam)


def enabled():
    """MXTPU_FUSED_STEP gate, re-read per call (default on)."""
    return getenv("MXTPU_FUSED_STEP", True)


def zero1_enabled():
    """MXTPU_ZERO1 gate, re-read per call (default off)."""
    return getenv("MXTPU_ZERO1", False)


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


class _ZeroState:
    """One update group's ZeRO-1 layout (its keys' tensors packed in group
    order, padded to a multiple of nproc, this rank's block of `block`
    elements) and this rank's blocks of the group's states, filled from
    the per-key states when made."""

    __slots__ = ("sizes", "shapes", "total", "padded_total", "block",
                 "dtype", "mp", "states", "w")

    def __init__(self, group, nproc, rank):
        like = group[0].pack_w
        self.dtype = like.dtype
        self.mp = group[0].master is not None
        self.sizes = [e.pack_w.numel() for e in group]
        self.shapes = [e.pack_w.shape for e in group]
        self.total = sum(self.sizes)
        self.padded_total = self.total + (-self.total) % nproc
        self.block = self.padded_total // nproc
        self.states = [
            self.padded([e.leaves[s] for e in group])[
                rank * self.block:(rank + 1) * self.block].clone()
            for s in range(len(group[0].leaves))]
        # the packed weights, one buffer for the group's life (its block
        # keeps its address, so the update's plan is built once)
        self.w = torch.zeros(self.padded_total, dtype=like.dtype,
                             device=like.device)

    def pack_weights(self, tensors):
        """The weights packed into `w` (its padding stays zero)."""
        torch.cat([t.reshape(-1) for t in tensors], out=self.w[:self.total])
        return self.w

    def padded(self, tensors):
        """The tensors raveled, concatenated and zero-padded."""
        flat = torch.cat([t.reshape(-1) for t in tensors])
        pad = self.padded_total - self.total
        return torch.cat([flat, flat.new_zeros(pad)]) if pad else flat

    def unpack(self, flat):
        return [v.view(shape) for v, shape in zip(
            torch.split(flat[:self.total], self.sizes), self.shapes)]


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
        self._zero_flats = {}     # group identity -> _ZeroState (ZeRO-1)
        self._zero_gauge = None
        self.last_dispatches = 0

    def run(self, indices, grads, weights, kvstore=None):
        """One fused step over the whole set. True when it ran (the
        gradients are left unreduced: the flats took copies); False
        leaves everything as it was, for the staged path."""
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
        if nproc > 1 and zero1_enabled():
            self._run_zero1(entries, math, nproc)
            return True
        if self._zero_flats:
            self.flush_state()        # ZeRO-1 turned off: states whole
        gf = self._pack(entries, kvstore)
        dispatches = 0
        if nproc > 1:
            pending = [kvstore.allreduce_async(f) for f in gf.flats]
            for p in pending:
                p.result()
            dispatches += len(pending)
        corrupt_tensors("grad.post", gf.flats)
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
                corrupt_written(group)
                FUSED_GROUPS.inc()
                opt._UPDATE_DISPATCHES.inc()
                STEP_DISPATCHES.inc()
                dispatches += 1
        self.last_dispatches = dispatches
        if ok is not None:
            _num.record_flag(ok, where="step")
        return True

    def _run_zero1(self, entries, math, nproc):
        """The ZeRO-1 step (module note): per update group, reduce-scatter
        of the padded gradient flat, the verdict across ranks, the update
        of this rank's block, all-gather of the weights."""
        import torch.distributed as dist
        from .mesh import all_gather_, all_reduce_, reduce_scatter_
        group, rank = dist.group.WORLD, dist.get_rank()
        up = self._updater
        groups = up._groups(entries)
        gids = [(tuple(e.index for e in g), g[0].lane) for g, _, _, _ in
                groups]
        if set(self._zero_flats) - set(gids):
            self.flush_state()        # the groups changed: states whole
        n_sharded = sum(len(g) for g, _, _, _ in groups)
        if n_sharded != self._zero_gauge:
            self._zero_gauge = n_sharded
            ZERO1_SHARD_PARAMS.set(n_sharded)
        dispatches = 0
        with torch.no_grad():
            blocks = []
            for (grp, _, _, _), gid in zip(groups, gids):
                zs = self._zero_flats.get(gid)
                if zs is None:
                    zs = self._zero_flats[gid] = _ZeroState(grp, nproc, rank)
                whole = zs.padded([e.grad.to(zs.dtype) for e in grp])
                blocks.append(reduce_scatter_(whole.new_empty(zs.block),
                                              whole, group))
                STEP_DISPATCHES.inc()
                dispatches += 1
            corrupt_tensors("grad.post", blocks)
            ok = None
            if _num.enabled():
                bad = torch.stack([(~finite_all(b)) for b in blocks]).any()
                bad = all_reduce_(bad.to(torch.float32).reshape(1), group)
                ok = bad[0] == 0
                STEP_DISPATCHES.inc()
                dispatches += 1
            plans, up._plans = up._plans, {}
            for (grp, lr, wd, t), gid, g in zip(groups, gids, blocks):
                zs = self._zero_flats[gid]
                w = zs.pack_weights([e.pack_w for e in grp])
                mine = w[rank * zs.block:(rank + 1) * zs.block]
                one = _Entry(gid, mine, mine, g, list(zs.states), None,
                             ("zero1",) + gid[1:])
                if math is None:
                    up._run_sgd(plans, [one], lr, wd, ok)
                else:
                    up._run_foreach(math, [one], lr, wd, t, ok)
                corrupt_tensors("weight.post", [mine])
                all_gather_(w, mine.clone(), group)
                for e, v in zip(grp, zs.unpack(w)):
                    e.pack_w.copy_(v)
                    if e.master is not None:
                        e.weight.copy_(e.master)
                FUSED_GROUPS.inc()
                opt._UPDATE_DISPATCHES.inc()
                STEP_DISPATCHES.inc(2)        # the update, the all-gather
                dispatches += 2
        self.last_dispatches = dispatches
        if ok is not None:
            _num.record_flag(ok, where="step")

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

    def _flush_zero1(self):
        """All-gather the ZeRO-1 state blocks into the per-key states
        (collective: every rank calls it)."""
        import torch.distributed as dist
        from .mesh import all_gather_
        t0 = time.perf_counter()
        states = self._updater.states
        with torch.no_grad():
            for gid, zs in self._zero_flats.items():
                wholes = [all_gather_(s.new_empty(zs.padded_total), s,
                                      dist.group.WORLD) for s in zs.states]
                for j, index in enumerate(gid[0]):
                    st = states.get(index)
                    if st is None:
                        continue
                    mp = zs.mp
                    base = st[1] if mp else st
                    leaves = list(base) if isinstance(base, (list, tuple)) \
                        else [base]
                    new = [zs.unpack(w)[j].clone() for w in wholes]
                    if len(leaves) == len(new):
                        states[index] = _with_leaves(st, mp, new)
        self._zero_flats.clear()
        ZERO1_ALLGATHER_SECONDS.observe(time.perf_counter() - t0)

    def flush_state(self):
        """Write the carried states out as compact per-key tensors (the
        `get_states`/`save_states` boundary) and forget the flats. A key
        whose state is no longer a view of them keeps its state. ZeRO-1's
        blocks are all-gathered first (a collective)."""
        if self._zero_flats:
            self._flush_zero1()
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
        self._zero_flats.clear()


def eligible(updater, indices, kvstore=None):
    """The cheap refusals, without side effects: the gate, the updater and
    optimizer, a key set latched to the staged path, the store."""
    if not enabled():
        return False
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
