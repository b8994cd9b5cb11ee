"""`FusedUpdater`: the optimizer update of a whole trainable set in a few
launches (counterpart of mxnet_tpu/parallel/fused_update.py: `_sgd_fused`
:101, `_adam_fused` :110, `_SUPPORTED` :143, `_guard_wrap` :171,
`FusedUpdater` :316).

`update_all` groups the parameters as the JAX package does: by optimizer
class, the dtype the update runs in, multi-precision, the raw weight
dtype, the ``lr_mult``/``wd_mult`` lane and the device, within cohorts of
equal (update count, lr, wd). Then:

- an SGD group, one parameter or many, is ONE launch of the hand-written
  kernel in MXNet's form (`ops.SGDMomentumPlan(form="mxnet")`; on CPU
  tensors its plain version), through a plan built once per group and
  rebuilt only when the group's tensors change
  (`ops.cached_mxnet_plan`: a step whose pointers differ, after `cast`,
  a device move or `set_states`, builds a new one). Gradients ride each
  launch's parameters. The table keeps the plans of the last call only,
  so a trainable set that changes every step cannot grow it.
  What the groups leave over (a gradient of another dtype or shape than
  its weight, a state that does not fit) goes to `SGD.update`, which on
  the card launches the same kernel for one parameter.
- Adam, RMSProp and AdaGrad groups run the optimizer's own list function
  (`torch._foreach_*`), as JAX runs them as XLA, not Pallas.
- Other classes go per key, and so do Adam, RMSProp and AdaGrad under
  ``MXTPU_FUSED_UPDATE=0``, as in JAX.

The numerics guard (``MXTPU_NUMERICS``, default on): a group whose
gradients are not all finite keeps its weights and states bit-identical.
The verdict is a device flag and the host never reads it here: the SGD
kernel reads it, and a `_foreach` group's writes go through
``torch.where`` on it. One verdict per `update_all` goes to
`resilience.numerics.record_flag` (where="update"), to be read when the
guard drains its verdicts; leftovers that take the per-key path run
outside it and are counted by `resilience.numerics.note_unguarded`
(a partly unguarded step never claims a sound SDC replay).

Chaos corruption sites (`resilience.chaos.corrupt_tensors`, JAX :506,
:557): ``grad.post`` on each group's gradients, read as one flat, before
the verdict (a ``kind=nan`` there is skipped by the guard), and
``weight.post`` on the weights the group wrote (a ``kind=bitflip`` there
is the silent corruption only the divergence watchdog can see). They run
eagerly on the host's side of each launch, outside any captured graph,
so each step draws anew. One dict lookup each when nothing is armed.

A `parallel.fused_step.FusedTrainStep` attached to the updater
(`_fused_step_owner`) shares its groups, its plans and its states: its
state flats hold the per-key states as views, and `get_states` flushes
them into compact tensors first, so the pickle holds each key's own
elements. Counter: ``optimizer.fused.groups``.
"""
from __future__ import annotations

import torch

from .. import optimizer as opt
from ..base import getenv
from ..observability import registry as _obs
from ..ops.sgd_momentum import cached_mxnet_plan
from ..resilience import numerics as _num
from ..resilience.chaos import corrupt_tensors

__all__ = ["FusedUpdater", "STEP_DISPATCHES", "all_finite", "fused_enabled"]

FUSED_GROUPS = _obs.counter(
    "optimizer.fused.groups",
    "Fused optimizer groups dispatched (one kernel launch or one _foreach "
    "pass each)")
STEP_DISPATCHES = _obs.counter(
    "train.step.dispatches",
    "Launches for a training step's gradient exchange and update: one per "
    "collective, one per update group (a kernel launch or a _foreach pass)")

# class -> (number of state tensors, the list function; None: the kernel)
_SUPPORTED = {
    opt.SGD: (lambda o: 1 if o.momentum else 0, None),
    opt.Adam: (lambda o: 2, opt._adam_math),
    opt.RMSProp: (lambda o: 3 if o.centered else 1, opt._rmsprop_math),
    opt.AdaGrad: (lambda o: 1, opt._adagrad_math),
}


def corrupt_grads(group):
    """The ``grad.post`` site over a group's gradients, read as one flat.
    The caller's gradient stays as it was: the entry takes a corrupted
    copy, as JAX corrupts its packed copy."""
    hit = corrupt_tensors("grad.post", [e.grad for e in group],
                          inplace=False)
    if hit is not None:
        group[hit[0]].grad = hit[1]


def corrupt_written(group):
    """The ``weight.post`` site over the weights (masters under
    multi-precision) a group wrote; a corrupted master rounds into its
    weight again."""
    if corrupt_tensors("weight.post", [e.pack_w for e in group]) is None:
        return
    for e in group:
        if e.master is not None:
            e.weight.copy_(e.master)


def fused_enabled():
    """MXTPU_FUSED_UPDATE gate, re-read per call; default on."""
    return getenv("MXTPU_FUSED_UPDATE", True)


def all_finite(gs):
    """A 0-d device bool: every element of every tensor in `gs` is finite
    (the largest magnitude of each, by `torch._foreach_norm`, is)."""
    return torch.stack(torch._foreach_norm(gs, float("inf"))) \
        .isfinite().all()


class _Entry:
    """One parameter's resolved update inputs."""

    __slots__ = ("index", "weight", "pack_w", "grad", "leaves", "master",
                 "lr", "wd", "t", "lane")

    def __init__(self, index, weight, pack_w, grad, leaves, master, lane):
        self.index = index
        self.weight = weight       # the parameter's tensor
        self.pack_w = pack_w       # what the update runs on: it, or master
        self.grad = grad
        self.leaves = leaves       # state tensors, in the rule's order
        self.master = master       # fp32 master or None
        self.lane = lane
        self.lr = self.wd = self.t = None


class FusedUpdater(opt.Updater):
    """`optimizer.Updater` whose `update_all` fuses eligible parameters;
    per-key calls and the pickled states are the base class's."""

    def __init__(self, optimizer):
        super().__init__(optimizer)
        # group identity -> (pointers the plan was built on, plan), of the
        # last update_all
        self._plans = {}
        # the FusedTrainStep that carries this updater's states in flats
        self._fused_step_owner = None

    def get_states(self, dump_optimizer=False):
        if self._fused_step_owner is not None:
            self._fused_step_owner.flush_state()
        return super().get_states(dump_optimizer=dump_optimizer)

    def set_states(self, states):
        if self._fused_step_owner is not None:
            self._fused_step_owner.drop_state()
        super().set_states(states)

    def _collect(self, n_states, indices, grads, weights, require_all=False):
        """(fused entries, per-key leftovers) in caller order. Update
        counts, lr and wd resolve after the whole set is sorted, in
        caller order, as the per-key path would resolve them; with
        `require_all`, a set with leftovers gives (None, leftovers) and
        no count moves."""
        o = self.optimizer
        entries, leftovers = [], []
        for i, g, w in zip(indices, grads, weights):
            if isinstance(g, (list, tuple)):
                if len(g) != 1:
                    leftovers.append((i, g, w))
                    continue
                g = g[0]
            state = self._state_of(i, w)
            mp = o._is_multi_precision_state(w, state)
            master, base = (state if mp else (None, state))
            pack_w = master if mp else w
            if g.dtype != w.dtype or g.shape != pack_w.shape \
                    or g.device != w.device:
                leftovers.append((i, g, w))
                continue
            if n_states == 0:
                leaves = [] if base is None else None
            else:
                raw = base if isinstance(base, (list, tuple)) else (base,)
                leaves = list(raw) if len(raw) == n_states and all(
                    isinstance(s, torch.Tensor) and s.dtype == pack_w.dtype
                    and s.shape == pack_w.shape for s in raw) else None
            if leaves is None:
                leftovers.append((i, g, w))
                continue
            lane = (mp, w.dtype, pack_w.dtype, w.device,
                    o._resolved_mult(i, "lr_mult"),
                    o._resolved_mult(i, "wd_mult"))
            entries.append(_Entry(i, w, pack_w, g.contiguous(), leaves,
                                  master, lane))
        if require_all and leftovers:
            return None, leftovers
        for e in entries:
            o._update_count(e.index)
            e.lr = o._get_lr(e.index)
            e.wd = o._get_wd(e.index)
            e.t = o._index_update_count[e.index]
        return entries, leftovers

    @staticmethod
    def _groups(entries):
        """[(group, lr, wd, t)]: cohorts of equal (t, lr, wd) in sorted
        order, each split by lane in order of first appearance."""
        cohorts = {}
        for e in entries:
            cohorts.setdefault((e.t, e.lr, e.wd), {}) \
                .setdefault(e.lane, []).append(e)
        return [(group, lr, wd, t)
                for (t, lr, wd), lanes in sorted(
                    cohorts.items(), key=lambda kv: kv[0])
                for group in lanes.values()]

    def update_all(self, indices, grads, weights):
        """Apply the optimizer to the whole (index, grad, weight) set. A
        fused step's ZeRO-1 state blocks are gathered whole first (the
        staged path updates the per-key states)."""
        owner = self._fused_step_owner
        if owner is not None and owner._zero_flats:
            owner.flush_state()
        spec = _SUPPORTED.get(type(self.optimizer))
        # SGD is never gated: on the card its only route is the kernel
        if spec is None or (spec[1] is not None and not fused_enabled()):
            super().update_all(indices, grads, weights)
            return
        n_states, math = spec
        entries, leftovers = self._collect(n_states(self.optimizer),
                                           indices, grads, weights)
        guard = _num.enabled()
        if leftovers and guard:
            _num.note_unguarded(len(leftovers))
        oks = []
        plans, self._plans = self._plans, {}
        with torch.no_grad():
            for group, lr, wd, t in self._groups(entries):
                corrupt_grads(group)
                ok = all_finite([e.grad for e in group]) if guard else None
                if math is None:
                    self._run_sgd(plans, group, lr, wd, ok)
                else:
                    self._run_foreach(math, group, lr, wd, t, ok)
                corrupt_written(group)
                FUSED_GROUPS.inc()
                opt._UPDATE_DISPATCHES.inc()
                STEP_DISPATCHES.inc()
                oks.append(ok)
        if guard and oks:
            _num.record_flag(oks[0] if len(oks) == 1
                             else torch.stack(oks).all(),
                             keys=[e.index for e in entries],
                             where="update")
        for i, g, w in leftovers:
            self(i, g, w)

    def _run_sgd(self, plans, group, lr, wd, ok):
        """One launch for the group, through its plan: the one the last
        call left in `plans`, or a new one, kept for the next call."""
        key = (tuple(e.index for e in group), group[0].lane)
        if key in plans:
            self._plans[key] = plans[key]
        mp = group[0].master is not None
        plan = cached_mxnet_plan(
            self._plans, key, [e.pack_w for e in group],
            [e.leaves[0] for e in group] if group[0].leaves else None,
            [e.weight for e in group] if mp else None)
        o = self.optimizer
        plan([e.grad for e in group], lr, o.momentum, wd, o.rescale_grad,
             o.clip_gradient, ok)

    def _run_foreach(self, math, group, lr, wd, t, ok):
        """The optimizer's list function over the group. Under a verdict
        `ok`, what it writes is kept only where `ok` holds (a device
        select, bit for bit): no host read."""
        mp = group[0].master is not None
        gs = [e.grad.float() if mp else e.grad for e in group]
        ws = [e.pack_w for e in group]
        states = [[e.leaves[s] for e in group]
                  for s in range(len(group[0].leaves))]
        written = ws + [x for st in states for x in st]
        old = [x.clone() for x in written] if ok is not None else None
        if math is opt._adam_math:
            math(ws, gs, states[0], states[1], lr, t, wd,
                 self.optimizer.hyper())
        else:
            math(ws, gs, states, lr, t, wd, self.optimizer.hyper())
        if old is not None:
            for x, was in zip(written, old):
                x.copy_(torch.where(ok, x, was))
        if mp:
            for e in group:
                e.weight.copy_(e.master)
