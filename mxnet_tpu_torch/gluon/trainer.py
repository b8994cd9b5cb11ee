"""Gluon `Trainer`: applies an optimizer to a set of parameters
(counterpart of mxnet_tpu/gluon/trainer.py: `Trainer` :59, `_resolve_sync`
:99, `step` :193, `_fused_step` :216, `_rescale` :265, `allreduce_grads`
:288, `update` :297, `_reduce` :308, `_apply_updates` :327,
`save_states`/`load_states` :361-385, `learning_rate`/`set_learning_rate`
:151-163).

`step(batch_size)` first tries the fused exchange + update step
(`parallel.fused_step`, ``MXTPU_FUSED_STEP``, default on): the gradients
copied into flats, one collective per flat across processes, then one
launch of the hand-written SGD kernel per SGD group (Adam: one
``_foreach`` pass per group), on the flats. Otherwise it takes the
staged path, which stays the bit-parity oracle: the store's push and
pull (bucketed across processes, `parallel.kvstore_dist`), then ONE
`update_all` of the `parallel.FusedUpdater`. `ignore_stale_grad` across
processes, compression and ``update_on_kvstore`` are always staged;
`allreduce_grads` and `update` are the staged halves.

The store: a distributed type (``dist_sync``, ``dist_device_sync``,
``tpu_dist``, ``dist``), a `KVStore` instance, `compression_params` or
``update_on_kvstore=True`` make one; a local type without those is not
made, since in one process it would only copy each gradient onto
itself. With ``update_on_kvstore`` the store runs the updater on its own
copy of the weights, which `step` pulls back. Loss scaling, rollback,
SDC replay and step telemetry wait for the operational planes.
"""
from __future__ import annotations

from .. import optimizer as opt
from ..base import MXNetError
from ..context import context_of
from ..kvstore import create as _create_kvstore
from ..parallel import fused_step as _fstep
from ..resilience.atomic import atomic_write
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


def _normalize_params(params):
    if isinstance(params, (dict, ParameterDict)):
        params = list(params.values())
    if not isinstance(params, (list, tuple)):
        raise ValueError("First argument must be a list or dict of "
                         "Parameters, got %s." % (type(params)))
    for p in params:
        if not isinstance(p, Parameter):
            raise ValueError("First argument must be a list or dict of "
                             "Parameters, got list of %s." % (type(p)))
    return list(params)


class Trainer:
    """Applies an Optimizer on a set of Parameters (trainer.py:59)."""

    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        self._params = _normalize_params(params)
        self._compression_params = compression_params
        # a parameter holds its blocks weakly: the trainer keeps them
        self._blocks = {id(b): b for p in self._params
                        for b, _, _ in p._live_holders()}
        opt_kw = dict(optimizer_params or {})
        self._scale = float(opt_kw.get("rescale_grad", 1.0))
        self._kvstore_spec = (kvstore, update_on_kvstore)
        self._kvstore = None
        self._reduce_via_kv = False
        self._update_via_kv = False
        self._ready = False
        self._optimizer = self._make_optimizer(optimizer, opt_kw)
        self._updaters = [opt.get_updater(self._optimizer)]

    def _make_optimizer(self, optimizer, opt_kw):
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if opt_kw:
                raise MXNetError("optimizer_params must be None if "
                                 "optimizer is an Optimizer instance")
            optimizer.param_dict = param_dict
            return optimizer
        return opt.create(optimizer, param_dict=param_dict, **opt_kw)

    def _resolve_sync(self):
        """Make the kvstore, where one is needed, and decide, once, where
        the reduce and the update happen."""
        spec, on_kv = self._kvstore_spec
        kv = None
        if spec and not isinstance(spec, str):
            kv = spec
        elif spec and (on_kv or "dist" in spec or self._compression_params):
            # a distributed store's rank device: where the parameters are
            with context_of(self._params[0].data().device):
                kv = _create_kvstore(spec)
        if kv is not None:
            if self._compression_params:
                kv.set_gradient_compression(self._compression_params)
            self._kvstore = kv
            self._reduce_via_kv = True
            self._update_via_kv = bool(on_kv)
            if self._update_via_kv:
                kv.set_optimizer(self._optimizer)
            for i, param in enumerate(self._params):
                kv.init(i, param.data())
        self._ready = True

    def _ensure_ready(self):
        if not self._ready:
            self._resolve_sync()

    def _trainable(self):
        """(slot, param) pairs that carry gradients."""
        return [(i, p) for i, p in enumerate(self._params)
                if p.grad_req != "null"]

    @property
    def learning_rate(self):
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr):
        """Set a new learning rate (trainer.py:158)."""
        self._optimizer.set_learning_rate(lr)

    @property
    def optimizer(self):
        return self._optimizer

    def step(self, batch_size, ignore_stale_grad=False):
        """One optimization step: reduce the gradients, then update the
        parameters, with the gradients scaled by 1 / `batch_size`
        (trainer.py:193); fused when `parallel.fused_step` takes it."""
        self._ensure_ready()
        self._optimizer.rescale_grad = self._scale / batch_size
        if not self._fused_step(ignore_stale_grad):
            self._reduce()
            self._apply_updates(ignore_stale_grad)

    def _fused_step(self, ignore_stale_grad):
        """The fused exchange + update step (trainer.py:216). False, with
        nothing changed, sends the step to the staged path."""
        if not _fstep.enabled() or self._update_via_kv:
            return False
        kv = self._kvstore if self._reduce_via_kv else None
        if ignore_stale_grad and getattr(kv, "num_workers", 1) > 1:
            # freshness is a rank's own: a collective over a per-rank
            # subset would desynchronize the ranks
            return False
        pairs = self._trainable()
        if ignore_stale_grad:
            pairs = [(i, p) for i, p in pairs if p._fresh_grad]
        if not pairs:
            return True
        idxs = [i for i, _ in pairs]
        if not _fstep.eligible(self._updaters[0], idxs, kvstore=kv):
            return False
        if not _fstep.try_step(self._updaters[0], idxs,
                               [p.grad() for _, p in pairs],
                               [p.data() for _, p in pairs], kvstore=kv):
            return False
        for _, p in pairs:
            p._fresh_grad = False
        return True

    def allreduce_grads(self):
        """Reduce the gradients without updating (trainer.py:288)."""
        self._ensure_ready()
        if self._kvstore is not None and self._update_via_kv:
            raise MXNetError("allreduce_grads() when parameters are "
                             "updated on kvstore is not supported")
        self._reduce()

    def update(self, batch_size, ignore_stale_grad=False):
        """Update the parameters from reduced gradients (trainer.py:297)."""
        self._ensure_ready()
        if self._kvstore is not None and self._update_via_kv:
            raise MXNetError("update() when parameters are updated on "
                             "kvstore is not supported")
        self._optimizer.rescale_grad = self._scale / batch_size
        self._apply_updates(ignore_stale_grad)

    def _reduce(self):
        """One batched push of the gradients (priority -i: what the next
        forward needs first), and their sums pulled back into them unless
        the store updates."""
        pairs = self._trainable()
        if not self._reduce_via_kv or not pairs:
            return
        keys = [i for i, _ in pairs]
        grads = [p.list_grad() for _, p in pairs]
        prios = [-i for i in keys]
        self._kvstore.push_all(keys, grads, priorities=prios)
        if not self._update_via_kv:
            self._kvstore.pull_all(keys, grads, priorities=prios)

    def _apply_updates(self, ignore_stale_grad=False):
        pairs = self._trainable()
        if self._update_via_kv:
            if pairs:
                self._kvstore.pull_all(
                    [i for i, _ in pairs],
                    [p.list_data() for _, p in pairs],
                    priorities=[-i for i, _ in pairs])
            return
        if ignore_stale_grad:
            # only parameters whose gradient a backward wrote since the
            # last update (the reference's _fresh_grad contract)
            pairs = [(i, p) for i, p in pairs if p._fresh_grad]
        if not pairs:
            return
        idxs = [i for i, _ in pairs]
        grads = [p.grad() for _, p in pairs]
        weights = [p.data() for _, p in pairs]
        for updater in self._updaters:
            updater.update_all(idxs, grads, weights)
        for _, p in pairs:
            p._fresh_grad = False

    def save_states(self, fname):
        """Save the updater's states and the optimizer, atomically
        (trainer.py:361)."""
        self._ensure_ready()
        if self._update_via_kv:
            self._kvstore.save_optimizer_states(fname, dump_optimizer=True)
            return
        with atomic_write(fname) as fout:
            fout.write(self._updaters[0].get_states(dump_optimizer=True))

    def load_states(self, fname):
        """Load states that `save_states` wrote (trainer.py:373); the
        optimizer comes back with them and takes this trainer's
        parameters again."""
        self._ensure_ready()
        if self._update_via_kv:
            self._kvstore.load_optimizer_states(fname)
            self._optimizer = self._kvstore._updater.optimizer
        else:
            with open(fname, "rb") as f:
                states = f.read()
            for updater in self._updaters:
                updater.set_states(states)
                updater.optimizer = self._updaters[0].optimizer
            self._optimizer = self._updaters[0].optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))
