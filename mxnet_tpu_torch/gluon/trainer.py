"""Gluon `Trainer`: applies an optimizer to a set of parameters
(counterpart of mxnet_tpu/gluon/trainer.py: `Trainer` :59, `_resolve_sync`
:99, `step` :193, `_rescale` :265, `allreduce_grads` :288, `update` :297,
`_reduce` :308, `_apply_updates` :327, `save_states`/`load_states`
:361-385, `learning_rate`/`set_learning_rate` :151-163).

`step(batch_size)` runs the JAX package's staged semantics on one device:
the reduce, which is the identity when one device holds each gradient,
then ONE `update_all` of the `parallel.FusedUpdater` over every trainable
parameter: one launch of the hand-written SGD kernel per SGD group. The JAX package's default
one-program step (`parallel/fused_step.py`) is bit-identical to this
staged path there (tests/test_fused_step.py); it, ZeRO-1 and bucketing
wait for the distributed slice, and loss scaling, rollback, SDC replay
and step telemetry for the operational planes.

The parameters are updated directly unless ``update_on_kvstore=True``:
then the store (default 'device') runs the updater on its own copy of the
weights, which `step` pulls back into the parameters. Without that, a
store in one process would only copy each gradient onto itself, so the
port makes none (the type is still checked: a distributed one raises).
"""
from __future__ import annotations

from .. import optimizer as opt
from ..base import MXNetError
from ..kvstore import create as _create_kvstore
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
        if compression_params:
            raise MXNetError("gradient compression is not ported yet")
        self._params = _normalize_params(params)
        # a parameter holds its blocks weakly: the trainer keeps them
        self._blocks = {id(b): b for p in self._params
                        for b, _, _ in p._live_holders()}
        opt_kw = dict(optimizer_params or {})
        self._scale = float(opt_kw.get("rescale_grad", 1.0))
        self._kvstore_spec = (kvstore, update_on_kvstore)
        self._kvstore = None
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
        """Make the kvstore, where the update runs in it, and decide, once,
        where the update happens."""
        spec, on_kv = self._kvstore_spec
        if spec:
            kv = spec if not isinstance(spec, str) else _create_kvstore(spec)
            if on_kv:
                self._kvstore, self._update_via_kv = kv, True
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
        (trainer.py:193)."""
        self._ensure_ready()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._reduce()
        self._apply_updates(ignore_stale_grad)

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
        """One device: only a store that updates takes the gradients."""
        pairs = self._trainable()
        if not self._update_via_kv or not pairs:
            return
        keys = [i for i, _ in pairs]
        self._kvstore.push_all(keys, [p.list_grad() for _, p in pairs],
                               priorities=[-i for i in keys])

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
