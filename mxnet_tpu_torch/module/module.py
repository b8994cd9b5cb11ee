"""Module: symbolic training on a bound executor group (counterpart of
mxnet_tpu/module/module.py: `bind` :241, `init_optimizer` :343, `update`
:487, `save_checkpoint` :140, `load` :130; reference:
python/mxnet/module/module.py: Module :40, bind :364, init_optimizer
:473, update :643).

A Module binds one executor on its context (the card unless the caller
gives `mx.cpu()`), keeps host copies of the parameters for checkpoints,
and updates through `model._update_params`: one `update_all` of the
`FusedUpdater`, so an SGD step is one launch of the `fused_sgd_momentum`
kernel on the card. The JAX package's predict-only fast path through a
frozen serving engine waits for the serving slice (ROADMAP A8): a
module bound `for_training=False` forwards through its executor.
"""
from __future__ import annotations

import logging

import json

import torch

from ..base import MXNetError
from ..context import Context, cpu, current_context
from ..initializer import InitDesc, Uniform, create as _create_init
from ..model import (_create_kvstore, _initialize_kvstore, _update_params,
                     _update_params_on_kvstore, load_checkpoint,
                     save_checkpoint)
from .. import optimizer as opt
from ..ndarray import zeros as nd_zeros
from .base_module import BaseModule, _check_input_names
from .executor_group import DataParallelExecutorGroup

__all__ = ["Module"]


_GROUP2CTXS_MSG = (
    "group2ctxs (ctx_group model parallelism) is not ported: the port "
    "runs a module on one device")


def _partition_arguments(symbol, data_names, label_names, state_names):
    """Split the symbol's arguments into inputs vs learnable params,
    validating every declared input name exists."""
    _check_input_names(symbol, data_names, "data", True)
    _check_input_names(symbol, label_names, "label", False)
    _check_input_names(symbol, state_names, "state", True)
    non_params = set(data_names) | set(label_names) | set(state_names)
    params = [a for a in symbol.list_arguments() if a not in non_params]
    return params


def _declared_init(desc):
    """The initializer a variable's ``__init__`` attribute declares (an
    `Initializer.dumps()` JSON, or an initializer's name), or None."""
    spec = desc.attrs.get("__init__") if isinstance(desc, InitDesc) \
        else None
    if not spec:
        return None
    try:
        name, kwargs = json.loads(spec)
    except ValueError:
        name, kwargs = spec, {}
    try:
        return _create_init(name, **kwargs)
    except Exception:  # noqa: BLE001 — not an initializer's name
        return None


def _fill_param(desc, arr, cache, initializer, allow_missing):
    """Populate one parameter array from a loaded cache, falling back
    to the initializer (reference init flow, module.py:268). `desc` is
    an InitDesc (a str subclass), so it doubles as the cache key."""
    if cache is not None and desc in cache:
        src = cache[desc]
        if src is arr:
            return
        if src.shape != arr.shape:
            raise MXNetError("shape mismatch for %s: %s vs %s"
                             % (desc, src.shape, arr.shape))
        with torch.no_grad():
            arr._data.copy_(src._data if hasattr(src, "_data")
                            else torch.as_tensor(src))
        return
    if cache is not None and not allow_missing:
        raise RuntimeError("%s is not presented" % desc)
    if initializer is not None:
        # a variable's own __init__ declaration wins (initializer.py:83)
        declared = _declared_init(desc)
        if declared is not None:
            declared._init_weight(desc, arr._data)
        else:
            initializer(desc if isinstance(desc, InitDesc)
                        else InitDesc(desc), arr._data)


def _parse_data_desc(data_names, label_names, data_shapes, label_shapes):
    """Normalize shape specs to DataDesc (reference: base_module.py
    _parse_data_desc)."""
    from ..io import DataDesc

    def norm(shapes):
        return [s if isinstance(s, DataDesc) else DataDesc(s[0], s[1])
                for s in shapes]

    return (norm(data_shapes),
            norm(label_shapes) if label_shapes else None)


class Module(BaseModule):
    """A symbol bound to executors with optimizer state — the classic
    symbolic training loop (reference: module.py:40)."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None,
                 compression_params=None):
        super().__init__(logger=logger)
        if group2ctxs is not None:
            raise MXNetError(_GROUP2CTXS_MSG)
        ctxs = context if context is not None else current_context()
        self._context = [ctxs] if isinstance(ctxs, Context) else ctxs
        self._work_load_list = work_load_list
        self._symbol = symbol

        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        self._state_names = list(state_names or [])
        self._fixed_param_names = list(fixed_param_names or [])
        _check_input_names(symbol, self._fixed_param_names,
                           "fixed_param", True)
        self._param_names = _partition_arguments(
            symbol, self._data_names, self._label_names,
            self._state_names)
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        self._compression_params = compression_params

        # populated by bind / init_params / init_optimizer
        self._arg_params = self._aux_params = None
        self._params_dirty = False
        self._optimizer = self._kvstore = self._updater = None
        self._update_on_kvstore = None
        self._preload_opt_states = None
        self._grad_req = None
        self._exec_group = None
        self._data_shapes = self._label_shapes = None

    # -- checkpointing --------------------------------------------------
    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """Create from a checkpoint (reference: module.py:146)."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params, mod._aux_params = args, auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        """Save symbol + params (+ optimizer states) (reference:
        module.py:171)."""
        self._symbol.save("%s-symbol.json" % prefix)
        self.save_params("%s-%04d.params" % (prefix, epoch))
        if save_optimizer_states:
            self.save_optimizer_states("%s-%04d.states" % (prefix, epoch))

    # -- introspection --------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        outs = self._exec_group.exec_.outputs
        return list(zip(self._output_names, [o.shape for o in outs]))

    # -- parameters -----------------------------------------------------
    def get_params(self):
        assert self.binded and self.params_initialized
        if self._params_dirty:
            self._sync_params_from_devices()
        return (self._arg_params, self._aux_params)

    def _alloc_host_params(self):
        """Host-side master copies, allocated lazily from the executor
        group's array shapes."""
        if self._arg_params is None:
            self._arg_params = {
                name: nd_zeros(arr[0].shape, ctx=cpu(),
                               dtype=arr[0]._data.dtype)
                for name, arr in zip(self._param_names,
                                     self._exec_group.param_arrays)}
        if self._aux_params is None:
            self._aux_params = {
                name: nd_zeros(arr[0].shape, ctx=cpu(),
                               dtype=arr[0]._data.dtype)
                for name, arr in zip(self._aux_names,
                                     self._exec_group.aux_arrays)}

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        """Initialize parameters (reference: module.py:268)."""
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before initializing the parameters"
        self._alloc_host_params()

        attrs = self._symbol.attr_dict()
        for group, cache in ((self._arg_params, arg_params),
                             (self._aux_params, aux_params)):
            for name, arr in sorted(group.items()):
                desc = InitDesc(name, attrs.get(name, None))
                _fill_param(desc, arr, cache, initializer, allow_missing)

        self.params_initialized = True
        self._params_dirty = False
        self._exec_group.set_params(self._arg_params, self._aux_params,
                                    allow_extra=allow_extra)

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params,
                             allow_missing=allow_missing,
                             force_init=force_init,
                             allow_extra=allow_extra)
            return
        if self.params_initialized and not force_init:
            self.logger.warning("Parameters already initialized and "
                                "force_init=False. set_params call "
                                "ignored.")
            return
        self._exec_group.set_params(arg_params, aux_params,
                                    allow_extra=allow_extra)
        self._params_dirty = True
        self.params_initialized = True

    # -- binding --------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        """Bind executors (reference: module.py:364)."""
        if force_rebind:
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if not for_training:
            assert not inputs_need_grad

        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._grad_req = grad_req
        self._data_shapes, self._label_shapes = _parse_data_desc(
            self.data_names, self.label_names, data_shapes, label_shapes)

        shared_group = None
        if shared_module is not None:
            assert isinstance(shared_module, Module) and \
                shared_module.binded and shared_module.params_initialized
            shared_group = shared_module._exec_group

        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list,
            self._data_shapes, self._label_shapes, self._param_names,
            for_training, inputs_need_grad, shared_group,
            logger=self.logger,
            fixed_param_names=self._fixed_param_names,
            grad_req=grad_req, state_names=self._state_names)
        self.binded = True

        if shared_module is not None and shared_module.params_initialized:
            self.set_params(*shared_module.get_params())
        elif self.params_initialized:
            # params came from load(); push them into the fresh
            # executors (reference: module.py:441)
            self._exec_group.set_params(self._arg_params,
                                        self._aux_params)
        if shared_module is not None and \
                shared_module.optimizer_initialized:
            # a bucket bound AFTER init_optimizer must train with the
            # shared module's optimizer (reference: module.py:454) —
            # without this, BucketingModule.update() asserts on the
            # first batch that lands in a fresh bucket
            self.borrow_optimizer(shared_module)

    def _reset_bind(self):
        self.binded = False
        self._exec_group = None
        self._data_shapes = self._label_shapes = None

    def reshape(self, data_shapes, label_shapes=None):
        """Rebind for new batch shapes (reference: module.py:452)."""
        assert self.binded
        self._reset_bind()
        was_init = self.params_initialized
        arg_params, aux_params = self._arg_params, self._aux_params
        self.bind(data_shapes, label_shapes, self.for_training,
                  self.inputs_need_grad, force_rebind=True)
        if was_init:
            self.params_initialized = False
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params)

    # -- optimizer ------------------------------------------------------
    def _effective_rescale(self, kvstore):
        """1/batch normalization, folding in the worker count for
        sync-dist kvstores (reference: module.py:505)."""
        batch_size = self._exec_group.batch_size
        if kvstore and "dist" in kvstore.type and "_sync" in kvstore.type:
            batch_size *= kvstore.num_workers
        return 1.0 / batch_size

    def _materialize_optimizer(self, optimizer, optimizer_params,
                               kvstore, update_on_kvstore):
        rescale_grad = self._effective_rescale(kvstore)
        if isinstance(optimizer, str):
            kw = dict(optimizer_params)
            kw.setdefault("rescale_grad", rescale_grad)
            names = self._exec_group.param_names
            idx2name = dict(enumerate(names))
            if not update_on_kvstore:
                # reference keys updater slots per (param, device); one
                # device here
                idx2name = {i * len(self._context) + k: n
                            for i, n in enumerate(names)
                            for k in range(len(self._context))}
            return opt.create(optimizer, sym=self.symbol,
                              param_idx2name=idx2name, **kw)
        assert isinstance(optimizer, opt.Optimizer)
        if optimizer.rescale_grad != rescale_grad:
            self.logger.warning(
                "Optimizer created manually outside Module but "
                "rescale_grad is not normalized to 1.0/batch_size/"
                "num_workers (%s vs. %s).",
                optimizer.rescale_grad, rescale_grad)
        return optimizer

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """Install optimizer + kvstore (reference: module.py:473)."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, "
                                "ignoring...")
            return
        if self._params_dirty:
            self._sync_params_from_devices()

        kvstore, update_on_kvstore = _create_kvstore(
            kvstore, len(self._context), self._arg_params)
        self._optimizer = self._materialize_optimizer(
            optimizer, optimizer_params, kvstore, update_on_kvstore)
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._updater = None

        if kvstore:
            if self._compression_params:
                kvstore.set_gradient_compression(
                    self._compression_params)
            _initialize_kvstore(
                kvstore=kvstore,
                param_arrays=self._exec_group.param_arrays,
                arg_params=self._arg_params,
                param_names=self._param_names,
                update_on_kvstore=update_on_kvstore)
        if update_on_kvstore:
            kvstore.set_optimizer(self._optimizer)
        else:
            self._updater = opt.get_updater(self._optimizer)

        self.optimizer_initialized = True
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def borrow_optimizer(self, shared_module):
        """Share optimizer state with another module (reference:
        module.py:568 — used by BucketingModule)."""
        assert shared_module.optimizer_initialized
        for attr in ("_optimizer", "_kvstore", "_update_on_kvstore",
                     "_updater"):
            setattr(self, attr, getattr(shared_module, attr))
        self.optimizer_initialized = True

    # -- compute --------------------------------------------------------
    def _batch_shape_change(self, data_batch):
        """Return (new_data_shapes, new_label_shapes) if this batch
        needs a rebind, else None (reference: module.py:601 dynamic
        reshape on shape change)."""
        batch = data_batch[0] if isinstance(data_batch, list) \
            else data_batch
        new_shapes = tuple(d.shape for d in batch.data)
        if new_shapes == tuple(i.shape for i in self._data_shapes):
            return None
        if getattr(data_batch, "provide_data", None):
            dshape = data_batch.provide_data
        else:
            dshape = [(i.name, s)
                      for i, s in zip(self._data_shapes, new_shapes)]
        if getattr(data_batch, "provide_label", None):
            lshape = data_batch.provide_label
        elif getattr(data_batch, "label", None):
            lshape = [(i.name, j.shape)
                      for i, j in zip(self._label_shapes,
                                      data_batch.label)]
        else:
            lshape = None
        return dshape, lshape

    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        change = self._batch_shape_change(data_batch)
        if change is not None:
            self.reshape(*change)
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        self._exec_group.backward(out_grads=out_grads)

    def update(self):
        """Apply optimizer to gradients (reference: module.py:643)."""
        assert self.binded and self.params_initialized and \
            self.optimizer_initialized
        self._params_dirty = True
        if self._update_on_kvstore:
            _update_params_on_kvstore(self._exec_group.param_arrays,
                                      self._exec_group.grad_arrays,
                                      self._kvstore,
                                      self._exec_group.param_names)
        else:
            _update_params(self._exec_group.param_arrays,
                           self._exec_group.grad_arrays,
                           updater=self._updater, num_device=1,
                           kvstore=self._kvstore,
                           param_names=self._exec_group.param_names)

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._exec_group.get_outputs(
            merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized and \
            self.inputs_need_grad
        return self._exec_group.get_input_grads(
            merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._exec_group.update_metric(eval_metric, labels, pre_sliced)

    # -- state sync / io ------------------------------------------------
    def _sync_params_from_devices(self):
        self._exec_group.get_params(self._arg_params, self._aux_params)
        self._params_dirty = False

    def save_optimizer_states(self, fname):
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
        else:
            from ..resilience.atomic import atomic_write
            with atomic_write(fname) as fout:
                fout.write(self._updater.get_states())

    def load_optimizer_states(self, fname):
        assert self.optimizer_initialized
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
        else:
            with open(fname, "rb") as f:
                self._updater.set_states(f.read())

    def install_monitor(self, mon):
        assert self.binded
        self._exec_group.install_monitor(mon)

    def prepare(self, data_batch, sparse_row_id_fn=None):
        pass
