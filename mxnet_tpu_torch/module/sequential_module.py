"""SequentialModule: chain of modules executed in order.

Reference: python/mxnet/module/sequential_module.py (SequentialModule —
add() with META_TAKE_LABELS/META_AUTO_WIRING, bind() threads each
module's output shapes into the next module's data shapes, forward
chains activations, backward chains gradients in reverse).

Counterpart of mxnet_tpu/module/sequential_module.py, copied: it imports
no jax.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..initializer import Uniform
from .base_module import BaseModule

__all__ = ["SequentialModule"]


class SequentialModule(BaseModule):
    """A container module chaining sub-modules like a pipeline."""

    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._modules = []
        self._metas = []
        self._label_shapes = None
        self._data_shapes = None
        self._meta_keys = {self.META_TAKE_LABELS, self.META_AUTO_WIRING}

    def add(self, module, **kwargs):
        """Add a module. kwargs: take_labels=True for the module that
        consumes the loss labels; auto_wiring=True renames the previous
        module's outputs onto this module's data names."""
        self._modules.append(module)
        for key in kwargs:
            if key not in self._meta_keys:
                raise MXNetError("unknown meta %r (have %s)"
                                 % (key, sorted(self._meta_keys)))
        self._metas.append(kwargs)
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self  # chaining, like the reference

    # -- properties -----------------------------------------------------
    @property
    def data_names(self):
        if self._modules:
            return self._modules[0].data_names
        return []

    @property
    def output_names(self):
        if self._modules:
            return self._modules[-1].output_names
        return []

    @property
    def data_shapes(self):
        assert self.binded
        return self._modules[0].data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._modules[-1].output_shapes

    # -- params ---------------------------------------------------------
    def get_params(self):
        assert self.binded and self.params_initialized
        arg_params, aux_params = {}, {}
        for m in self._modules:
            arg, aux = m.get_params()
            arg_params.update(arg)
            aux_params.update(aux)
        return arg_params, aux_params

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded
        for m in self._modules:
            m.init_params(initializer=initializer, arg_params=arg_params,
                          aux_params=aux_params,
                          allow_missing=allow_missing,
                          force_init=force_init, allow_extra=True)
        # check no duplicate names across sub-modules (reference does too)
        seen = {}
        for i, m in enumerate(self._modules):
            arg, aux = m.get_params()
            for name in list(arg) + list(aux):
                if name in seen:
                    raise MXNetError(
                        "duplicate parameter %r in modules %d and %d"
                        % (name, seen[name], i))
                seen[name] = i
        self.params_initialized = True

    # -- bind -----------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False,
             shared_module=None, grad_req="write"):
        if self.binded and not force_rebind:
            return
        if not self._modules:
            raise MXNetError("SequentialModule: no modules added")
        assert shared_module is None, \
            "shared_module not supported for SequentialModule"
        self._label_shapes = label_shapes

        my_data_shapes = data_shapes
        anybody_ever_needs_label = False
        for i, (module, meta) in enumerate(zip(self._modules, self._metas)):
            meta_take_labels = meta.get(self.META_TAKE_LABELS, False)
            if meta_take_labels:
                my_label_shapes = label_shapes
                anybody_ever_needs_label = True
            else:
                my_label_shapes = None
            my_inputs_need_grad = for_training and (
                inputs_need_grad or i > 0)
            if meta.get(self.META_AUTO_WIRING, False) and i > 0:
                data_names = module.data_names
                assert len(data_names) == len(my_data_shapes)
                my_data_shapes = [(new, shape) for new, (_, shape)
                                  in zip(data_names, my_data_shapes)]
            module.bind(data_shapes=my_data_shapes,
                        label_shapes=my_label_shapes,
                        for_training=for_training,
                        inputs_need_grad=my_inputs_need_grad,
                        force_rebind=force_rebind, grad_req=grad_req)
            my_data_shapes = self._module_output_shapes(module,
                                                        my_data_shapes)
        if not anybody_ever_needs_label:
            self._label_shapes = None
        self.binded = True
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad

    @staticmethod
    def _module_output_shapes(module, in_shapes):
        """Output shapes at bind time: Module's executor reports shapes
        only after a forward, so chain-wiring uses symbolic shape
        inference (the reference reads output_shapes, whose nnvm graph
        infers statically)."""
        shapes = module.output_shapes
        if shapes:
            return shapes
        known = {name: tuple(shape) for name, shape in in_shapes}
        _, out_shapes, _ = module.symbol.infer_shape_partial(**known)
        return list(zip(module.output_names, out_shapes))

    # -- optimizer ------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        assert self.binded and self.params_initialized
        for m in self._modules:
            m.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                             optimizer_params=optimizer_params,
                             force_init=force_init)
        self.optimizer_initialized = True

    # -- compute --------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        assert self.binded and self.params_initialized
        from ..io import DataBatch
        batch = data_batch
        for i, module in enumerate(self._modules):
            module.forward(batch, is_train=is_train)
            if i == len(self._modules) - 1:
                break
            batch = DataBatch(module.get_outputs(),
                              label=data_batch.label,
                              pad=getattr(data_batch, "pad", None))

    def backward(self, out_grads=None):
        assert self.binded and self.params_initialized
        for i, module in reversed(list(enumerate(self._modules))):
            module.backward(out_grads=out_grads)
            if i == 0:
                break
            out_grads = module.get_input_grads()

    def update(self):
        assert self.binded and self.params_initialized \
            and self.optimizer_initialized
        for m in self._modules:
            m.update()

    def get_outputs(self, merge_multi_context=True):
        assert self.binded and self.params_initialized
        return self._modules[-1].get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        assert self.binded and self.params_initialized \
            and self.inputs_need_grad
        return self._modules[0].get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        assert self.binded and self.params_initialized
        for meta, module in zip(self._metas, self._modules):
            if meta.get(self.META_TAKE_LABELS, False):
                module.update_metric(eval_metric, labels, pre_sliced)

    def install_monitor(self, mon):
        assert self.binded
        for m in self._modules:
            m.install_monitor(mon)
