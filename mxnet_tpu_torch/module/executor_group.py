"""The executor group of a Module (counterpart of
mxnet_tpu/module/executor_group.py: `DataParallelExecutorGroup` :38;
reference: python/mxnet/module/executor_group.py:143).

One executor over the whole batch on the module's one context. The
reference slices the batch over its devices with one executor each; the
JAX package shards one program over a device mesh; the port runs one
card, so the per-device lists that the kvstore and the updater see have
length 1. Batches are copied into the bound input arrays in place (a
host batch goes to the card there).
"""
from __future__ import annotations

import logging

import torch

from ..base import MXNetError
from ..ndarray import NDArray
from ..io import DataDesc

__all__ = ["DataParallelExecutorGroup"]


def _as_data_desc(x):
    if isinstance(x, DataDesc):
        return x
    return DataDesc(x[0], x[1])


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=logging, fixed_param_names=None,
                 grad_req="write", state_names=None):
        self.symbol = symbol
        self.contexts = contexts
        self.param_names = param_names
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.fixed_param_names = set(fixed_param_names or [])
        self.state_names = set(state_names or [])
        self.logger = logger

        self.data_shapes = [_as_data_desc(d) for d in data_shapes]
        self.label_shapes = [_as_data_desc(l) for l in label_shapes] \
            if label_shapes else []
        self.data_names = [d.name for d in self.data_shapes]
        self.label_names = [l.name for l in self.label_shapes]
        self.batch_size = self.data_shapes[0].shape[0]

        arg_names = symbol.list_arguments()
        self.arg_names = arg_names
        self.aux_names = symbol.list_auxiliary_states()
        input_names = set(self.data_names + self.label_names)

        # grad_req per arg (reference: executor_group.py:213)
        if isinstance(grad_req, str):
            base_req = grad_req
            req = {}
            for name in arg_names:
                if name in self.param_names:
                    req[name] = "null" if (not for_training or
                                           name in self.fixed_param_names) \
                        else base_req
                elif name in input_names:
                    req[name] = base_req if (inputs_need_grad and
                                             name in self.data_names) \
                        else "null"
                else:
                    req[name] = "null"
        else:
            req = dict(grad_req)
        self._grad_req = req

        if len(contexts) > 1:
            raise MXNetError(
                "the port binds a module on one context, got %d"
                % len(contexts))

        shapes = {d.name: d.shape for d in
                  self.data_shapes + self.label_shapes}
        shared_exec = shared_group.execs[0] if shared_group is not None \
            else None
        self.exec_ = symbol.simple_bind(
            contexts[0], grad_req=req, shared_exec=shared_exec,
            **shapes)
        self.execs = [self.exec_]
        # param/grad arrays: list over params of per-"device" lists (len 1)
        self.param_arrays = [[self.exec_.arg_dict[n]] for n in
                             self.param_names]
        self.grad_arrays = [[self.exec_.grad_dict[n]]
                            if n in self.exec_.grad_dict else [None]
                            for n in self.param_names]
        self.aux_arrays = [[self.exec_.aux_dict[n]] for n in self.aux_names]
        self.slices = [slice(0, self.batch_size)]

    # ------------------------------------------------------------------
    def _place_input(self, name, value):
        data = value._data if isinstance(value, NDArray) \
            else torch.as_tensor(value)
        tgt = self.exec_.arg_dict[name]
        if tuple(data.shape) != tgt.shape:
            raise MXNetError(
                "input %r shape %s does not match bound shape %s (rebind "
                "for a new batch size)" % (name, tuple(data.shape), tgt.shape))
        with torch.no_grad():
            tgt._data.copy_(data)

    def forward(self, data_batch, is_train=None):
        if is_train is None:
            is_train = self.for_training
        for name, value in zip(self.data_names, data_batch.data):
            self._place_input(name, value)
        if self.label_names and data_batch.label:
            for name, value in zip(self.label_names, data_batch.label):
                self._place_input(name, value)
        self.exec_.forward(is_train=is_train)

    def backward(self, out_grads=None):
        assert self.for_training, "re-bind with for_training=True"
        self.exec_.backward(out_grads=out_grads)

    # ------------------------------------------------------------------
    def get_outputs(self, merge_multi_context=True, begin=0, end=None):
        outs = self.exec_.outputs
        if end is not None or begin:
            outs = outs[begin:end]
        return outs if merge_multi_context else [[o] for o in outs]

    def get_input_grads(self, merge_multi_context=True):
        assert self.inputs_need_grad
        grads = [self.exec_.grad_dict.get(n) for n in self.data_names]
        return grads if merge_multi_context else [[g] for g in grads]

    def get_params(self, arg_params, aux_params):
        with torch.no_grad():
            for name in self.param_names:
                arg_params[name]._data.copy_(self.exec_.arg_dict[name]._data)
            for name in self.aux_names:
                aux_params[name]._data.copy_(self.exec_.aux_dict[name]._data)

    def set_params(self, arg_params, aux_params, allow_extra=False):
        self.exec_.copy_params_from(arg_params, aux_params,
                                    allow_extra_params=allow_extra)

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        labels_ = labels
        if pre_sliced:
            labels_ = labels[0]
        eval_metric.update_dict(
            dict(zip(self.label_names, labels_)),
            dict(zip(self.symbol.list_outputs(), self.exec_.outputs)))

    def install_monitor(self, mon):
        for exe in self.execs:
            mon.install(exe)
