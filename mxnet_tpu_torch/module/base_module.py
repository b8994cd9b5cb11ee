"""BaseModule: the high-level train/predict interface (counterpart of
mxnet_tpu/module/base_module.py: `fit` :175, `score` :100, `predict` :145,
`forward_backward` :94, `init_params` :381; reference:
python/mxnet/module/base_module.py).

The fit loop keeps the JAX package's one-batch lookahead (the last batch
is known as such before its callbacks run) without its background
prefetch thread, which waits with the record iterators (ROADMAP A7); its
step timer, numerics guard and preemption boundary wait for the
operational planes (ROADMAP A9).
"""
from __future__ import annotations

import logging
import time

import numpy as np

from ..base import MXNetError
from .. import metric as metric_mod
from .. import io as mx_io
from ..model import BatchEndParam
from ..initializer import Uniform
from ..ndarray import NDArray


_PARAM_SUFFIXES = ("_weight", "_bias", "_gamma", "_beta")


def _check_input_names(symbol, names, typename, throw):
    """Validate declared data/label names against the symbol's free
    arguments (reference role: base_module.py:33)."""
    args = symbol.list_arguments()
    missing = [n for n in names if n not in args]
    if not missing:
        return
    # suggest the non-parameter arguments — those are the plausible
    # data/label slots the caller probably meant
    slots = [a for a in args if not a.endswith(_PARAM_SUFFIXES)]
    msg = ("%s_names=%s: %r is not among the symbol's arguments; "
           "plausible %s inputs of this symbol: %s"
           % (typename, list(names), missing[0], typename,
              ", ".join(slots) or "<none>"))
    if throw:
        raise ValueError(msg)
    logging.warning(msg)


class BaseModule:
    """Base of all modules (reference: base_module.py:62)."""

    def __init__(self, logger=logging):
        self.logger = logger
        self._symbol = None
        # lifecycle flags, flipped by bind/init_params/init_optimizer
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self.for_training = False
        self.inputs_need_grad = False

    def _require_bound_and_initialized(self):
        if not (self.binded and self.params_initialized):
            raise MXNetError("call bind() and init_params() first")

    # ------------------------------------------------------------------
    # properties subclasses provide
    # ------------------------------------------------------------------
    @property
    def data_names(self):
        raise NotImplementedError

    @property
    def output_names(self):
        raise NotImplementedError

    @property
    def data_shapes(self):
        raise NotImplementedError

    @property
    def label_shapes(self):
        raise NotImplementedError

    @property
    def output_shapes(self):
        raise NotImplementedError

    @property
    def symbol(self):
        return self._symbol

    # ------------------------------------------------------------------
    # convenience
    # ------------------------------------------------------------------
    def forward_backward(self, data_batch):
        """One forward and backward (reference: base_module.py:192)."""
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0, sparse_row_id_fn=None):
        """Evaluate (reference: base_module.py:176)."""
        self._require_bound_and_initialized()
        if reset:
            eval_data.reset()
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        seen = 0
        for batch in eval_data:
            if num_batch is not None and seen >= num_batch:
                break
            self.forward(batch, is_train=False)
            labels = ([b.label for b in batch]
                      if isinstance(batch, list) else batch.label)
            self.update_metric(eval_metric, labels,
                               pre_sliced=isinstance(batch, list))
            for cb in _as_list(batch_end_callback):
                cb(BatchEndParam(epoch=epoch, nbatch=seen,
                                 eval_metric=eval_metric, locals=locals()))
            seen += 1
        for cb in _as_list(score_end_callback):
            cb(BatchEndParam(epoch=epoch, nbatch=seen,
                             eval_metric=eval_metric, locals=locals()))
        return eval_metric.get_name_value()

    def _depadded_outputs(self, batch):
        """Forward outputs with the iterator's tail padding sliced away."""
        keep = None
        if getattr(batch, "pad", None):
            keep = -batch.pad
        return [o[:keep] if keep else o for o in self.get_outputs()]

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        self._require_bound_and_initialized()
        if reset:
            eval_data.reset()
        for i, batch in enumerate(eval_data):
            if num_batch is not None and i >= num_batch:
                break
            self.forward(batch, is_train=False)
            yield (self._depadded_outputs(batch), i, batch)

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False,
                sparse_row_id_fn=None):
        """Run prediction, collect outputs (reference: base_module.py:268)."""
        self._require_bound_and_initialized()
        if isinstance(eval_data, np.ndarray):
            eval_data = NDArray(eval_data)
        if isinstance(eval_data, NDArray):
            eval_data = mx_io.NDArrayIter(eval_data.asnumpy(),
                                          batch_size=eval_data.shape[0])
        if not isinstance(eval_data, mx_io.DataIter):
            raise ValueError("predict wants an NDArray, numpy array, or "
                             "DataIter; got %s" % type(eval_data).__name__)
        per_batch = [outs for outs, _, _ in
                     self.iter_predict(eval_data, num_batch=num_batch,
                                       reset=reset)]
        per_batch = [[o.copy() for o in outs] for outs in per_batch]
        if not per_batch or not merge_batches:
            return per_batch
        arity = {len(outs) for outs in per_batch}
        if len(arity) != 1:
            raise ValueError("cannot merge prediction batches with varying "
                             "output arity %s" % sorted(arity))
        from .. import ndarray as nd
        merged = [nd.concatenate([outs[i] for outs in per_batch])
                  for i in range(arity.pop())]
        if len(merged) == 1 and not always_output_list:
            return merged[0]
        return merged

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=Uniform(0.01), arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None):
        """Train the module (reference: base_module.py:399)."""
        assert num_epoch is not None, "please specify number of epochs"

        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)

        if validation_metric is None:
            validation_metric = eval_metric
        if not isinstance(eval_metric, metric_mod.EvalMetric):
            eval_metric = metric_mod.create(eval_metric)

        ################################################################
        # training loop (reference role: base_module.py:491-560)
        ################################################################
        for epoch in range(begin_epoch, num_epoch):
            started = time.time()
            eval_metric.reset()
            final_metrics = self._run_train_epoch(
                train_data, epoch, eval_metric, monitor,
                batch_end_callback, sparse_row_id_fn)

            for name, val in final_metrics:
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.time() - started)

            # checkpoint-consistency sync: pull the device params into the
            # host-side dicts epoch callbacks (do_checkpoint) will read
            synced_args, synced_aux = self.get_params()
            self.set_params(synced_args, synced_aux)
            for cb in _as_list(epoch_end_callback):
                cb(epoch, self.symbol, synced_args, synced_aux)

            if eval_data:
                for name, val in self.score(
                        eval_data, validation_metric,
                        score_end_callback=eval_end_callback,
                        batch_end_callback=eval_batch_end_callback,
                        epoch=epoch):
                    self.logger.info("Epoch[%d] Validation-%s=%f", epoch,
                                     name, val)
            train_data.reset()

    def _run_train_epoch(self, train_data, epoch, eval_metric, monitor,
                         batch_end_callback, sparse_row_id_fn):
        """One epoch of the fit loop, with one-batch lookahead: prepare()
        sees batch k+1 before batch k runs, and the last batch is known
        as such before its callbacks run."""
        final_metrics = []
        batches = iter(train_data)
        upcoming = next(batches, None)
        nbatch = 0
        while upcoming is not None:
            batch = upcoming
            upcoming = next(batches, None)
            is_last = upcoming is None
            if upcoming is not None:
                self.prepare(upcoming, sparse_row_id_fn=sparse_row_id_fn)
            if monitor is not None:
                monitor.tic()
            self.forward_backward(batch)
            self.update()
            if isinstance(batch, list):  # pre-sliced multi-device form
                self.update_metric(eval_metric, [b.label for b in batch],
                                   pre_sliced=True)
            else:
                self.update_metric(eval_metric, batch.label)
            if monitor is not None:
                monitor.toc_print()
            if is_last:
                # read before batch callbacks, which may reset metrics
                final_metrics = eval_metric.get_name_value()
            for cb in _as_list(batch_end_callback):
                cb(BatchEndParam(epoch=epoch, nbatch=nbatch,
                                 eval_metric=eval_metric, locals=locals()))
            nbatch += 1
        return final_metrics

    # ------------------------------------------------------------------
    # parameters
    # ------------------------------------------------------------------
    def get_params(self):
        raise NotImplementedError

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        raise NotImplementedError

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def save_params(self, fname):
        from .. import ndarray as nd
        args, auxs = self.get_params()
        nd.save(fname, dict(
            [("arg:" + k, v) for k, v in args.items()]
            + [("aux:" + k, v) for k, v in auxs.items()]))

    def load_params(self, fname):
        from .. import ndarray as nd
        groups = {"arg": {}, "aux": {}}
        for tagged, value in nd.load(fname).items():
            kind, _, name = tagged.partition(":")
            if kind not in groups or not name:
                raise ValueError(
                    "%s: entry %r is not arg:/aux:-tagged — not a Module "
                    "checkpoint" % (fname, tagged))
            groups[kind][name] = value
        self.set_params(groups["arg"], groups["aux"])

    # ------------------------------------------------------------------
    # computation interface subclasses provide
    # ------------------------------------------------------------------
    def prepare(self, data_batch, sparse_row_id_fn=None):
        pass

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        raise NotImplementedError

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError

    def install_monitor(self, mon):
        raise NotImplementedError


def _as_list(obj):
    if obj is None:
        return []
    if isinstance(obj, (list, tuple)):
        return list(obj)
    return [obj]
