"""Model helpers: checkpoint files, kvstore wiring, the update step
(counterpart of mxnet_tpu/model.py: `_create_kvstore` :23,
`_initialize_kvstore` :46, `_update_params_on_kvstore` :56,
`_update_params` :80, `save_checkpoint` :139, `load_checkpoint` :150;
reference: python/mxnet/model.py).

`_update_params` first tries the fused exchange + update step
(`parallel.fused_step`, ``MXTPU_FUSED_STEP``, default on) over the one
device's set, as `Module.fit`'s update; otherwise it takes the staged
path, the bit-parity oracle: the kvstore reduce (`push_all`/`pull_all`)
when there is a store, then one `update_all` of the whole set, which the
`FusedUpdater` runs as one launch of the `fused_sgd_momentum` kernel per
SGD group on the card. A store that runs the updater
(``update_on_kvstore``, the default of a distributed type) takes
`_update_params_on_kvstore`: one push, the store's batched update, one
pull.

Checkpoints are ``prefix-symbol.json`` and ``prefix-%04d.params`` with
``arg:``/``aux:`` entries, the files the JAX package reads and writes.
"""
from __future__ import annotations

from collections import namedtuple

from . import kvstore as kvs
from . import ndarray as nd
from . import symbol as sym

__all__ = ["BatchEndParam", "save_checkpoint", "load_checkpoint",
           "load_params"]

BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device, arg_params):
    """(kvstore or None, update_on_kvstore) from a str or instance
    (reference: model.py:55)."""
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if num_device == 1 and "dist" not in kvstore:
            kv = None
        else:
            kv = kvs.create(kvstore)
            if kvstore == "local":
                max_size = max(p.size for p in arg_params.values())
                if max_size > 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None:
        update_on_kvstore = False
    return (kv, update_on_kvstore)


def _tensors(arrs):
    return [a._data if isinstance(a, nd.NDArray) else a for a in arrs]


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    """One key per parameter, from `arg_params` (reference: model.py:105)."""
    for idx, param_on_devs in enumerate(param_arrays):
        name = param_names[idx]
        # the store's copy lives where the parameters do (arg_params are
        # host arrays): the updater then runs on the card
        kvstore.init(name, arg_params[name]._data.to(
            _tensors(param_on_devs)[0].device))
        if update_on_kvstore:
            kvstore.pull(name, _tensors(param_on_devs), priority=-idx)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore,
                              param_names):
    """Push the gradients, pull the updated weights, the whole set in one
    `push_all`/`pull_all` pair (reference: model.py:145)."""
    names, args, grads, prios = [], [], [], []
    for index, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                      grad_arrays)):
        if grad_list is None or grad_list[0] is None:
            continue
        names.append(param_names[index])
        args.append(_tensors(arg_list))
        grads.append(_tensors(grad_list))
        prios.append(-index)
    if not names:
        return
    kvstore.push_all(names, grads, priorities=prios)
    kvstore.pull_all(names, args, priorities=prios)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, param_names=None):
    """The local updater path (reference: model.py:157): the kvstore
    reduce of the whole gradient set when there is a store, then one
    `update_all` over (index, grad, weight)."""
    updates = [[] for _ in range(num_device)]
    names, kv_grads, prios = [], [], []
    for i, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                  grad_arrays)):
        if not isinstance(arg_list, (list, tuple)):
            arg_list, grad_list = [arg_list], [grad_list]
        if grad_list[0] is None:
            continue
        if kvstore:
            names.append(param_names[i])
            kv_grads.append(_tensors(grad_list))
            prios.append(-i)
        for k, (w, g) in enumerate(zip(_tensors(arg_list),
                                       _tensors(grad_list))):
            updates[k].append((i * num_device + k, g, w))
    if num_device == 1 and updates[0]:
        from .parallel import fused_step as _fstep
        idxs = [u[0] for u in updates[0]]
        if _fstep.eligible(updater, idxs, kvstore=kvstore or None) and \
                _fstep.try_step(updater, idxs, [u[1] for u in updates[0]],
                                [u[2] for u in updates[0]],
                                kvstore=kvstore or None):
            return
    if kvstore and names:
        kvstore.push_all(names, kv_grads, priorities=prios)
        kvstore.pull_all(names, kv_grads, priorities=prios)
    for dev_updates in updates:
        if not dev_updates:
            continue
        if hasattr(updater, "update_all"):
            updater.update_all([u[0] for u in dev_updates],
                               [u[1] for u in dev_updates],
                               [u[2] for u in dev_updates])
        else:
            for i, g, w in dev_updates:
                updater(i, g, w)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Write ``prefix-symbol.json`` and ``prefix-%04d.params``
    (reference: model.py:384)."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v for k, v in aux_params.items()})
    nd.save("%s-%04d.params" % (prefix, epoch), save_dict)


def load_checkpoint(prefix, epoch):
    """(symbol, arg_params, aux_params) of a checkpoint (reference:
    model.py:414); the arrays are host NDArrays."""
    symbol = sym.load("%s-symbol.json" % prefix)
    arg_params, aux_params = load_params(prefix, epoch)
    return (symbol, arg_params, aux_params)


def load_params(prefix, epoch):
    from .context import cpu
    with cpu():
        save_dict = nd.load("%s-%04d.params" % (prefix, epoch))
    arg_params = {}
    aux_params = {}
    for k, v in save_dict.items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        if tp == "aux":
            aux_params[name] = v
    return (arg_params, aux_params)
