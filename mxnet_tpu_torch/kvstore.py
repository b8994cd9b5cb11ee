"""KVStore on one process (counterpart of mxnet_tpu/kvstore.py: `KVStore`
:126, `init` :153, `push`/`push_all` :179-186, `pull`/`pull_all`
:317-324, `set_optimizer` :380, `save_optimizer_states` /
`load_optimizer_states` :408-416, `create` :446).

Types 'local', 'device' and 'nccl' on one device: a push sums the values
given for a key (one value: that tensor itself, nothing copied) and
either stores the sum or, after `set_optimizer`, runs the updater on the
store's own copy of the weight (``update_on_kvstore``); a pull copies the
stored value into the targets, skipping a target that is the stored
tensor itself. A batched push hands all of its keys to the updater's
`update_all` at once, so a `FusedUpdater` fuses them. Values and targets
are tensors or NDArrays (whose tensors are used: a pull into an NDArray
writes its storage in place). The distributed types are not ported yet
and raise.
"""
from __future__ import annotations

import torch

from . import optimizer as opt
from .base import MXNetError
from .resilience.atomic import atomic_write

__all__ = ["KVStore", "create"]

_DIST = ("dist_sync", "dist_device_sync", "dist_async", "tpu_dist", "dist")


def _tensor(v):
    """NDArrays (also inside lists) as their tensors."""
    from .ndarray import NDArray
    if isinstance(v, NDArray):
        return v._data
    if isinstance(v, (list, tuple)):
        return type(v)(_tensor(x) for x in v)
    return v


def _key_value(key, value):
    if isinstance(key, (list, tuple)):
        if value is None:
            return list(key), [None] * len(key)
        if len(key) != len(value):
            raise MXNetError("got %d keys and %d values"
                             % (len(key), len(value)))
        return list(key), [_tensor(v) for v in value]
    return [key], [_tensor(value)]


def _priority_order(n, priorities):
    """Stable descending priority (kvstore.py:109): higher issues first,
    ties in caller order."""
    if priorities is None:
        return list(range(n))
    pr = list(priorities)
    if len(pr) != n:
        raise MXNetError("got %d priorities for %d keys" % (len(pr), n))
    return sorted(range(n), key=lambda j: -pr[j])


def _updater_key(k):
    if isinstance(k, str) and k.isdigit():
        return int(k)
    return k


class KVStore:
    """Single-process KVStore ('local', 'device', 'nccl')."""

    def __init__(self, kv_type="local"):
        self.type = kv_type
        self._data = {}
        self._updater = None
        self._optimizer = None

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def init(self, key, value):
        """Store a copy of each value (a list: its first)."""
        keys, values = _key_value(key, value)
        for k, v in zip(keys, values):
            if k in self._data:
                raise MXNetError("key %r already initialized" % (k,))
            val = v[0] if isinstance(v, (list, tuple)) else v
            self._data[k] = val.detach().clone(
                memory_format=torch.contiguous_format)

    def push(self, key, value, priority=0):
        keys, values = _key_value(key, value)
        self.push_all(keys, values, priorities=[priority] * len(keys))

    def push_all(self, key, value, priorities=None):
        """Push many keys: each key's values are summed; with an updater
        every key's sum goes to ONE `update_all` call."""
        keys, values = _key_value(key, value)
        merged = {}
        for j in _priority_order(len(keys), priorities):
            k, v = keys[j], values[j]
            if k not in self._data:
                raise MXNetError("key %r not initialized" % (k,))
            vals = list(v) if isinstance(v, (list, tuple)) else [v]
            total = vals[0]
            for extra in vals[1:]:
                total = total + extra
            merged[k] = total
        if self._updater is None:
            self._data.update(merged)
            return
        if len(set(keys)) != len(keys):
            raise MXNetError("push_all: a key appears twice in %s" % (keys,))
        order = list(merged)
        self._updater.update_all([_updater_key(k) for k in order],
                                 [merged[k] for k in order],
                                 [self._data[k] for k in order])

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        keys, outs = _key_value(key, out)
        self.pull_all(keys, outs, priorities=[priority] * len(keys),
                      ignore_sparse=ignore_sparse)

    def pull_all(self, key, out=None, priorities=None, ignore_sparse=True):
        """Copy each key's stored value into its target(s), in place."""
        keys, outs = _key_value(key, out)
        with torch.no_grad():
            for j in _priority_order(len(keys), priorities):
                k, o = keys[j], outs[j]
                if k not in self._data:
                    raise MXNetError("key %r not initialized" % (k,))
                src = self._data[k]
                for t in (o if isinstance(o, (list, tuple)) else [o]):
                    if t is not src:
                        t.copy_(src)

    def set_optimizer(self, optimizer):
        """Run `optimizer` in the store (the reference's servers; here
        this process)."""
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("there is no optimizer / updater")
        with atomic_write(fname) as f:
            f.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("there is no optimizer / updater")
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    def barrier(self):
        pass


def create(name="local"):
    """A KVStore by type name (kvstore.py:446)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name in ("local", "local_allreduce_cpu", "local_allreduce_device",
                "device", "nccl"):
        return KVStore(name)
    if name in _DIST:
        raise MXNetError("kvstore %r: the distributed store is not ported "
                         "yet (one process, one device)" % name)
    raise MXNetError("unknown kvstore type %r" % name)
