"""KVStore: key-value parameter synchronization (counterpart of
mxnet_tpu/kvstore.py: `_push_retry_policy` :71, `KVStore` :126, `init`
:153, `push`/`push_all` :179-206, the batched-update scope
`_begin_update_batch`/`_flush_update_batch` :213-242, `pull`/`pull_all`
:317-338, `row_sparse_pull` :348, `set_optimizer` :380,
`set_gradient_compression` :386, `set_bucket_size_mb` :402,
`save_optimizer_states`/`load_optimizer_states` :408-416, `create` :446).

Types 'local', 'device' and 'nccl' are one process: a push sums the
values given for a key (one value: that tensor itself, nothing copied)
and either stores the sum or, after `set_optimizer`, runs the updater on
the store's own copy of the weight (``update_on_kvstore``); a pull copies
the stored value into the targets, skipping a target that is the stored
tensor itself. A batched push hands all of its keys to the updater's
`update_all` at once, so a `FusedUpdater` fuses them (per key when a key
repeats: each occurrence runs the updater once). Values and targets are
tensors or NDArrays (whose tensors are used: a pull into an NDArray
writes its storage in place). With 2-bit compression on a 'device'
store, each value of a key is compressed (its residual per key and
slot) before the sum.

'dist_sync', 'dist_device_sync', 'tpu_dist' and 'dist' are the
cross-process store, `parallel.kvstore_dist.DistKVStore`, over
torch.distributed. 'dist_async' raises: asynchronous updates have no
counterpart in a synchronous collective (the JAX package's documented
gap). Row-sparse pulls wait for sparse storage.

Counters: ``kvstore.push.{bytes,calls,seconds}`` and
``kvstore.pull.{bytes,calls,seconds}``. A push survives a
`TransientError` by re-running the key's push (``MXTPU_KV_PUSH_RETRIES``,
``MXTPU_RETRY_BASE_DELAY_S``); nothing is mutated before the point that
can raise it.
"""
from __future__ import annotations

import time

import torch

from . import optimizer as opt
from .base import MXNetError, getenv
from .observability import registry as _obs
from .resilience.atomic import atomic_write
from .resilience.retry import RetryPolicy, TransientError, retry_call

__all__ = ["KVStore", "create"]

_DIST = ("dist_sync", "dist_device_sync", "tpu_dist", "dist")

_PUSH_BYTES = _obs.counter("kvstore.push.bytes",
                           "Gradient bytes pushed into the kvstore")
_PUSH_CALLS = _obs.counter("kvstore.push.calls")
_PUSH_SECONDS = _obs.histogram("kvstore.push.seconds",
                               "Wall time of one push() call (all keys)")
_PULL_BYTES = _obs.counter("kvstore.pull.bytes",
                           "Parameter bytes pulled out of the kvstore")
_PULL_CALLS = _obs.counter("kvstore.pull.calls")
_PULL_SECONDS = _obs.histogram("kvstore.pull.seconds",
                               "Wall time of one pull() call (all keys)")


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


def _values(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _nbytes(value):
    return sum(t.numel() * t.element_size() for t in _values(value))


def _sum(vals):
    """The values' sum; one value is itself."""
    total = vals[0]
    for extra in vals[1:]:
        total = total + extra
    return total


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


def _push_retry_policy():
    """A push re-runs a key's push after a `TransientError` only: an
    arbitrary error part-way through a mutation is not safe to replay."""
    return RetryPolicy(
        max_attempts=getenv("MXTPU_KV_PUSH_RETRIES", 8),
        base_delay=getenv("MXTPU_RETRY_BASE_DELAY_S", 0.02),
        max_delay=1.0, retry_on=(TransientError,), what="kvstore.push")


class KVStore:
    """Single-process KVStore ('local', 'device', 'nccl')."""

    def __init__(self, kv_type="local"):
        self.type = kv_type
        self._data = {}
        self._updater = None
        self._optimizer = None
        self._compression = None
        # while a batched push collects, merged values land here instead
        # of running the updater per key
        self._pending_updates = None
        self._push_retry_pol = None

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
            self._data[k] = _values(v)[0].detach().clone(
                memory_format=torch.contiguous_format)

    def _after_merge(self, merged, key):
        """Between the local sum and the store or update: the
        cross-process store's exchange."""
        return merged

    def _push_policy(self):
        if self._push_retry_pol is None:
            self._push_retry_pol = _push_retry_policy()
        return self._push_retry_pol

    def push(self, key, value, priority=0):
        keys, values = _key_value(key, value)
        self.push_all(keys, values, priorities=[priority] * len(keys))

    def push_all(self, key, value, priorities=None):
        """Push many keys, in stable descending-priority order; with an
        updater whose keys are unique, every key's sum goes to ONE
        `update_all` call."""
        keys, values = _key_value(key, value)
        for k in keys:
            if k not in self._data:
                raise MXNetError("key %r not initialized" % (k,))
        t0 = time.perf_counter()
        policy = self._push_policy()
        batch = self._begin_update_batch(keys)
        try:
            for j in _priority_order(len(keys), priorities):
                retry_call(self._push_one, keys[j], values[j],
                           policy=policy)
        finally:
            self._flush_update_batch(batch)
        self._count_push(values, t0)

    @staticmethod
    def _count_push(values, t0):
        _PUSH_BYTES.inc(sum(_nbytes(v) for v in values))
        _PUSH_CALLS.inc()
        _PUSH_SECONDS.observe(time.perf_counter() - t0)

    def _begin_update_batch(self, keys):
        """Open a batched-update scope, or return None: no updater, one
        without `update_all`, a scope already open, or a repeated key
        (which runs the updater once per occurrence)."""
        if self._pending_updates is not None or self._updater is None \
                or not hasattr(self._updater, "update_all") \
                or len(set(keys)) != len(keys):
            return None
        self._pending_updates = {}
        return self._pending_updates

    def _flush_update_batch(self, batch):
        """Close the scope: the collected sums in one `update_all`, in
        issue order. A retried push overwrote its own slot."""
        if batch is None:
            return
        self._pending_updates = None
        if batch:
            keys = list(batch)
            self._updater.update_all([_updater_key(k) for k in keys],
                                     [batch[k] for k in keys],
                                     [self._data[k] for k in keys])

    def _push_one(self, k, v):
        """One key's push, the retry unit."""
        vals = _values(v)
        comp = self._compression
        if comp is not None and "dist" not in self.type \
                and comp.active_for(vals[0]):
            # 'device' store: each slot's value is compressed before the
            # sum; the dist store compresses at the wire instead
            merged = _sum([comp.roundtrip((k, i), a)
                           for i, a in enumerate(vals)])
        else:
            merged = _sum(vals)
        self._apply_merged(k, self._after_merge(merged, k))

    def _apply_merged(self, k, merged):
        """Land a reduced value: run the updater (or queue it in the open
        batch), or store it."""
        if self._updater is None:
            self._data[k] = merged
        elif self._pending_updates is not None:
            self._pending_updates[k] = merged
        else:
            self._updater(_updater_key(k), merged, self._data[k])

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        keys, outs = _key_value(key, out)
        self.pull_all(keys, outs, priorities=[priority] * len(keys),
                      ignore_sparse=ignore_sparse)

    def pull_all(self, key, out=None, priorities=None, ignore_sparse=True):
        """Copy each key's stored value into its target(s), in place."""
        keys, outs = _key_value(key, out)
        t0 = time.perf_counter()
        nbytes = 0
        with torch.no_grad():
            for j in _priority_order(len(keys), priorities):
                k, o = keys[j], outs[j]
                if k not in self._data:
                    raise MXNetError("key %r not initialized" % (k,))
                src = self._data[k]
                for t in _values(o):
                    if t is not src:
                        t.copy_(src)
                    nbytes += src.numel() * src.element_size()
        _PULL_BYTES.inc(nbytes)
        _PULL_CALLS.inc()
        _PULL_SECONDS.observe(time.perf_counter() - t0)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        raise MXNetError("row_sparse_pull: row-sparse storage is not "
                         "ported yet; pull the dense value")

    def set_optimizer(self, optimizer):
        """Run `optimizer` in the store (the reference's servers; here
        this process)."""
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)

    def set_gradient_compression(self, compression_params):
        """2-bit compression with error feedback (``{"type": "2bit",
        "threshold": t}``; type "none" turns it off), on 'device' and the
        distributed types."""
        if not ("device" in self.type or "dist" in self.type):
            raise MXNetError("Gradient compression is not supported for "
                             "this type of kvstore")
        params = dict(compression_params)
        if params.get("type", "2bit") == "none":
            self._compression = None
            return
        from .gradient_compression import GradientCompression
        self._compression = GradientCompression.from_params(params)

    def set_bucket_size_mb(self, mb):
        """Retarget the exchange's fusion buckets: a no-op here, where
        nothing crosses processes."""

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
        from .parallel.kvstore_dist import DistKVStore
        return DistKVStore(name)
    if name == "dist_async":
        raise MXNetError("kvstore 'dist_async': asynchronous updates have "
                         "no counterpart in a synchronous collective; use "
                         "'dist_sync'")
    raise MXNetError("unknown kvstore type %r" % name)
