"""DataLoader (counterpart of mxnet_tpu/gluon/data/dataloader.py:
`default_batchify_fn` :26, `default_mp_batchify_fn` :38, the worker pool
:120, `DataLoader` :140).

Batches are collated on the host (numpy, or the stacked host tensors of
NDArray samples) and moved to the current context once each, when the
loader yields them: ``with mx.cpu():`` keeps them on the CPU, the card is
the default. ``pin_memory=True`` pins the host batch and copies it with
``non_blocking=True``.

``num_workers > 0`` forks a pool of worker processes, as the JAX package
does. The parent has usually initialised CUDA, and a forked child that
touches CUDA dies, so the workers build numpy only
(`default_mp_batchify_fn`), with the CPU as their default context, and
hand the batch back through the pool's pipe, as the JAX package does;
only the parent makes NDArrays on the card. Batches come back in sampler
order, so a seed gives the same batches at any number of workers.
"""
from __future__ import annotations

import multiprocessing
import weakref

import numpy as np
import torch

from ...context import Context, current_context
from ...ndarray import NDArray
from . import sampler as _sampler

__all__ = ["DataLoader", "default_batchify_fn", "default_mp_batchify_fn"]


def default_batchify_fn(data):
    """Collate samples into a batch of NDArrays on the current context
    (dataloader.py:26)."""
    return _to_ctx(default_mp_batchify_fn(data), current_context(), False)


def default_mp_batchify_fn(data):
    """Collate samples into a host batch: numpy arrays, nested as the
    samples are (dataloader.py:38)."""
    if isinstance(data[0], NDArray):
        return np.stack([d.asnumpy() for d in data])
    if isinstance(data[0], torch.Tensor):
        return torch.stack([d.detach().cpu() for d in data]).numpy()
    if isinstance(data[0], tuple):
        return [default_mp_batchify_fn(i) for i in zip(*data)]
    return np.asarray(data)


def _host_tensor(a):
    """A host array as a tensor, with nd.array's defaults: float64 ->
    float32, int64 -> int32."""
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a))


def _to_ctx(batch, ctx, pin):
    """Host batch -> NDArrays on `ctx` (NDArrays a batchify_fn made stay
    as they are)."""
    if isinstance(batch, (list, tuple)):
        return [_to_ctx(b, ctx, pin) for b in batch]
    if isinstance(batch, NDArray):
        return batch
    t = batch if isinstance(batch, torch.Tensor) else _host_tensor(batch)
    dev = ctx.torch_device
    if dev.type == "cuda" and t.device.type == "cpu":
        if pin:
            t = t.pin_memory()
        return NDArray(t.to(dev, non_blocking=pin))
    return NDArray(t.to(dev))


_worker_dataset = None
_worker_batchify = None


def _worker_initializer(dataset, batchify_fn):
    global _worker_dataset, _worker_batchify
    _worker_dataset = dataset
    _worker_batchify = batchify_fn
    # nothing in a worker may reach the card: the CPU is its default
    Context("cpu").__enter__()
    # a forked child must not enter the parent's OpenMP pool (it can
    # hang there): host tensor work in a worker runs on one thread
    torch.set_num_threads(1)


def _worker_fn(samples):
    """Runs in a worker process (dataloader.py:152 worker_loop): the
    batch as host (numpy) arrays, which the pool pickles once."""
    return _host(_worker_batchify([_worker_dataset[i] for i in samples]))


def _host(batch):
    if isinstance(batch, (list, tuple)):
        return [_host(b) for b in batch]
    if isinstance(batch, NDArray):
        return batch.asnumpy()
    if isinstance(batch, torch.Tensor):
        return batch.detach().cpu().numpy()
    return batch


def _shut_down(pool):
    pool.terminate()
    pool.join()


class DataLoader:
    """Loads a Dataset in mini-batches (dataloader.py:140).

    `last_batch`: "keep" (default), "discard" or "rollover";
    `batchify_fn` collates a list of samples (default: host numpy,
    moved to the current context); `num_workers` worker processes
    collate batches ahead, `prefetch` of them (default 2 per worker);
    `pin_memory` pins host batches for an asynchronous copy to the
    card."""

    def __init__(self, dataset, batch_size=None, shuffle=False,
                 sampler=None, last_batch=None, batch_sampler=None,
                 batchify_fn=None, num_workers=0, pin_memory=False,
                 prefetch=None):
        self._dataset = dataset
        self._pin_memory = pin_memory
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError("batch_size must be specified unless "
                                 "batch_sampler is specified")
            if sampler is None:
                sampler = _sampler.RandomSampler(len(dataset)) if shuffle \
                    else _sampler.SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError("shuffle must not be specified if sampler "
                                 "is specified")
            batch_sampler = _sampler.BatchSampler(
                sampler, batch_size, last_batch if last_batch else "keep")
        elif (batch_size is not None or shuffle or sampler is not None or
              last_batch is not None):
            raise ValueError("batch_size, shuffle, sampler and last_batch "
                             "must not be specified if batch_sampler is "
                             "specified.")
        self._batch_sampler = batch_sampler
        self._num_workers = max(0, num_workers)
        self._prefetch = max(0, int(prefetch) if prefetch is not None
                             else 2 * self._num_workers)
        self._batchify_fn = batchify_fn or default_mp_batchify_fn
        self._pool = None
        if self._num_workers > 0:
            self._pool = multiprocessing.get_context("fork").Pool(
                self._num_workers, initializer=_worker_initializer,
                initargs=(self._dataset, self._batchify_fn))
            # the workers end with the loader, or at exit before the
            # interpreter tears its modules down
            weakref.finalize(self, _shut_down, self._pool)

    def __iter__(self):
        ctx = current_context()
        pin = self._pin_memory and ctx.device_type == "gpu"
        if self._num_workers == 0:
            for batch in self._batch_sampler:
                yield _to_ctx(self._batchify_fn(
                    [self._dataset[idx] for idx in batch]), ctx, pin)
            return
        pending = []
        it = iter(self._batch_sampler)
        for _ in range(self._prefetch + 1):
            try:
                pending.append(self._pool.apply_async(_worker_fn,
                                                      (next(it),)))
            except StopIteration:
                break
        while pending:
            batch = pending.pop(0).get()
            try:
                pending.append(self._pool.apply_async(_worker_fn,
                                                      (next(it),)))
            except StopIteration:
                pass
            yield _to_ctx(batch, ctx, pin)

    def __len__(self):
        return len(self._batch_sampler)
