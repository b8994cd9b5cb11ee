"""The cross-process synchronous KVStore over torch.distributed
(counterpart of mxnet_tpu/parallel/kvstore_dist.py: `init_distributed`
:100, `DistKVStore` :203, `set_bucket_size_mb` :226, `_after_merge` :246,
`push_all` :267, `_push_bucketed` :317, `_issue_bucket` :362,
`_bucket_sum_compressed` :388, `_cross_process_sum` :447,
`_cross_process_sum_compressed` :471, `barrier` :570; reference:
src/kvstore/kvstore_dist.h, types kvstore.cc:40-77).

There are no parameter servers: every process runs the same program and
a push is an allreduce. `init_distributed` reads the rendezvous that
`tools/launch.py` exports (``JAX_COORDINATOR_ADDRESS`` or
``COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` or ``DMLC_NUM_WORKER``,
``JAX_PROCESS_ID`` or ``DMLC_WORKER_ID``), meets its peers at a
`torch.distributed.TCPStore` on that address and calls
``torch.distributed.init_process_group(store=...)``; with none of them
set it does nothing and the store is one process.

Each rank's device is ``gpu(rank % torch.cuda.device_count())``, or the
CPU when the caller's context is ``mx.cpu()``; without a card and without
that, the store raises `DeviceUnreachable`. The backend is NCCL for a
rank on a card and gloo on the CPU; ``MXTPU_DIST_BACKEND`` (``nccl`` or
``gloo``) overrides it, as when two ranks share one card (NCCL refuses
that). A backend that fails to initialize raises: there is no fallback
from one to the other. gloo's collectives run in host memory: a CUDA
tensor goes to the host for them and comes back (the same arithmetic,
and one route for every op, whatever gloo covers on CUDA).

A push (`push_all`) sums each key's local values, packs the sums into
dtype-homogeneous fusion buckets (`parallel.bucketing`), and issues one
collective per bucket in priority order, asynchronously, so the host
packs the next bucket while the first is on the wire; then it unpacks
and stores the sums, or hands them to the updater in one `update_all`.
Repeated keys, and a bucket target of 0 (``MXTPU_BUCKET_MB`` or
`set_bucket_size_mb`), take the per-key path. The sum is
``all_reduce(SUM)``. With 2-bit compression, each bucket's sum is
quantized with per-key residuals, the packed words are all-gathered, and
every rank dequantizes and adds them in rank order, so every rank's
result is bit-identical. At one process no collective runs; a
compressing store still round-trips through the quantizer, so training
does not depend on the process count.

Timeouts, as JAX's: ``MXTPU_DIST_INIT_TIMEOUT_S`` bounds the rendezvous
alone; `barrier` waits at most ``MXTPU_BARRIER_TIMEOUT_S`` (default 600)
and a bucket's collective at most ``MXTPU_WATCHDOG_COLLECTIVE_S`` (default
0: the group's own timeout), then raises `DeadlineExceeded`.

Counters: ``kvstore.allreduce.{bytes,calls,seconds}`` (this process's
bytes entering each collective: packed words when compressed),
``kvstore.bucket.*`` and ``train.step.dispatches`` (one per collective).
"""
from __future__ import annotations

import datetime
import os
import threading
import time
import urllib.parse

import torch
import torch.distributed as dist
from torch.distributed.constants import default_pg_timeout

from ..base import MXNetError, getenv
from ..context import Context, resolve_device
from ..kvstore import (KVStore, _key_value, _priority_order, _sum, _values)
from ..observability import registry as _obs
from ..resilience import numerics as _num
from ..resilience.retry import (DeadlineExceeded, RetryPolicy,
                                TransientError, retry_call)
from .bucketing import (BUCKET_COUNT, BUCKET_FILL, BUCKET_KEYS,
                        PACK_SECONDS, UNPACK_SECONDS, GradBucketer,
                        finite_all)
from .fused_update import STEP_DISPATCHES as _STEP_DISPATCHES

__all__ = ["DistKVStore", "bounded_barrier", "init_distributed",
           "rank_device"]

_AR_BYTES = _obs.counter("kvstore.allreduce.bytes",
                         "Local bytes contributed to cross-process "
                         "allreduce/allgather collectives")
_AR_CALLS = _obs.counter("kvstore.allreduce.calls")
_AR_SECONDS = _obs.histogram("kvstore.allreduce.seconds",
                             "Wall time of one cross-process collective")

_BACKENDS = ("nccl", "gloo")


def _env_rank():
    r = os.environ.get("JAX_PROCESS_ID") or os.environ.get("DMLC_WORKER_ID")
    return int(r) if r else 0


def rank_device(rank=None):
    """This rank's device: the CPU under an ``mx.cpu()`` context, else
    ``cuda:(rank % device_count)`` (raises `DeviceUnreachable` without a
    card)."""
    if Context.default_ctx().device_type == "cpu":
        return torch.device("cpu")
    resolve_device("cuda")
    if rank is None:
        rank = dist.get_rank() if dist.is_initialized() else _env_rank()
    return torch.device("cuda", rank % torch.cuda.device_count())


def _backend(device):
    backend = getenv("MXTPU_DIST_BACKEND", "nccl" if device.type == "cuda"
                     else "gloo")
    if backend not in _BACKENDS:
        raise MXNetError("MXTPU_DIST_BACKEND=%r: want one of %s"
                         % (backend, _BACKENDS))
    if backend == "nccl" and device.type != "cuda":
        raise MXNetError("the nccl backend needs a rank on a card; this "
                         "rank's device is %s" % device)
    available = dist.is_nccl_available() if backend == "nccl" \
        else dist.is_gloo_available()
    if not available:
        raise MXNetError("torch.distributed has no %s backend in this "
                         "build" % backend)
    return backend


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Join the process group (the DMLC scheduler rendezvous's analog).
    A no-op when the group exists or no coordinator is configured.

    The rendezvous is a `TCPStore` at the coordinator's address (rank 0
    serves it). ``MXTPU_DIST_INIT_TIMEOUT_S`` (when set) bounds each
    attempt's waits on that store and nothing else, as JAX's
    ``initialization_timeout`` does: the group itself keeps torch's
    default timeout, so a collective that waits long for a slow peer is
    not cut at the init knob. A failed rendezvous is retried with
    exponential backoff (``MXTPU_DIST_INIT_RETRIES``, default 3;
    ``MXTPU_DIST_INIT_BACKOFF_S``, default 1.0)."""
    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None:
        coordinator_address = env.get("JAX_COORDINATOR_ADDRESS") or \
            env.get("COORDINATOR_ADDRESS")
    if coordinator_address is None:
        return
    if num_processes is None:
        n = env.get("JAX_NUM_PROCESSES") or env.get("DMLC_NUM_WORKER")
        num_processes = int(n) if n else 1
    if process_id is None:
        process_id = _env_rank()
    device = rank_device(process_id)
    backend = _backend(device)
    kwargs = {}
    timeout = getenv("MXTPU_DIST_INIT_TIMEOUT_S", 0.0)
    store_timeout = datetime.timedelta(seconds=timeout) if timeout > 0 \
        else default_pg_timeout
    if backend == "nccl":
        torch.cuda.set_device(device)
        # binds the group to the card and creates NCCL's communicator now
        kwargs["device_id"] = device
    url = urllib.parse.urlparse("tcp://%s" % coordinator_address)
    world, rank = int(num_processes), int(process_id)

    def _attempt():
        # multi_tenant: a retry in this process reuses rank 0's server
        store = dist.TCPStore(url.hostname, url.port, world,
                              is_master=rank == 0,
                              timeout=store_timeout, multi_tenant=True)
        dist.init_process_group(backend, store=store, world_size=world,
                                rank=rank, **kwargs)

    retry_call(_attempt, policy=RetryPolicy(
        max_attempts=getenv("MXTPU_DIST_INIT_RETRIES", 3),
        base_delay=getenv("MXTPU_DIST_INIT_BACKOFF_S", 1.0),
        max_delay=30.0,
        retry_on=(TransientError, ConnectionError, TimeoutError,
                  getattr(dist, "DistStoreError", TransientError)),
        what="dist.init"))


def wait_bounded(work, timeout_s, what):
    """Wait for a collective's `work`; with `timeout_s` > 0, at most that
    long, then raise `DeadlineExceeded` naming `what` and the budget (the
    collective is left to the backend). The host polls
    ``work.is_completed()`` and calls ``wait()`` once it is done: NCCL's
    ``wait()`` of a barrier synchronizes the host with the barrier's
    stream, whatever its timeout (ROADMAP C11). An error raised by the
    collective (a peer that closed its connection) propagates as it
    is."""
    if timeout_s <= 0:
        work.wait()
        return
    _poll(work, time.monotonic() + timeout_s, timeout_s, what)


def _poll(work, deadline, timeout_s, what):
    while not work.is_completed():
        left = deadline - time.monotonic()
        if left <= 0:
            raise DeadlineExceeded("%s did not complete within %gs"
                                   % (what, timeout_s))
        time.sleep(min(0.005, left))
    work.wait()


def bounded_barrier(timeout_s, what, device=None):
    """`torch.distributed.barrier` of the default group within `timeout_s`
    seconds (> 0), else `DeadlineExceeded` naming `what`. The barrier is
    started on a helper thread: NCCL sets a communicator's connections up
    on the host at its first collective, which blocks until every peer
    joins, so a peer that never comes would hold the caller inside the
    call itself (ROADMAP C11, seen on two cards). Past the deadline the
    helper is left behind, blocked, as the collective is; an error the
    barrier raised is raised here."""
    if timeout_s <= 0:
        dist.barrier()
        return
    deadline = time.monotonic() + timeout_s
    box = {}

    def start():
        try:
            if device is not None and device.type == "cuda":
                torch.cuda.set_device(device)
            box["work"] = dist.barrier(async_op=True)
        except Exception as err:      # noqa: BLE001 - raised on the caller
            box["error"] = err
    helper = threading.Thread(target=start, daemon=True,
                              name="mxtpu-barrier")
    helper.start()
    helper.join(timeout_s)
    if helper.is_alive():
        raise DeadlineExceeded("%s did not complete within %gs"
                               % (what, timeout_s))
    if "error" in box:
        raise box["error"]
    _poll(box["work"], deadline, timeout_s, what)


class _Pending:
    """A bucket's collective in flight: `result()` waits for it (at most
    ``MXTPU_WATCHDOG_COLLECTIVE_S`` when that is set) and returns the
    reduced flat on the flat's device."""

    __slots__ = ("_work", "_done", "_t0", "_timeout_s", "_what")

    def __init__(self, work, done, t0, timeout_s=0.0, what="collective"):
        self._work, self._done, self._t0 = work, done, t0
        self._timeout_s, self._what = timeout_s, what

    def result(self):
        wait_bounded(self._work, self._timeout_s, self._what)
        out = self._done()
        _AR_SECONDS.observe(time.perf_counter() - self._t0)
        return out


class DistKVStore(KVStore):
    """Cross-process synchronous KVStore (kvstore_dist.h:44)."""

    def __init__(self, kv_type="tpu_dist"):
        super().__init__(kv_type)
        init_distributed()
        self.device = rank_device()
        if dist.is_initialized():
            self._backend = dist.get_backend()
            self._nproc = dist.get_world_size()
        else:
            self._backend, self._nproc = None, 1
        self._bucketer = GradBucketer()        # MXTPU_BUCKET_MB
        # 0: a collective waits as long as the group's own timeout
        self._collective_timeout_s = getenv("MXTPU_WATCHDOG_COLLECTIVE_S",
                                            0.0)
        self.last_wire_bytes = 0

    def set_bucket_size_mb(self, mb):
        """Retarget the fusion buckets (over ``MXTPU_BUCKET_MB``; 0: the
        per-key exchange)."""
        self._bucketer = GradBucketer(int(float(mb) * (1 << 20)))

    @property
    def rank(self):
        return dist.get_rank() if dist.is_initialized() else 0

    @property
    def num_workers(self):
        return self._nproc

    # -- the collectives --------------------------------------------------
    def _host_staged(self, t):
        """gloo reduces in host memory: a CUDA tensor's host copy."""
        return self._backend == "gloo" and t.device.type == "cuda"

    def allreduce_async(self, flat):
        """Start the in-place SUM of `flat` (a tensor this store may
        overwrite) across processes; returns its `_Pending`."""
        t0 = time.perf_counter()
        _AR_BYTES.inc(flat.numel() * flat.element_size())
        _AR_CALLS.inc()
        _STEP_DISPATCHES.inc()
        what = "allreduce of %d bytes" % (flat.numel() * flat.element_size())
        if self._host_staged(flat):
            host = flat.cpu()
            work = dist.all_reduce(host, async_op=True)
            return _Pending(work, lambda: flat.copy_(host), t0,
                            self._collective_timeout_s, what)
        work = dist.all_reduce(flat, async_op=True)
        return _Pending(work, lambda: flat, t0, self._collective_timeout_s,
                        what)

    def _allgather_async(self, words, finish):
        """Start an all-gather of this rank's int32 `words`; `finish`
        takes the ranks' words, in rank order, on `words`' device."""
        t0 = time.perf_counter()
        self.last_wire_bytes = words.numel() * 4
        _AR_BYTES.inc(self.last_wire_bytes)
        _AR_CALLS.inc()
        _STEP_DISPATCHES.inc()
        src = words.cpu() if self._host_staged(words) else words
        parts = [torch.empty_like(src) for _ in range(self._nproc)]
        work = dist.all_gather(parts, src, async_op=True)
        return _Pending(work, lambda: finish(
            [p.to(words.device) for p in parts]), t0,
            self._collective_timeout_s,
            "all-gather of %d bytes" % self.last_wire_bytes)

    def _dequant_sum(self, parts, shape, dtype):
        """Every rank's words dequantized and added in rank order."""
        comp = self._compression
        out = comp.decompress(parts[0], shape, dtype)
        for p in parts[1:]:
            out = out + comp.decompress(p, shape, dtype)
        return out

    def _cross_process_sum(self, x):
        return self.allreduce_async(x.clone()).result()

    def _cross_process_sum_compressed(self, x, key):
        words = self._compression.compress(key, x)
        return self._allgather_async(
            words, lambda parts: self._dequant_sum(parts, x.shape,
                                                   x.dtype)).result()

    # -- the per-key path -------------------------------------------------
    def _after_merge(self, merged, key):
        comp = self._compression
        active = comp is not None and comp.active_for(merged)
        if self._nproc > 1:
            if active:
                return self._cross_process_sum_compressed(merged, key)
            return self._cross_process_sum(merged)
        if active:
            return comp.roundtrip(key, merged)
        return merged

    # -- the bucketed exchange --------------------------------------------
    def push_all(self, key, value, priorities=None):
        keys, values = _key_value(key, value)
        if self._nproc <= 1 or self._bucketer.target_bytes <= 0 \
                or len(set(keys)) != len(keys):
            # repeated keys merge one after another: a fused pack would
            # collapse them
            return super().push_all(keys, values, priorities=priorities)
        for k in keys:
            if k not in self._data:
                raise MXNetError("key %r not initialized" % (k,))
        t0 = time.perf_counter()
        order = _priority_order(len(keys), priorities)
        prios = list(priorities) if priorities is not None \
            else [0] * len(keys)
        batch = self._begin_update_batch(keys)
        try:
            self._push_bucketed([keys[j] for j in order],
                                [values[j] for j in order],
                                [prios[j] for j in order])
        finally:
            self._flush_update_batch(batch)
        self._count_push(values, t0)

    def _push_bucketed(self, keys, values, priorities):
        """Sum per key, pack into buckets, one collective per bucket, then
        unpack and land each key's sum. Compressed keys ride their own
        lane."""
        comp = self._compression
        merged = {k: _sum(_values(v)) for k, v in zip(keys, values)}
        items = tuple((k, tuple(merged[k].shape), merged[k].dtype, int(pr),
                       bool(comp is not None and comp.active_for(merged[k])))
                      for k, pr in zip(keys, priorities))
        issued = []
        for bucket in self._bucketer.plan(items):
            issued.append((bucket, retry_call(
                self._issue_bucket, bucket, merged,
                policy=self._push_policy())))
        guard = _num.enabled()
        for bucket, pending in issued:
            out = pending.result()
            if guard:
                _num.record_flag(finite_all(out), where="exchange")
            t0 = time.perf_counter()
            for k, sub in zip(bucket.keys, bucket.unpack(out)):
                self._apply_merged(k, sub)
            UNPACK_SECONDS.observe(time.perf_counter() - t0)

    def _issue_bucket(self, bucket, merged):
        """Pack one bucket and start its collective (the retry unit)."""
        t0 = time.perf_counter()
        flat = bucket.pack([merged[k] for k in bucket.keys])
        PACK_SECONDS.observe(time.perf_counter() - t0)
        BUCKET_COUNT.inc()
        BUCKET_KEYS.inc(len(bucket.keys))
        BUCKET_FILL.observe(bucket.nbytes /
                            max(1, self._bucketer.target_bytes))
        if bucket.lane:
            return self._bucket_sum_compressed(flat, bucket)
        return self.allreduce_async(flat)

    def _bucket_sum_compressed(self, flat, bucket):
        """Quantize the bucket with its keys' residuals, read and written
        back as slices (so they survive any change of layout), and start
        the all-gather of the words."""
        comp = self._compression
        res = bucket.pack([comp.residual(k, shp, flat.dtype, flat.device)
                           for k, shp in zip(bucket.keys, bucket.shapes)])
        from ..gradient_compression import quantize_2bit
        words, new_res = quantize_2bit(flat, res, comp.threshold)
        for k, sub in zip(bucket.keys, bucket.unpack(new_res)):
            comp.set_residual(k, sub)
        return self._allgather_async(
            words, lambda parts: self._dequant_sum(parts, flat.shape,
                                                   flat.dtype))

    def barrier(self):
        """Wait for every process (kvstore.py Barrier), at most
        ``MXTPU_BARRIER_TIMEOUT_S`` seconds (default 600), then raise
        `DeadlineExceeded`, as JAX's barrier does (its :570-588): a dead
        peer fails the barrier with a diagnosable error instead of
        hanging this process."""
        if self._nproc > 1:
            bounded_barrier(getenv("MXTPU_BARRIER_TIMEOUT_S", 600.0),
                            "kvstore barrier across %d processes"
                            % self._nproc, self.device)
