"""InferenceEngine: a model frozen into one forward-only graph function a
padding bucket (counterpart of mxnet_tpu/serving/engine.py).

A model — a Gluon HybridBlock, a bound Module, or a symbol + params pair
— is frozen once: its parameters are copied onto the engine's device
(cast to bfloat16 under ``dtype="bf16"``), and every request size is
rounded up to a **padding bucket** (powers of two up to
`max_batch_size`), so arbitrary traffic runs at a small, bounded set of
shapes: ≤ log2(max_batch_size)+1 of them, whatever batch sizes arrive.

Where the JAX engine compiles one `jax.jit` program a bucket, this one
builds one graph function a bucket through the port's
`graph.build_graph_fn` in predict mode (BatchNorm on its moving
statistics, no aux writes) and runs it under `torch.no_grad()`; each op
is a launch already. `serving.engine.compiles` counts those builds, one
per (engine, bucket, device) at its first successful dispatch, so a size
sweep after `warmup` adds zero, as in the JAX package.

A host request batch is padded on the host and moved to the device in
ONE transfer; a device batch is padded on the device. Outputs come back
as NDArrays sliced to the true row count, float32 whatever the compute
dtype.

Accounting: the engine's parameter bytes land in the memory ledger at
freeze (`device_bytes` re-measures and reconciles them), and the first
dispatch of each bucket counts its FLOPs with `FlopCounterMode`
(`observability.goodput.count_flops`), charged to ``goodput.flops`` at
every dispatch as the JAX engine's `_charge_goodput` (engine.py:729)
charges its per-program cost.

The JAX engine's AOT export/load (`compile/aot`) is not ported:
`aot_export`/`aot_load` raise `MXNetError` naming ROADMAP A9b's compile
plane.

Metrics: `serving.engine.compiles` and `serving.engine.infer.seconds`.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..base import MXNetError, dtype_from_name, getenv
from ..context import Context, resolve_device
from ..graph import Struct, build_graph_fn, collect_vars, infer_structs
from ..ndarray import NDArray
from ..observability import goodput as _goodput
from ..observability import memory as _memory
from ..observability import registry as _obs
from ..observability import trace as _trace

__all__ = ["InferenceEngine", "bucket_sizes", "resolve_serve_dtype"]

_COMPILES = _obs.counter(
    "serving.engine.compiles",
    "padding-bucket forward programs compiled by InferenceEngine")
_INFER_SECONDS = _obs.histogram(
    "serving.engine.infer.seconds",
    "wall time of one InferenceEngine dispatch (pad + compute + wrap)")

_AOT_MSG = ("ahead-of-time executables are the compile plane's "
            "(compile/aot), which the port has not ported yet "
            "(ROADMAP A9b)")


def resolve_serve_dtype(dtype):
    """Normalize a serving dtype spec ('bf16'/'fp32'/None + env
    ``MXTPU_SERVE_DTYPE``) to 'bf16' or 'fp32'. bf16 engines cast float
    params AND float activations at freeze time; outputs come back as
    float32."""
    if dtype is None:
        dtype = getenv("MXTPU_SERVE_DTYPE", "fp32")
    dtype = str(dtype).lower()
    if dtype in ("bf16", "bfloat16"):
        return "bf16"
    if dtype in ("fp32", "float32", "f32"):
        return "fp32"
    raise MXNetError("serve dtype must be 'fp32' or 'bf16', got %r"
                     % (dtype,))


def _serve_cast(dt, serve_dtype):
    """The freeze-time torch dtype for a leaf of dtype `dt` under the
    serving dtype (non-floats — int tokens, bool masks — pass
    through)."""
    dt = dtype_from_name(dt)
    if serve_dtype == "bf16" and dt in (torch.float32, torch.float64):
        return torch.bfloat16
    return dt


def bucket_sizes(max_batch_size):
    """The padding-bucket ladder: powers of two below `max_batch_size`,
    plus `max_batch_size` itself (so a full batch never pads). The
    ladder length — ≤ log2(max)+1 — bounds the engine's graph builds."""
    max_batch_size = int(max_batch_size)
    if max_batch_size < 1:
        raise MXNetError("max_batch_size must be >= 1, got %d"
                         % max_batch_size)
    sizes = []
    b = 1
    while b < max_batch_size:
        sizes.append(b)
        b *= 2
    sizes.append(max_batch_size)
    return tuple(sizes)


def _tensor_of(v):
    if isinstance(v, NDArray):
        return v._data
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(np.asarray(v))


def _np_dtype(dt):
    """A numpy dtype for a host buffer of torch dtype `dt` (bfloat16,
    which numpy lacks, is staged as float32)."""
    if dt == torch.bfloat16:
        return np.dtype(np.float32)
    return np.dtype(str(dt).replace("torch.", ""))


def _dev_key(device):
    return None if device is None else str(torch.device(device))


class InferenceEngine:
    """A frozen forward-only model with a bounded set of shapes.

    Construct via `from_symbol` / `from_module` / `from_block`, then
    call `infer({name: array_batch})` (or a bare array when the model
    has one input). Requests are padded up to the nearest bucket, run
    through the bucket's graph function, and sliced back to the true row
    count. Runs on the CUDA card unless ``device="cpu"``.
    """

    def __init__(self, symbol, arg_params, aux_params, data_descs,
                 max_batch_size, name=None, donate=None,
                 static_shapes=None, dtype=None, device=None):
        # data_descs: [(input_name, per_example_shape, dtype)] — shapes
        # WITHOUT the leading batch dimension (it varies per bucket).
        # static_shapes: {name: FULL fixed shape} — inputs fed verbatim
        # with no padding/slicing. donate is accepted for the JAX
        # package's signature: every dispatch here stages a fresh
        # request buffer anyway.
        self._symbol = symbol
        self.device = resolve_device(device)
        self.name = name or (symbol.name or "model")
        self.dtype = resolve_serve_dtype(dtype)
        self.max_batch_size = int(max_batch_size)
        self._buckets = bucket_sizes(self.max_batch_size)
        self._descs = []
        for n, s, dt in data_descs:
            host = dtype_from_name(dt)
            self._descs.append((str(n), tuple(int(d) for d in s),
                                _serve_cast(host, self.dtype),
                                _np_dtype(host)))
        self._static = {str(n): tuple(s)
                        for n, s in (static_shapes or {}).items()}
        self._data_names = [d[0] for d in self._descs] + \
            sorted(self._static)
        if not self._data_names:
            raise MXNetError("InferenceEngine needs at least one data "
                             "input")

        arg_nodes, aux_nodes = collect_vars(symbol._entries)
        arg_names = [n.name for n in arg_nodes]
        aux_names = [n.name for n in aux_nodes]
        data_set = set(self._data_names)
        unknown = data_set - set(arg_names)
        if unknown:
            raise MXNetError(
                "InferenceEngine: input(s) %s are not arguments of the "
                "graph (arguments: %s)" % (sorted(unknown), arg_names))
        arg_params = arg_params or {}
        self._param_names = [n for n in arg_names
                             if n not in data_set and n in arg_params]
        # arguments that are neither fed data nor loaded params — label
        # heads like softmax_label that predict mode never reads: zeros
        # of their inferred shapes, one set per bucket
        self._phantom_names = [n for n in arg_names
                               if n not in data_set
                               and n not in arg_params]
        self._phantoms = {}          # (bucket, device) -> {name: zeros}

        def take(src, names, kind):
            out = {}
            for n in names:
                if n not in src:
                    raise MXNetError(
                        "InferenceEngine: missing %s %r" % (kind, n))
                out[n] = self._stage_param(src[n])
            return out

        self._params = take(arg_params, self._param_names, "parameter")
        self._aux = take(aux_params or {}, aux_names, "aux state")
        self._static_descs = {}
        for n, shape in self._static.items():
            host = (_tensor_of(arg_params[n]).dtype if n in arg_params
                    else torch.float32)
            self._static_descs[n] = (shape, _serve_cast(host, self.dtype),
                                     _np_dtype(host))

        self._needs_rng = build_graph_fn(symbol._entries,
                                         mode="predict")[3]
        self._fns = {}              # bucket -> graph function
        self._lock = threading.Lock()
        self._compiled = set()      # (bucket, device-key) dispatched OK
        self._placed = {}           # device-key -> (params, aux) copies
        # memory ledger: a freeze is an allocation event — params/aux
        # land attributed before the first request arrives
        _memory.set_bytes(self.name, "engine", "params",
                          _memory.nbytes(self._params))
        _memory.set_bytes(self.name, "engine", "aux",
                          _memory.nbytes(self._aux))

    def _stage_param(self, v):
        """A frozen copy of one parameter on the engine's device in the
        serving dtype (strides kept: the graph sees the same layout the
        model's own forward does)."""
        t = _tensor_of(v).detach()
        return t.to(device=self.device,
                    dtype=_serve_cast(t.dtype, self.dtype), copy=True)

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------
    @classmethod
    def from_symbol(cls, symbol, arg_params, aux_params, input_shapes,
                    max_batch_size, input_dtypes=None, name=None,
                    donate=None, static_shapes=None, dtype=None,
                    device=None):
        """Freeze a symbol + params.

        `input_shapes`: {name: per-example shape} (no batch dim).
        `static_shapes`: {name: full fixed shape} fed verbatim with no
        padding (independent leading dims, scalars allowed).
        `input_dtypes`: optional {name: dtype}; defaults to the loaded
        parameter's dtype when a parameter shares the name, else
        float32."""
        input_dtypes = input_dtypes or {}
        descs = []
        for n, shape in input_shapes.items():
            dt = input_dtypes.get(n)
            if dt is None and arg_params and n in arg_params:
                dt = _tensor_of(arg_params[n]).dtype
            descs.append((n, tuple(shape), dt or np.float32))
        return cls(symbol, arg_params, aux_params, descs,
                   max_batch_size, name=name, donate=donate,
                   static_shapes=static_shapes, dtype=dtype, device=device)

    @classmethod
    def from_module(cls, module, max_batch_size=None, name=None,
                    donate=None, dtype=None, device=None):
        """Freeze a bound Module (its symbol, current params, and bound
        data shapes; `max_batch_size` defaults to the bound batch, the
        device to the module's context)."""
        if not (module.binded and module.params_initialized):
            raise MXNetError("from_module: module must be bound and "
                             "initialized")
        arg_params, aux_params = module.get_params()
        descs = []
        batch = None
        for d in module.data_shapes:
            if not d.shape:
                raise MXNetError("from_module: scalar data input %r "
                                 "has no batch dimension" % d.name)
            batch = d.shape[0] if batch is None else batch
            if d.shape[0] != batch:
                raise MXNetError(
                    "from_module: data inputs disagree on the batch "
                    "dimension (%s)" % [tuple(x.shape)
                                        for x in module.data_shapes])
            descs.append((d.name, tuple(d.shape[1:]),
                          getattr(d, "dtype", None) or np.float32))
        if device is None:
            device = module._context[0]
        return cls(module._symbol, arg_params, aux_params, descs,
                   max_batch_size or batch,
                   name=name or "module", donate=donate, dtype=dtype,
                   device=device)

    @classmethod
    def from_block(cls, block, *example_inputs, max_batch_size=None,
                   name=None, donate=None, dtype=None, device=None):
        """Freeze a Gluon HybridBlock through its traced graph.

        `example_inputs`: NDArrays or tensors with the serving
        per-example shapes (their leading dim seeds `max_batch_size` when
        not given). The device defaults to the parameters'."""
        from ..gluon.block import HybridBlock
        from ..gluon.parameter import DeferredInitializationError
        if not isinstance(block, HybridBlock):
            raise MXNetError(
                "from_block wants a HybridBlock (traceable to one "
                "graph); got %s" % type(block).__name__)
        example = [_tensor_of(x) for x in example_inputs]
        # the hybridize trace: the same graph the block replays, so
        # engine outputs match block(x)
        if block._cached_op is not None:
            tracers, graph = (block._cached_graph[0],
                              block._cached_op.symbol)
        else:
            tracers, graph = block._get_graph(*example)
        plist = list(block.collect_params().values())
        try:
            params = {p.name: p._graph_value() for p in plist}
        except DeferredInitializationError:
            block._deferred_infer_shape(*example)
            for p in plist:
                p._finish_deferred_init()
            params = {p.name: p._graph_value() for p in plist}
        aux_names = set(graph.list_auxiliary_states())
        arg_params = {k: v for k, v in params.items()
                      if k not in aux_names}
        aux_params = {k: v for k, v in params.items() if k in aux_names}
        descs = []
        batch = None
        for t, x in zip(tracers, example):
            if not x.shape:
                raise MXNetError("from_block: example input for %r has "
                                 "no batch dimension" % t.name)
            batch = x.shape[0] if batch is None else batch
            descs.append((t.name, tuple(x.shape[1:]), x.dtype))
        if device is None:
            device = (next(iter(params.values())).device if params
                      else None)
        return cls(graph, arg_params, aux_params, descs,
                   max_batch_size or batch,
                   name=name or block.name or "block", donate=donate,
                   dtype=dtype, device=device)

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------
    @property
    def data_names(self):
        return list(self._data_names)

    @property
    def buckets(self):
        return self._buckets

    @property
    def compiled_buckets(self):
        with self._lock:
            return sorted({b for b, _ in self._compiled})

    @property
    def aot_buckets(self):
        return []

    def device_bytes(self):
        """Measured device bytes this engine keeps resident: params +
        aux plus every per-replica placed copy — the number a
        model-multiplexing registry accounts against its budget.
        Request and activation buffers are step-local and not counted.
        Every measurement reconciles the memory ledger's
        (model, engine, *) cells."""
        params_b = _memory.nbytes(self._params)
        aux_b = _memory.nbytes(self._aux)
        with self._lock:
            placed = list(self._placed.values())
        replica_b = _memory.nbytes(placed)
        _memory.set_bytes(self.name, "engine", "params", params_b)
        _memory.set_bytes(self.name, "engine", "aux", aux_b)
        _memory.set_bytes(self.name, "engine", "replicas", replica_b)
        return params_b + aux_b + replica_b

    def bucket_for(self, n):
        """Smallest padding bucket that holds `n` rows."""
        n = int(n)
        if n < 1:
            raise MXNetError("batch size must be >= 1, got %d" % n)
        if n > self.max_batch_size:
            raise MXNetError(
                "batch of %d rows exceeds max_batch_size=%d (split it "
                "or rebuild the engine)" % (n, self.max_batch_size))
        for b in self._buckets:
            if b >= n:
                return b
        raise AssertionError("unreachable")

    def set_params(self, arg_params, aux_params=None):
        """Swap in new parameter values (same names/shapes, so no new
        graph builds), through the same serve-dtype cast as freeze
        time."""
        for n in self._param_names:
            if arg_params and n in arg_params:
                self._params[n] = self._stage_param(arg_params[n])
        for n in list(self._aux):
            if aux_params and n in aux_params:
                self._aux[n] = self._stage_param(aux_params[n])
        with self._lock:
            self._placed = {}     # per-device copies are now stale
        _memory.set_bytes(self.name, "engine", "params",
                          _memory.nbytes(self._params))
        _memory.set_bytes(self.name, "engine", "aux",
                          _memory.nbytes(self._aux))
        _memory.release(self.name, "engine", "replicas")

    # ------------------------------------------------------------------
    # ahead-of-time executables: the compile plane is not ported
    # ------------------------------------------------------------------
    def aot_export(self, store, buckets=None, verify=True):
        raise MXNetError("InferenceEngine.aot_export: " + _AOT_MSG)

    def aot_load(self, store, buckets=None):
        raise MXNetError("InferenceEngine.aot_load: " + _AOT_MSG)

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------
    def _device_of(self, device):
        if device is None:
            return self.device
        if isinstance(device, Context):
            return resolve_device(device)
        return torch.device(device)

    def _phantoms_for(self, bucket, device):
        """Zero buffers for unfed, unloaded graph arguments (label
        heads), shaped by inference at this bucket's batch size and
        cached per (bucket, device)."""
        if not self._phantom_names:
            return {}
        cache_key = (bucket, _dev_key(device))
        cached = self._phantoms.get(cache_key)
        if cached is not None:
            return cached
        known = {name: Struct((bucket,) + shape, dt)
                 for name, shape, dt, _ in self._descs}
        known.update((n, Struct(shape, dt))
                     for n, (shape, dt, _) in self._static_descs.items())
        known.update((n, Struct(tuple(v.shape), v.dtype))
                     for n, v in self._params.items())
        known.update((n, Struct(tuple(v.shape), v.dtype))
                     for n, v in self._aux.items())
        structs, _ = infer_structs(self._symbol._entries, known,
                                   mode="predict")
        out = {}
        for n in self._phantom_names:
            s = structs.get(n)
            if s is None:
                raise MXNetError(
                    "InferenceEngine: could not infer a shape for "
                    "unfed argument %r — declare it as an input or "
                    "load a parameter for it" % n)
            out[n] = torch.zeros(s.shape, dtype=s.dtype, device=device)
        with self._lock:
            self._phantoms[cache_key] = out
        return out

    def _weights_on(self, device):
        """Params/aux placed on `device` (copied once, cached) — the
        replica set a ModelServer worker on another device dispatches
        against. Built and stored under the lock, so a concurrent
        set_params() cannot be cached over."""
        if device == self.device:
            return self._params, self._aux
        key = _dev_key(device)
        fresh = None
        with self._lock:
            placed = self._placed.get(key)
            if placed is None:
                placed = ({n: v.to(device) for n, v in self._params.items()},
                          {n: v.to(device) for n, v in self._aux.items()})
                self._placed[key] = placed
                fresh = _memory.nbytes(list(self._placed.values()))
        if fresh is not None:
            _memory.set_bytes(self.name, "engine", "replicas", fresh)
        return placed

    def _stage_static(self, x, name, shape, dt, host_dt, device):
        """A fixed-shape input fed verbatim (no padding)."""
        got = tuple(x.shape) if hasattr(x, "shape") else None
        if got != shape:
            raise MXNetError("input %r: expected shape %s, got %s"
                             % (name, shape, got))
        if isinstance(x, (NDArray, torch.Tensor)):
            return _tensor_of(x).to(device=device, dtype=dt)
        return torch.from_numpy(np.asarray(x, dtype=host_dt)).to(
            device=device, dtype=dt)

    def _pad(self, x, desc, bucket, device):
        """A (bucket, *example) tensor on `device` holding input `x`'s n
        rows, zero-padded: a device input pads on the device, a host one
        pads on the host and moves in ONE transfer."""
        name, shape, dt, host_dt = desc
        want = tuple(x.shape[1:]) if hasattr(x, "shape") else None
        if want != shape:
            raise MXNetError(
                "input %r: expected per-example shape %s, got %s"
                % (name, shape, want))
        n = x.shape[0]
        if isinstance(x, (NDArray, torch.Tensor)):
            t = _tensor_of(x).to(device=device, dtype=dt)
            if n < bucket:
                t = torch.cat([t, t.new_zeros((bucket - n,) + shape)])
            return t
        x = np.asarray(x, dtype=host_dt)
        if n < bucket:
            padded = np.zeros((bucket,) + shape, host_dt)
            padded[:n] = x
            x = padded
        t = torch.from_numpy(np.ascontiguousarray(x))
        return t.to(device=device, dtype=dt, non_blocking=False)

    def _fn_for(self, bucket):
        fn = self._fns.get(bucket)
        if fn is None:
            fn = build_graph_fn(self._symbol._entries, mode="predict")[0]
            with self._lock:
                fn = self._fns.setdefault(bucket, fn)
        return fn

    def infer(self, inputs, n=None, device=None):
        """Run one coalesced request batch.

        `inputs`: {name: array of shape (n, *example)} (numpy, NDArray or
        tensor) or a bare array for single-input models (static inputs
        take their exact fixed shape). `device` places the batch AND a
        cached parameter copy on that device (worker-replica dispatch).
        Returns the model outputs as NDArrays sliced back to `n` rows
        (padding rows are computed at the bucket's shape and
        discarded)."""
        t0 = time.perf_counter()
        if not isinstance(inputs, dict):
            if len(self._data_names) != 1:
                raise MXNetError(
                    "model has inputs %s; pass a dict" % self._data_names)
            inputs = {self._data_names[0]: inputs}
        missing = [n_ for n_ in self._data_names if n_ not in inputs]
        if missing:
            raise MXNetError("infer: missing input(s) %s" % missing)
        rows = None
        for name_, _, _, _ in self._descs:
            x = inputs[name_]
            ln = (x.shape[0] if hasattr(x, "shape") and len(x.shape)
                  else None)
            if ln is None:
                raise MXNetError("input %r has no batch dimension"
                                 % name_)
            rows = ln if rows is None else rows
            if ln != rows:
                raise MXNetError(
                    "inputs disagree on the batch dimension (%d vs %d)"
                    % (ln, rows))
        if rows is None:          # static-only model
            rows = self.max_batch_size
        if n is None:
            n = rows
        bucket = self.bucket_for(rows)
        dev = self._device_of(device)

        data = {d[0]: self._pad(inputs[d[0]], d, bucket, dev)
                for d in self._descs}
        for nm, (shape, dt, host_dt) in self._static_descs.items():
            data[nm] = self._stage_static(inputs[nm], nm, shape, dt,
                                          host_dt, dev)
        compile_key = (bucket, _dev_key(dev))
        with self._lock:
            compiling = compile_key not in self._compiled
        params, aux = self._weights_on(dev)
        phantoms = self._phantoms_for(bucket, dev)
        fn = self._fn_for(bucket)
        args = {**data, **params, **phantoms}
        flops = None
        # the OOM guard turns a CUDA out-of-memory here into a typed
        # HBMExhausted with the ranked ledger dumped first
        with _memory.oom_guard("engine.infer", self.name), \
                _trace.device_annotation(), torch.no_grad():
            if compiling and _goodput.enabled() and \
                    _goodput.cost(self._program(bucket)) is None:
                (outs, _), flops = _goodput.count_flops(fn, args, aux)
            else:
                outs, _ = fn(args, aux)
            outs = [o.float() if o.dtype == torch.bfloat16 else o
                    for o in outs]
        if compiling:
            # account AFTER the dispatch succeeded: a failed first
            # dispatch must not mark the bucket warm (warmup() would
            # skip it) or count a build that never ran
            with self._lock:
                if compile_key not in self._compiled:
                    self._compiled.add(compile_key)
                    _COMPILES.inc(engine=self.name, bucket=str(bucket))
        keep = None if n == bucket else n
        result = [NDArray(o[:keep] if keep is not None else o)
                  for o in outs]
        self._charge_goodput(bucket, flops)
        _INFER_SECONDS.observe(time.perf_counter() - t0,
                               engine=self.name)
        return result

    def _program(self, bucket):
        return "engine/%s/b%d" % (self.name, bucket)

    def _charge_goodput(self, bucket, flops=None):
        """Charge this dispatch's model FLOPs to the goodput counter: the
        FLOPs the bucket's first dispatch counted, else (a counter that
        could not run) the dense-forward analytic estimate — 2 FLOPs a
        parameter element a padded row, the JAX engine's fallback."""
        if not _goodput.enabled():
            return
        name = self._program(bucket)
        if flops:
            _goodput.record_cost(name, flops=flops, measured=True)
        elif _goodput.cost(name) is None:
            n_elems = sum(int(v.numel()) for v in self._params.values())
            _goodput.record_cost(name, flops=2.0 * n_elems * int(bucket))
        _goodput.note_dispatch(name)

    def zero_inputs(self, n=1):
        """A zero-filled host request batch of `n` rows (static inputs at
        their fixed shapes) — the warmup payload, and the canary-probe
        dispatch of the serving replica health machinery."""
        out = {name: np.zeros((n,) + shape, host_dt)
               for name, shape, _, host_dt in self._descs}
        out.update((name, np.zeros(shape, host_dt))
                   for name, (shape, _, host_dt)
                   in self._static_descs.items())
        return out

    def warmup(self, buckets=None, device=None):
        """Run every padding bucket (all of them by default) once on a
        zero batch, so the first real request pays no graph build,
        library handle or allocator growth; `device` warms that
        replica. Returns the list of bucket sizes warmed."""
        warmed = []
        devkey = _dev_key(self._device_of(device))
        if buckets is None:
            # a static-only model has ONE shape (no padded batch axis)
            buckets = self._buckets if self._descs \
                else (self.max_batch_size,)
        for b in buckets:
            b = self.bucket_for(b)
            with self._lock:
                seen = (b, devkey) in self._compiled
            if seen:
                continue
            self.infer(self.zero_inputs(b), n=b, device=device)
            warmed.append(b)
        return warmed
