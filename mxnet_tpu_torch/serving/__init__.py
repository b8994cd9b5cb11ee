"""Serving: frozen inference with dynamic micro-batching and load
shedding (counterpart of mxnet_tpu/serving/, docs/serving.md).

- `engine`:    `InferenceEngine` — a Gluon HybridBlock, bound Module, or
               symbol+params frozen into one forward-only graph function
               a padding bucket (powers of two up to `max_batch_size`),
               with `warmup()` and a `dtype="bf16"` serving mode
               (``MXTPU_SERVE_DTYPE``).
- `batcher`:   `DynamicBatcher` — thread-safe bounded queue coalescing
               requests up to `max_batch_size` rows or `max_wait_ms`,
               deadline-aware, with an explicit load-shedding policy
               (`reject` / `drop_oldest`).
- `decode`:    `DecodeEngine` — an autoregressive block driven through a
               padded-bucket prefill plus ONE single-token step over a
               statically-shaped slot KV cache; its prefill attention
               and every LayerNorm run the hand-written kernels on the
               card.
- `scheduler`: `ContinuousBatchScheduler` — sequences join free cache
               slots and retire *between* decode steps, deadlines evict
               at step boundaries, the step shape never changes.
- `server`:    `ModelServer` — either kind behind worker replicas with
               least-loaded dispatch, graceful SIGTERM drain (finish
               in-flight, reject new) and a `stats()` snapshot.
- `gateway`:   `ModelRegistry` (N models under a measured device-byte
               budget, LRU eviction, single-flight reload) + `Gateway`
               (threaded stdlib HTTP server with priority-class,
               deadline-aware admission).
- `health`:    the resilience plane: watchdog-bounded dispatch
               (``MXTPU_SERVE_DISPATCH_TIMEOUT_S``), the replica state
               machine (healthy → quarantined → canary-re-admitted;
               dead workers stop receiving traffic), the per-model
               circuit breaker (`BreakerOpen`) and typed failures.

Chaos sites: `serving.infer`, `serving.decode`, `gateway.admit`,
`engine.dispatch` (+ `serving.replica<k>.dispatch`). Metrics:
`serving.*` in the observability registry; per-batch/per-step JSONL
records ride the ``MXTPU_TELEMETRY`` stream. The JAX package's AOT
artifacts (the compile plane, ROADMAP A9b) are not ported.
"""
from .engine import InferenceEngine, bucket_sizes, resolve_serve_dtype
from .batcher import (DynamicBatcher, InferenceRequest, RequestRejected,
                      ServerClosed)
from .decode import DecodeEngine
from .health import (BreakerOpen, DeviceUnreachable, NoHealthyReplica,
                     SchedulerCrashed)
from .scheduler import ContinuousBatchScheduler, DecodeRequest
from .server import ModelServer
from .gateway import Gateway, ModelRegistry, PRIORITY_CLASSES

__all__ = ["InferenceEngine", "bucket_sizes", "resolve_serve_dtype",
           "DynamicBatcher", "InferenceRequest", "RequestRejected",
           "ServerClosed", "DecodeEngine", "ContinuousBatchScheduler",
           "DecodeRequest", "ModelServer", "Gateway", "ModelRegistry",
           "PRIORITY_CLASSES", "BreakerOpen", "DeviceUnreachable",
           "NoHealthyReplica", "SchedulerCrashed"]
