"""Serving (counterpart of mxnet_tpu/serving/): KV-cached continuous-
batching decode.

- `decode`:    `DecodeEngine` — an autoregressive block driven through a
               padded-bucket prefill plus ONE single-token step over a
               statically-shaped slot KV cache, updated in place.
- `scheduler`: `ContinuousBatchScheduler` — sequences join free cache
               slots and retire *between* decode steps, deadlines evict
               at step boundaries, the step shape never changes.

`InferenceEngine`, `ModelServer` and the gateway are not ported yet.
"""
from .batcher import RequestRejected, ServerClosed
from .decode import DecodeEngine
from .engine import bucket_sizes, resolve_serve_dtype
from .health import DeviceUnreachable, SchedulerCrashed
from .scheduler import ContinuousBatchScheduler, DecodeRequest

__all__ = ["ContinuousBatchScheduler", "DecodeEngine", "DecodeRequest",
           "DeviceUnreachable", "RequestRejected", "SchedulerCrashed",
           "ServerClosed", "bucket_sizes", "resolve_serve_dtype"]
