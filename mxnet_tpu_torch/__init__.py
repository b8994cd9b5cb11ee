"""mxnet_tpu_torch — the PyTorch/CUDA port of mxnet_tpu for an NVIDIA H100.

A package beside the JAX one, with the same module paths so each part
has a findable counterpart. It imports `torch` and never `jax`, nor
anything of `mxnet_tpu`. Its entry points run on the CUDA card unless
the caller passes ``device="cpu"``; without a card and without that,
they raise.

Ported so far: slice 1, GPT continuous-batching decode
(`gluon.model_zoo.GPTDecoder`, `serving.DecodeEngine`,
`serving.ContinuousBatchScheduler`, with the hand-written Hopper kernels
`ops.flash_attention` and `ops.layer_norm`); slice 2, ResNet V1 training
(`gluon.model_zoo.vision.resnet50_v1` and its family, `gluon.nn`,
`gluon.loss`, `parallel.ShardedTrainer`, with the kernels
`ops.conv1x1_bn_stats` and `ops.fused_sgd_momentum`); slice 3 in part,
the Gluon imperative training loop (`autograd`, `gluon.Parameter`,
`initializer`, `lr_scheduler`, `optimizer`, `kvstore`, `gluon.Trainer`),
whose SGD update is `ops.fused_sgd_momentum` in MXNet's form; and
the eager array layer (`nd`: `NDArray`, the operator registry and its
core ops, `Context`, `nd.save`/`nd.load`), with `LayerNorm`,
`_contrib_flash_attention` and the SGD update ops on the kernels;
Gluon's breadth (every `gluon.nn` layer and loss, `gluon.data`, the
model zoo); and the symbolic layer: `sym` (Symbol, `graph`), the
`executor`, `cached_op` (a real `hybridize`, `export`, `SymbolBlock`)
and the Module API (`mod`, `io.NDArrayIter`, `metric`, `callback`,
`model`), whose SGD update is `fused_sgd_momentum` and whose 1x1
NHWC convolutions before a training BatchNorm run `conv1x1_bn_stats`;
and distributed training over torch.distributed: the 'dist_*' kvstore
types (`parallel.kvstore_dist`), fusion buckets (`parallel.bucketing`),
2-bit compression (`gradient_compression`) and the fused exchange +
update step behind `gluon.Trainer` and `Module` (`parallel.fused_step`);
and the record-file input pipeline: `recordio`, the native record loader
(`_native`, built at first use under a file lock), `image` (alias `img`)
with its augmenters and `ImageIter`, `io.ImageRecordIter` and the other
file iterators, `image.ImageDetIter`, the record datasets and Module
`fit`'s prefetching loop; and the rest of serving: the bucketed
`serving.InferenceEngine` (also Module's predict path),
`serving.DynamicBatcher`, `serving.ModelServer` of both kinds with its
health plane, `serving.ModelRegistry` and the HTTP `serving.Gateway`,
over the observability and resilience planes they need (spans and
traces, the memory ledger, goodput, ``/metricsz``, the watchdog and the
device lease); and the training planes: per-step telemetry records
(`observability.telemetry.StepTimer`), the numerics guard with loss
scaling, divergence rollback and SDC replay, `corrupt_point`,
preemption at a step boundary, the gang supervisor
(`resilience.GangSupervisor`, `tools/torch_launch.py`), `profiler` and
`monitor`.
"""
from .base import MXNetError, __version__, getenv
from .context import (Context, DeviceUnreachable, cpu, current_context,
                      gpu, num_gpus, resolve_device)
from . import (autograd, convert, gluon, initializer, kvstore, lr_scheduler,
               ndarray, observability, ops, optimizer, parallel, random,
               resilience, serving)
from . import (attribute, callback, cached_op, executor, graph, io, metric,
               model, module, monitor, name, profiler, symbol)
from . import image, recordio
from . import image as img
from .attribute import AttrScope
from .cached_op import CachedOp

init = initializer
kv = kvstore
nd = ndarray
sym = symbol
mod = module

__all__ = ["AttrScope", "CachedOp", "Context", "MXNetError",
           "DeviceUnreachable", "__version__", "attribute", "autograd",
           "cached_op", "callback", "convert", "cpu", "current_context", "executor", "getenv",
           "gluon", "gpu", "graph", "image", "img", "init", "initializer", "io",
           "kv",
           "kvstore", "lr_scheduler", "metric", "mod", "model", "module",
           "monitor", "name", "nd", "ndarray", "num_gpus", "observability",
           "ops", "optimizer", "parallel", "profiler", "random", "recordio",
           "resilience",
           "resolve_device", "serving", "sym", "symbol"]
