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
`ops.conv1x1_bn_stats` and `ops.fused_sgd_momentum`).
"""
from .base import MXNetError, __version__, getenv
from .context import DeviceUnreachable, resolve_device
from . import (convert, gluon, observability, ops, parallel, resilience,
               serving)

__all__ = ["MXNetError", "DeviceUnreachable", "__version__", "convert",
           "getenv", "gluon", "observability", "ops", "parallel",
           "resilience", "resolve_device", "serving"]
