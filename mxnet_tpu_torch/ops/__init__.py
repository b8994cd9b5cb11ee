"""Hand-written Hopper kernels (counterparts of the Pallas kernels in
mxnet_tpu/ops/pallas_kernels.py), each beside its plain PyTorch version,
and the plain operators around them (`nn`).

Each wrapper counts its kernel launches in ``<wrapper>.launches``;
`launch_counts` reads them and `reset_launch_counts` zeroes them, so a
run can show that its main path went through the kernels.
"""
from . import nn
from .conv1x1_bn import (Conv1x1BNStats, conv1x1_bn_nhwc, conv1x1_bn_stats,
                         conv1x1_bn_stats_plain)
from .flash_attention import attention_plain, flash_attention
from .layer_norm import layer_norm, layer_norm_plain
from .sgd_momentum import fused_sgd_momentum, sgd_momentum_plain

__all__ = ["Conv1x1BNStats", "attention_plain", "conv1x1_bn_nhwc",
           "conv1x1_bn_stats", "conv1x1_bn_stats_plain", "flash_attention",
           "fused_sgd_momentum", "layer_norm", "layer_norm_plain",
           "launch_counts", "nn", "reset_launch_counts",
           "sgd_momentum_plain"]

KERNELS = (flash_attention, layer_norm, fused_sgd_momentum,
           conv1x1_bn_stats)


def launch_counts():
    """{kernel name: launches since the last reset}."""
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0
