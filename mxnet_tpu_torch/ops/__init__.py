"""Hand-written Hopper kernels (counterparts of the Pallas kernels in
mxnet_tpu/ops/pallas_kernels.py), each beside its plain PyTorch version,
and the operator registry (`registry`) with its ops, which importing this
package registers: `math`, `tensor`, `nn`, `random_ops`, `init_ops`,
`extra` and `_contrib_flash_attention`.

Each wrapper counts its kernel launches in ``<wrapper>.launches``;
`launch_counts` reads them and `reset_launch_counts` zeroes them, so a
run can show that its main path went through the kernels.
"""
from . import registry
from . import math        # noqa: F401
from . import tensor      # noqa: F401
from . import nn
from . import random_ops  # noqa: F401
from . import init_ops    # noqa: F401
from . import extra       # noqa: F401
from .conv1x1_bn import (Conv1x1BNStats, conv1x1_bn_nhwc, conv1x1_bn_stats,
                         conv1x1_bn_stats_plain)
from .flash_attention import attention_plain, flash_attention
from .layer_norm import layer_norm, layer_norm_plain
from .sgd_momentum import (SGDMomentumPlan, fused_sgd_momentum,
                           sgd_momentum_plain, sgd_mxnet_plain)

__all__ = ["Conv1x1BNStats", "SGDMomentumPlan", "attention_plain",
           "conv1x1_bn_nhwc", "conv1x1_bn_stats", "conv1x1_bn_stats_plain",
           "flash_attention", "fused_sgd_momentum", "layer_norm",
           "layer_norm_plain", "launch_counts", "nn", "registry",
           "reset_launch_counts",
           "sgd_momentum_plain", "sgd_mxnet_plain"]

KERNELS = (flash_attention, layer_norm, fused_sgd_momentum,
           conv1x1_bn_stats)


def launch_counts():
    """{kernel name: launches since the last reset}."""
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0
