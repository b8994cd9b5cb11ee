"""Hand-written Hopper kernels (counterparts of the Pallas kernels in
mxnet_tpu/ops/pallas_kernels.py), each beside its plain PyTorch version.

Each wrapper counts its kernel launches in ``<wrapper>.launches``;
`launch_counts` reads them and `reset_launch_counts` zeroes them, so a
run can show that its main path went through the kernels.
"""
from .flash_attention import attention_plain, flash_attention
from .layer_norm import layer_norm, layer_norm_plain

__all__ = ["attention_plain", "flash_attention", "layer_norm",
           "layer_norm_plain", "launch_counts", "reset_launch_counts"]

KERNELS = (flash_attention, layer_norm)


def launch_counts():
    """{kernel name: launches since the last reset}."""
    return {k.__name__: k.launches for k in KERNELS}


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0
